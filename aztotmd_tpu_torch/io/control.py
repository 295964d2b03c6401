"""control.txt parser — simulation parameters.

Reproduces the reference reader semantics (reference: src/sys_init.cpp:590-989
``read_sim``; src/temperature.cpp:91-260 ``read_tstat``; src/elec.cpp:14-79
``read_elec``; src/rdf.cpp:14-38 ``read_rdf``) so that any deck accepted by
the reference parses to the same values here.  All quantities are converted
to internal units (A / ps / eV / e) at parse time, exactly like the reference
readers do with the ``*_scale`` factors.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from .. import units
from .cscan import CScan

# thermostat types (reference: src/temperature.h tpTermNone..tpTermRadi)
TSTAT_NONE = 0
TSTAT_NOSE = 1
TSTAT_RADI = 2

# electrostatics types (reference: src/elec.h tpElecNone..tpElecFennel)
ELEC_NONE = 0
ELEC_DIRECT = 1
ELEC_EWALD = 2
ELEC_FENNEL = 3

# initial-velocity modes (reference: src/dataStruct.h tpInitVel*)
INITVEL_ZERO = 0
INITVEL_GAUSS = 1
INITVEL_CONST = 2
INITVEL_ENG = 3

# electron-jump acceptance schemes (reference: src/ejump.h tpJump*)
JUMP_NONE = 0
JUMP_EQ = 1
JUMP_MIN = 2
JUMP_METR = 3

_INITVEL = {"zero": INITVEL_ZERO, "gaus": INITVEL_GAUSS,
            "const": INITVEL_CONST, "keng": INITVEL_ENG}


@dataclass
class TStatSpec:
    """Thermostat parameters (reference: src/temperature.h:15-38 ``TStat``)."""
    type: int = TSTAT_NONE
    temp: float = 0.0
    tau: float = 0.0            # Nose-Hoover relaxation time, ps
    step: int = 0               # radiative: photon-exchange period directive


@dataclass
class ElecSpec:
    """Electrostatics parameters (reference: src/dataStruct.h:349-366)."""
    type: int = ELEC_NONE
    r_real: float = 0.0         # real-space cutoff
    alpha: float = 0.0          # Ewald/Fennel damping
    kx: int = 0
    ky: int = 0
    kz: int = 0
    eps: float = 1.0            # permittivity

    @property
    def r2_real(self) -> float:
        return self.r_real * self.r_real


@dataclass
class ControlSpec:
    """Parsed control.txt (reference: src/dataStruct.h:40-203 ``Sim``)."""
    t_step: float = 0.0         # timestep, ps
    n_step: int = 0
    n_equil: int = 0
    freq_equil: int = 0         # t-scale period during equilibration

    tstat: TStatSpec = dfield(default_factory=TStatSpec)
    elec: ElecSpec = dfield(default_factory=ElecSpec)

    init_vel: int = INITVEL_ZERO
    init_vel_vec: tuple = (0.0, 0.0, 0.0)   # for 'const'
    init_vel_ekin: float = 0.0              # for 'keng'

    ejump: int = 0              # jump frequency directive (0 off, <0 rare, >0 often)
    ejtype: int = JUMP_NONE
    r_elec: float = 0.0         # jump radius
    d_ejump: float = 0.0        # admissible |dE| for 'eq' scheme

    ux: float = 0.0             # external electric field gradient dU/dx
    uy: float = 0.0
    uz: float = 0.0

    shift_x: float = 0.0
    shift_val: float = 0.0
    reset_vels: int = 0

    use_clist: bool = False
    cell_size: float = 0.0      # desired cell edge

    # RDF (reference: src/rdf.cpp:14-38)
    r_rdf: float = 0.0
    d_rdf: float = 0.0
    fr_rdf: int = 0             # sampling period, steps
    fr_rdf_out: int = 0         # output period
    nuclei_rdf: bool = False

    hist: int = 0
    stat: int = 1000            # statistics sampling period
    vaf: int = 0
    revcon: int = 0

    # CN output
    out_cn: bool = False
    r2_cn: float = 0.0
    cn_central: tuple = ()      # species names
    cn_counter: tuple = ()
    # nucleus CN output: ((nucl1, nucl2, radius), ...) — the reference
    # re-reads control.txt inside out_ncn (out_md.cpp:216-247)
    ncn_pairs: tuple = ()

    # trajectory output
    st_traj: int = 0
    fr_traj: int = 0
    at1_traj: int = 0
    at2_traj: int = 0

    # bind-trajectory output
    bindtraj_nucl: str = ""
    bindtraj_start: int = 0
    bindtraj_freq: int = 0

    max_neigh: int = 50

    @property
    def r2_elec(self) -> float:
        return self.r_elec * self.r_elec


def parse_control(text: str, charged_spec: bool = True) -> ControlSpec:
    """Parse a complete control.txt.

    ``charged_spec`` mirrors ``fld->charged_spec`` in read_elec
    (elec.cpp:25-56): electrostatics is switched off when no species carries
    a charge.
    """
    sc = CScan(text)
    c = ControlSpec()

    ts = sc.find_double(" timestep %lf ")
    if ts is None:
        raise ValueError("timestep must be declared in control.txt")
    c.t_step = ts

    tsim = sc.find_double(" timesim %lf ")
    if tsim is not None:
        c.n_step = int(tsim / c.t_step)
    else:
        n = sc.find_int(" nstep %d")
        if n is None:
            raise ValueError("no 'nstep' or 'timesim' directive in control.txt")
        c.n_step = n

    teq = sc.find_double(" timeequil %lf ")
    if teq is not None:
        c.n_equil = int(teq / c.t_step)
    else:
        c.n_equil = sc.find_number(" nequil %d ")
    if c.n_equil:
        c.freq_equil = sc.find_number(" eqfreq %d ")

    # --- thermostat (temperature.cpp:91-260) ---
    t = sc.find_double(" temperature %lf ")
    if t is None:
        raise ValueError("temperature is not defined in control.txt")
    c.tstat.temp = t
    kind = sc.scanf("%s")[0]
    if kind == "none":
        c.tstat.type = TSTAT_NONE
    elif kind == "nose":
        c.tstat.type = TSTAT_NOSE
        c.tstat.tau = sc.scanf(" %lf ")[0]
    elif kind == "radi":
        c.tstat.type = TSTAT_RADI
        vals = sc.scanf("%d")
        if not vals:
            raise ValueError("there is no step parameter for radiative thermostat")
        c.tstat.step = vals[0]
    else:
        raise ValueError(f"unknown thermostat type: {kind}")

    # --- electrostatics (elec.cpp:14-79) ---
    kind = sc.find_str(" elec %5s")
    if kind is None:
        raise ValueError("electrostatic calculations are not specified in control.txt")
    if kind == "none":
        c.elec.type = ELEC_NONE
        c.elec.r_real = 0.0
    elif kind == "dir":
        c.elec.type = ELEC_DIRECT
        c.elec.r_real = sc.scanf(" %lf ")[0] * units.R_SCALE
    elif kind == "pme":
        c.elec.type = ELEC_EWALD
        r, a, kx, ky, kz = sc.scanf(" %lf %lf %d %d %d")
        c.elec.r_real = r * units.R_SCALE
        c.elec.alpha = a
        c.elec.kx, c.elec.ky, c.elec.kz = kx, ky, kz
    elif kind == "fenn":
        c.elec.type = ELEC_FENNEL
        r, a = sc.scanf(" %lf %lf")
        c.elec.r_real = r * units.R_SCALE
        c.elec.alpha = a
    else:
        raise ValueError(f"unknown type of electrostatic calculations: {kind}")
    if not charged_spec and c.elec.type:
        # WARNING[b004] semantics: no charges -> electrostatics off
        c.elec.type = ELEC_NONE

    c.elec.eps = sc.find_double(" permittivity %lf ", 1.0)

    # --- initial velocities ---
    kind = sc.find_str(" init_vel %s")
    if kind is None:
        raise ValueError("no init_vel directive in control.txt")
    if kind not in _INITVEL:
        raise ValueError(f"unknown value of init_vel directive: {kind}")
    c.init_vel = _INITVEL[kind]
    if c.init_vel == INITVEL_CONST:
        c.init_vel_vec = tuple(sc.scanf("%lf %lf %lf"))
    elif c.init_vel == INITVEL_ENG:
        c.init_vel_ekin = sc.scanf("%lf")[0]

    # --- electron hopping ---
    c.ejump = sc.find_number(" eJump %d ")
    if c.ejump != 0:
        r, kind = sc.scanf("%lf %s ")
        c.r_elec = r * units.R_SCALE
        if kind == "eq":
            c.ejtype = JUMP_EQ
            c.d_ejump = sc.scanf("%lf")[0]
        elif kind == "min":
            c.ejtype = JUMP_MIN
        elif kind == "metr":
            c.ejtype = JUMP_METR
        else:
            raise ValueError(f"unknown electron jump type: {kind}")

    # --- external field ---
    ux = sc.find(" elecfield %lf ")
    if ux is not None:
        c.ux = ux[0]
        uy_uz = sc.scanf(" %lf %lf ")
        if len(uy_uz) == 2:
            c.uy, c.uz = uy_uz

    sx = sc.find(" shiftX %lf ")
    if sx is not None:
        c.shift_x = sx[0]
        sv = sc.scanf(" %lf ")
        c.shift_val = sv[0] if sv else 0.0

    c.reset_vels = sc.find_number(" reset_vels %d ")

    cs = sc.find_double(" cell_list %lf ")
    if cs is not None:
        c.use_clist = True
        c.cell_size = cs

    # --- rdf (rdf.cpp:14-38) ---
    r = sc.find_double(" rdf %lf ")
    if r is None:
        raise ValueError("no rdf directive in control.txt")
    c.r_rdf = r
    c.d_rdf, c.fr_rdf, c.fr_rdf_out = sc.scanf(" %lf %d %d")
    c.nuclei_rdf = sc.scanf(" %s")[0] == "nucl"

    c.hist = sc.find_int(" hist %d ", 0)
    c.stat = sc.find_int(" stat %d ", 1000)
    c.vaf = sc.find_int(" vaf %d ", 0)
    c.revcon = sc.find_int(" revcon %d ", 0)

    # --- CN output ---
    rcn = sc.find_double(" outCN %lf ")
    if rcn is not None:
        c.out_cn = True
        c.r2_cn = rcn * rcn
        n = sc.scanf("%d")[0]
        c.cn_central = tuple(sc.scanf("%s")[0] for _ in range(n))
        n = sc.scanf("%d")[0]
        c.cn_counter = tuple(sc.scanf("%s")[0] for _ in range(n))

    # --- nucleus CN output (read by out_ncn itself in the reference,
    # out_md.cpp:216-247: "ncn <n>" then n lines "name1 name2 radius") ---
    n = sc.find_int(" ncn %d ")
    if n:
        pairs = []
        for _ in range(n):
            nm1, nm2, r = sc.scanf("%8s %8s %lf")
            pairs.append((nm1, nm2, r))
        c.ncn_pairs = tuple(pairs)

    # --- trajectories ---
    tr = sc.find_int(" traj %d ")
    if tr is not None:
        c.st_traj = tr
        c.fr_traj, a1, a2 = sc.scanf("%d %d %d")
        c.at1_traj = a1
        c.at2_traj = a2 + 1     # exclusive bound, sys_init.cpp:923

    # --- bind trajectories ---
    bt = sc.find_str(" bindtraj %s ")
    if bt is not None:
        c.bindtraj_nucl = bt
        c.bindtraj_start, c.bindtraj_freq = sc.scanf("%d %d")

    c.max_neigh = sc.find_int(" max_neigh %d ", 50)
    return c


def parse_control_file(path, charged_spec: bool = True) -> ControlSpec:
    with open(path, "r", errors="replace") as f:
        return parse_control(f.read(), charged_spec)
