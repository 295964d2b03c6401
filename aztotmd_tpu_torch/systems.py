"""Deck writers (the port's counterpart of ``aztotmd_tpu/systems.py``).

``write_surkov_cluster_deck`` writes the dense Surkov cluster deck that
the port's slice runs (``examples/surkov_cluster/``): one species with the
radius-dependent Surkov potential and the radiative thermostat, packed
into a sub-cube of a periodic box.  ``write_nanoclusters_deck``,
``write_reactive_polymer_deck`` and ``write_ejump_redox_deck`` write the
committed examples of those names byte for byte at their defaults (they
were made by ``tools/make_examples.py``) and smaller decks of the same
shape for tests; ``tile_deck`` replicates a deck k x k x k at the same
density.  ``write_lj_deck`` writes the same argon deck as
``aztotmd_tpu.systems.write_lj_deck``, without JAX.
``write_liquid_argon_deck`` writes ``examples/liquid_argon/``, the uniform
LJ liquid that the cell-block engines run; ``liquid_argon_specs`` is the
same system at test sizes.  ``write_argon_gas_deck`` writes
``examples/argon_gas/``, the dilute argon gas of the reference's case
study 1 that the Verlet-list engine runs.  The decks of the JAX
system's tools come from examples/argon_gas by default:
``write_scale_argon_deck`` (``tools/make_bigdeck.py``: 320,000 or
1,080,000 atoms), ``write_dilute_argon_deck``
(``tools/make_dilute_deck.py``) and ``write_argon_nve_deck``
(``tools/make_nve_deck.py``), byte for byte what each tool writes from
the same source deck.  ``build_lj_argon`` (with
``lj_argon_field``) and ``clustered_slab_system`` build the JAX package's
in-memory systems of those names, state for state.  ``rdf_edge_deck``
builds the crafted pairs on which the all-pairs RDF's CUDA kernel and its
plain version are held to the JAX package's counts.
"""

from __future__ import annotations

import math
import os
import shutil
from types import SimpleNamespace

import numpy as np

from . import units
from .io.atoms import parse_atoms_file
from .io.control import (INITVEL_GAUSS, JUMP_METR, TSTAT_NONE, ControlSpec,
                         ElecSpec, TStatSpec)
from .io.field import (_VDW_ABBR, VDW_LJ, VDW_SURK, FieldSpec, SpeciesSpec,
                       VdWSpec, parse_field)
from .output.writers import write_atoms_xyz

# Surkov parameters: C1=75, C2=8, ki=kj=1 put the pair minimum near 1.4 A
# for radii ~0.577 (r_min = 7 C1 a^5 / (3 C2) for equal radii a).
SURKOV_P = (75.0, 8.0, 1.0, 1.0)
# thermal radius r = A/(B - min(E, mxEng)) starts at A/B = 0.577 A; the
# large B keeps r within ~1% for internal energies of a few 0.01 eV
SURKOV_RADII = (2.885, 5.0, 1.0)     # radA, radB, mxEng


def cluster_positions(n_atoms: int, box: float, density: float,
                      seed: int, jitter: float = 0.1):
    """Jittered simple-cubic lattice of ``n_atoms`` filling a centred
    sub-cube of side (n_atoms/density)^(1/3) of a periodic box."""
    rng = np.random.default_rng(seed)
    side = (n_atoms / density) ** (1.0 / 3.0)
    if side >= box:
        raise ValueError(f"cluster side {side:.2f} does not fit box {box}")
    n_side = int(math.ceil(n_atoms ** (1.0 / 3.0) - 1e-9))
    spacing = side / n_side
    g = (np.arange(n_side) + 0.5) * spacing
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    keep = np.sort(rng.permutation(len(sites))[:n_atoms])
    pos = sites[keep] + rng.uniform(-jitter, jitter, (n_atoms, 3)) * spacing
    return pos + 0.5 * (box - side)


def write_surkov_cluster_deck(path, n_atoms: int = 4000, box: float = 35.0,
                              density: float = 0.43, steps: int = 20000,
                              n_equil: int = 1000, seed: int = 2):
    """Write the three-file deck (atoms.xyz, control.txt, field.txt).

    Defaults: 4,000 atoms at 0.43 atoms/A^3 (a ~21 A sub-cube) in a 35 A
    box, Surkov with rcut 6 A and a radii section, no electrostatics,
    dt 1 fs, radiative thermostat at 500 K, Gaussian initial velocities,
    stat every 200 steps, RDF to 6 A in 0.05 A bins every 10 steps.
    """
    os.makedirs(path, exist_ok=True)
    pos = cluster_positions(n_atoms, box, density, seed)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{n_atoms}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        for p in pos:
            f.write(f"Su\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil {n_equil}
eqfreq 100
temperature 500.0\tradi\t1
init_vel\tgaus

permittivity 1.0
elec\tnone

rdf\t6.0 0.05\t10\t0\t-nucl
stat\t200
""")
    c1, c2, ki, kj = SURKOV_P
    ra, rb, mx = SURKOV_RADII
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write(f"""spec 1
Su\tSu\t39.9\t0.0\t0.0
red-ox 0
vdw 1
Su\tSu\tsurk\t6.0\t{c1}\t{c2}\t{ki}\t{kj}
radii 1
Su\t{ra}\t{rb}\t{mx}
""")


def write_nanoclusters_deck(path, n_clusters: int = 10, per: int = 1200,
                            box: float = 170.0, min_sep: float = 50.0,
                            steps: int = 10000, seed: int = 29):
    """Write the multi-cluster Ar LJ deck of ``examples/nanoclusters/``:
    ``n_clusters`` jittered-lattice spheres of ``per`` atoms (spacing
    2.6 A) at centres at least ``min_sep`` apart in a periodic box,
    Nose-Hoover 90 K, no Coulomb, RDF and stat every 200 steps.  The
    defaults write the committed example byte for byte (it was made by
    ``tools/make_examples.py``); smaller arguments give test decks of the
    same shape."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    centers = []
    while len(centers) < n_clusters:
        c = rng.uniform(0.0, box, size=3)
        dd = np.asarray(centers) - c if centers else np.zeros((0, 3))
        dd -= box * np.round(dd / box)
        if not len(dd) or (np.sum(dd * dd, axis=1) > min_sep ** 2).all():
            centers.append(c)
    s = 2.6
    g = (np.arange(-8, 9) + 0.5) * s
    cube = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cube = cube[np.argsort(np.sum(cube * cube, axis=1))][:per]
    pos = np.concatenate([c + cube + rng.uniform(-0.25, 0.25, cube.shape)
                          for c in centers]) % box
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{len(pos)}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        for p in pos:
            f.write(f"Ar\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil 500
eqfreq 100
temperature 90.0\tnose\t0.5
init_vel\tgaus

permittivity 1.0
elec\tnone

rdf\t6.0 0.05\t200\t0\t-nucl
stat\t200
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write("""spec 1
Ar\tAr\t39.948\t0.0\t0.0
red-ox 0
vdw 1
Ar\tAr\tlnjs\t6.0\t0.0104\t2.5
""")


def write_reactive_polymer_deck(path, n_side: int = 8, steps: int = 20000,
                                seed: int = 13):
    """Write the reactive A/B deck of ``examples/reactive_polymer/``: a
    jittered n_side^3 lattice (spacing 2.5 A) of A and B atoms, LJ pairs
    with rcut 5 A, no Coulomb, no bonds at the start; A-B bonds form
    within 1.8 A (linkage) and break past 2.5 A; Nose-Hoover 400 K."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    box = n_side * 2.5
    g = np.arange(n_side) * 2.5 + 1.25
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.uniform(-0.5, 0.5, pos.shape)) % box
    names = ["A", "B"] * (len(pos) // 2)
    rng.shuffle(names)
    write_atoms_xyz(os.path.join(path, "atoms.xyz"), names, pos, (box,) * 3)
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.0005 ps
nstep {steps}
nequil 500
eqfreq 100
temperature 400.0\tnose\t0.2
init_vel\tgaus

permittivity 1.0
elec\tnone

rdf\t6.0 0.05\t100\t0\t-nucl
stat\t100
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write("""spec 2
A\tA\t20.0\t0.0\t0.0
B\tB\t20.0\t0.0\t0.0
red-ox 0
vdw 3
A\tA\tlnjs\t5.0\t0.008\t2.4
A\tB\tlnjs\t5.0\t0.006\t2.3
B\tB\tlnjs\t5.0\t0.008\t2.4
bonds 1
1 A B harm 12.0 1.5 con br 2.5 A B
linkage 1
A B 1.8 1
""")


# ejump_redox field: Fe2+ donates to Fe3+ (red-ox line), Buckingham pairs
# with rcut 8 A
EJUMP_FIELD = """spec 3
Fe2\tFe\t55.8\t2.0\t0.6
Fe3\tFe\t55.8\t3.0\t0.0
O\tO\t16.0\t-2.0\t0.0
red-ox 1
2 Fe3 Fe2
vdw 4
Fe2\tO\tbuck\t8.0\t1200.0\t0.31\t0.0
Fe3\tO\tbuck\t8.0\t1500.0\t0.29\t0.0
O\tO\tbuck\t8.0\t22764.0\t0.149\t27.88
Fe2\tFe3\tbuck\t8.0\t800.0\t0.3\t0.0
"""


def write_ejump_redox_deck(path, n_side: int = 8, n_fe2: int = 96,
                           n_fe3: int = 64, n_o: int = 192,
                           steps: int = 10000, seed: int = 11):
    """Write the redox deck of ``examples/ejump_redox/``: Fe2+, Fe3+ and
    O2- on a jittered n_side^3 lattice (spacing 3 A; the first
    n_fe2 + n_fe3 + n_o sites after a shuffle of the names), direct
    Coulomb with rcut 8 A and permittivity 4, Metropolis electron jumps
    within 3 A five passes a step, Nose-Hoover 600 K."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    box = n_side * 3.0
    g = np.arange(n_side) * 3.0 + 1.5
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.uniform(-0.4, 0.4, pos.shape)) % box
    names = ["Fe2"] * n_fe2 + ["Fe3"] * n_fe3 + ["O"] * n_o
    rng.shuffle(names)
    pos = pos[:len(names)]
    write_atoms_xyz(os.path.join(path, "atoms.xyz"), names, pos, (box,) * 3)
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil 500
eqfreq 100
temperature 600.0\tnose\t0.3
init_vel\tgaus

permittivity 4.0
elec\tdir\t8.0

eJump\t5\t3.0\tmetr

rdf\t8.0 0.05\t100\t0\t-nucl
stat\t100
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write(EJUMP_FIELD)


def tile_deck(src, dst, k: int):
    """Replicate the deck in ``src`` k x k x k into ``dst`` at the same
    density: the atoms of image (a, b, c) are shifted by (a, b, c) box
    lengths, images in that order; control.txt and field.txt are copied.
    Decks with bond or angle lists are refused."""
    for name in ("bonds.txt", "angles.txt"):
        if os.path.exists(os.path.join(src, name)):
            raise ValueError(f"tile_deck: {name} is not replicated")
    atoms = parse_atoms_file(os.path.join(src, "atoms.xyz"))
    box = np.asarray(atoms.box, np.float64)
    pos = np.asarray(atoms.pos, np.float64)
    shifts = [np.array([a, b, c]) * box for a in range(k) for b in range(k)
              for c in range(k)]
    os.makedirs(dst, exist_ok=True)
    write_atoms_xyz(os.path.join(dst, "atoms.xyz"),
                    list(atoms.names) * len(shifts),
                    np.concatenate([pos + sh for sh in shifts]), box * k)
    for name in ("control.txt", "field.txt"):
        with open(os.path.join(src, name)) as f:
            text = f.read()
        with open(os.path.join(dst, name), "w") as f:
            f.write(text)


def reactive_specs(n_atoms: int = 300, seed: int = 3, spacing: float = 3.0,
                   jitter: float = 0.6):
    """A three-species system for the candidate checks: the ejump_redox
    species and pairs (Fe2 donates to Fe3) with an Fe3-O bond type that
    forms within 2.4 A, on a lattice of ``spacing`` (3 A) jittered by up to
    ``jitter`` (0.6 A) in a box of at least 6 spacings; direct Coulomb and
    jumps within 3 A.  Without jitter and at a spacing of 2 A every
    distance is exact in f32, so bind and jump candidates tie in r2.
    Returns (ctl, fld, box, pos, types, None) as host specs."""
    rng = np.random.default_rng(seed)
    n_side = max(6, int(math.ceil(n_atoms ** (1.0 / 3.0))))
    box = spacing * n_side
    g = np.arange(n_side) * spacing + spacing / 2
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    keep = np.sort(rng.permutation(len(sites))[:n_atoms])
    pos = (sites[keep] + rng.uniform(-jitter, jitter, (n_atoms, 3))) % box
    fld = parse_field(EJUMP_FIELD + """bonds 1
1 Fe3 O harm 12.0 1.9 con br 3.0 Fe3 O
linkage 1
Fe3 O 2.4 1
""")
    ctl = ControlSpec(t_step=0.001, n_step=1,
                      tstat=TStatSpec(type=0, temp=600.0),
                      elec=ElecSpec(type=1, r_real=8.0, eps=4.0),
                      ejump=5, ejtype=JUMP_METR, r_elec=3.0)
    types = np.asarray(rng.integers(0, 3, n_atoms), np.int32)
    return ctl, fld, box, pos, types, None


# argon LJ parameters (the reference's case study 1 field)
AR_EPS = 0.01006        # eV
AR_SIG = 3.3952         # A
AR_MASS = 39.9


def lattice_positions(n_atoms: int, density: float,
                      jitter: float = 0.05, seed: int = 0):
    """Jittered cubic lattice filling a cubic box at the number density
    ``density`` (atoms/A^3), as ``aztotmd_tpu.systems.lattice_positions``:
    (positions wrapped into the box, box length)."""
    rng = np.random.default_rng(seed)
    box = (n_atoms / density) ** (1.0 / 3.0)
    n_side = int(np.ceil(n_atoms ** (1.0 / 3.0)))
    spacing = box / n_side
    g = (np.arange(n_side) + 0.5) * spacing
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = pos[:n_atoms] + rng.uniform(-jitter, jitter, (n_atoms, 3)) * spacing
    return pos % box, box


def lj_argon_field(rcut: float = 4.0, eps: float = AR_EPS,
                   sig: float = AR_SIG) -> FieldSpec:
    """One-species argon LJ field, pre-scaled as the reference reader
    does (p0 = 4 eps, p1 = sigma^2, p2 = 24 eps)."""
    f = FieldSpec()
    f.species = [SpeciesSpec(name="Ar", nuclei=0, mass=AR_MASS * units.M_SCALE,
                             charge=0.0, energy=0.0)]
    f.nnames = ["Ar"]
    f.nnumbers = [0]
    f.pairpots = [VdWSpec(type=VDW_LJ, spec1=0, spec2=0, r2cut=rcut * rcut,
                          p0=4 * eps, p1=sig * sig, p2=24 * eps)]
    f.vdw_index = [[0]]
    f.maxRvdw = rcut
    return f


def build_lj_argon(n_atoms: int = 4096, density: float = 0.012,
                   temp: float = 120.0, rcut: float = 4.0,
                   tstat: int = TSTAT_NONE, dt: float = 0.001,
                   dtype: str = "f32", seed: int = 7, **kw):
    """Argon LJ on ``lattice_positions`` at ``density`` atoms/A^3 with
    Gaussian velocities at ``temp``: (cfg, ff, state, aux), the system of
    ``aztotmd_tpu.systems.build_lj_argon`` at the same arguments.  ``kw``
    goes to ``runtime.setup.build_system`` (``device``, ``pair_engine``,
    ...); the tensors are on the CPU unless ``device`` says otherwise."""
    from .io.atoms import AtomsData
    from .runtime.setup import build_system
    pos, box = lattice_positions(n_atoms, density, seed=seed)
    ctl = ControlSpec(t_step=dt, n_step=100,
                      tstat=TStatSpec(type=tstat, temp=temp, tau=0.5),
                      elec=ElecSpec(type=0))
    ctl.init_vel = INITVEL_GAUSS
    ctl.tstat.temp = temp
    fld = lj_argon_field(rcut=rcut)
    atoms = AtomsData(names=["Ar"] * n_atoms, pos=pos, box=(box, box, box))
    return build_system(ctl, fld, atoms, dtype=dtype, seed=seed, **kw)


def clustered_slab_system(n_dev: int = 4, seed: int = 11, device=None):
    """Two 6x6x6 jittered LJ clusters spanning slab boundaries in a dilute
    40 A box, the dense regime that the slab step's rectangular pass (K2)
    takes: (cfg, ff, state, aux) with cfg slab-prepared for ``n_dev``
    slabs, as ``aztotmd_tpu.systems.clustered_slab_system``."""
    import dataclasses

    import torch

    from .parallel import slab

    n_side = 6
    n_at = 2 * n_side ** 3
    box = 40.0
    cfg, ff, state, aux = build_lj_argon(n_atoms=n_at,
                                         density=n_at / box ** 3,
                                         dtype="f32", seed=seed, temp=30.0,
                                         device=device)
    assert abs(cfg.box[0] - box) < 1e-6
    rng = np.random.default_rng(seed)
    g = np.arange(n_side) * 3.6
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                   axis=-1).reshape(-1, 3)
    pos = np.concatenate([lat + np.array([2.0, 2.0, 2.0]),
                          lat + np.array([20.0, 18.0, 16.0])])
    pos = (pos + rng.uniform(-0.25, 0.25, (n_at, 3))) % box
    pos = torch.as_tensor(pos.astype(np.float32), device=device)
    cfg = dataclasses.replace(cfg, pair_engine="pallas")
    cfg = slab.prepare_slab_cfg(cfg, n_dev)
    assert cfg.pair_engine == "pallas"      # the dense slab pass
    state = state.replace(pos=pos, pos0=pos.clone(), nbr_ref=pos + 1e9)
    return cfg, ff, state, aux


def write_liquid_argon_deck(path, n_side: int = 32, density: float = 0.021,
                            rcut: float = 8.5, steps: int = 10000,
                            seed: int = 7):
    """Write the liquid-argon deck of ``examples/liquid_argon/``:
    n_side^3 Ar atoms on a jittered cubic lattice at ``density`` atoms/A^3
    (32,768 atoms in a 115.987 A box at the liquid's 0.021), LJ with
    eps 0.01006 eV and sigma 3.3952 A cut at ``rcut`` (2.5 sigma), no
    Coulomb, Nose-Hoover at 90 K, dt 1 fs, stat and an RDF sample (to
    10 A in 0.05 A bins) every 200 steps.  A uniform liquid: the engine
    auto-selection takes it to the cell-block engine."""
    os.makedirs(path, exist_ok=True)
    n = n_side ** 3
    pos, box = lattice_positions(n, density, seed=seed)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{n}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        for p in pos:
            f.write(f"Ar\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil 500
eqfreq 100
temperature 90.0\tnose\t0.5
init_vel\tgaus

permittivity 1.0
elec\tnone

rdf\t10.0 0.05\t200\t0\t-nucl
stat\t200
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write(f"""spec 1
Ar\tAr\t39.948\t0.0\t0.0
red-ox 0
vdw 1
Ar\tAr\tlnjs\t{rcut}\t{AR_EPS}\t{AR_SIG}
""")


def liquid_argon_specs(n_atoms: int = 2048, density: float = 0.012,
                       rcut: float = 4.0, seed: int = 17, nsp: int = 1,
                       elec: int = 0, radii: bool = False):
    """A uniform fluid on ``lattice_positions`` for the cell-block
    checks: argon LJ (the system of ``aztotmd_tpu.systems.build_lj_argon``)
    or, with ``nsp``/``elec``/``radii``, the species and pairs of
    ``_pair_field`` on the same positions.  Returns (ctl, fld, box, pos,
    types, radii-or-None) as host specs."""
    pos, box = lattice_positions(n_atoms, density, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if nsp == 1 and not elec and not radii:
        f = FieldSpec()
        f.species = [SpeciesSpec(name="Ar", nuclei=0,
                                 mass=39.9 * units.M_SCALE, charge=0.0,
                                 energy=0.0)]
        f.nnames = ["Ar"]
        f.nnumbers = [0]
        f.pairpots = [VdWSpec(type=VDW_LJ, spec1=0, spec2=0,
                              r2cut=rcut * rcut, p0=4 * AR_EPS,
                              p1=AR_SIG * AR_SIG, p2=24 * AR_EPS)]
        f.vdw_index = [[0]]
        f.maxRvdw = rcut
        ctl = ControlSpec(t_step=0.001, n_step=100,
                          tstat=TStatSpec(type=0, temp=120.0, tau=0.5),
                          elec=ElecSpec(type=0))
    else:
        ctl, f = _pair_field(nsp, elec, radii, rcut)
    types = np.asarray(rng.integers(0, nsp, n_atoms), np.int32)
    rad = 0.577 + 0.1 * rng.uniform(size=n_atoms) if radii else None
    return ctl, f, box, pos, types, rad


def write_lj_deck(path, n_side=9, box=40.0, steps=300, seed=5):
    """Write the small Ar LJ deck (radiative thermostat + RDF) that
    ``aztotmd_tpu.systems.write_lj_deck`` writes, byte for byte."""
    rng = np.random.default_rng(seed)
    g = (np.arange(n_side) + 0.5) * (box / n_side)
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                   axis=-1).reshape(-1, 3)
    pos += rng.uniform(-0.4, 0.4, pos.shape)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{len(pos)}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        for p in pos:
            f.write(f"Ar\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil  0
eqfreq 100
temperature 60.0\tradi\t0.2
init_vel\tzero\t0.0332
permittivity  1.0
elec\tfenn\t4.0\t0.4\t6\t6\t6
rdf\t6.0   0.05\t50\t0\tnucl
stat\t100
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write("""spec 1
Ar\tAr\t39.9\t0.0\t0.0
red-ox 0
vdw 1
Ar\tAr\tlnjs\t4.0    0.01006\t3.3952
""")



def min_separation_positions(n_atoms: int, box: float, min_sep: float,
                             seed: int):
    """Seeded uniform positions in a cubic periodic box, each at least
    ``min_sep`` from every earlier one (minimum image): a draw closer than
    that is dropped and drawn again.  A hash grid of cells no narrower
    than ``min_sep`` keeps each test to the 27 cells around the draw."""
    rng = np.random.default_rng(seed)
    n_c = max(int(box // min_sep), 1)
    edge = box / n_c
    cells: dict = {}
    pos = np.empty((n_atoms, 3))
    k = 0
    while k < n_atoms:
        p = rng.uniform(0.0, box, 3)
        c = np.floor(p / edge).astype(np.int64) % n_c
        near = False
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    key = ((c[0] + dx) % n_c, (c[1] + dy) % n_c,
                           (c[2] + dz) % n_c)
                    for q in cells.get(key, ()):
                        d = p - pos[q]
                        d -= box * np.round(d / box)
                        if d @ d < min_sep * min_sep:
                            near = True
                            break
                    if near:
                        break
                if near:
                    break
            if near:
                break
        if near:
            continue
        pos[k] = p
        cells.setdefault((c[0], c[1], c[2]), []).append(k)
        k += 1
    return pos


def write_argon_gas_deck(path, n_atoms: int = 40000,
                         density: float = 2.69e-5, min_sep: float = 3.0,
                         steps: int = 10000, seed: int = 11):
    """Write the dilute argon gas of ``examples/argon_gas/``, case study
    1's configuration: ``n_atoms`` Ar at ``density`` atoms/A^3 (40,000 in
    a 1,141.4 A box), seeded uniform draws at least ``min_sep`` A apart,
    LJ with eps 0.01006 eV and sigma 3.3952 A cut at 4 A, Fennel
    electrostatics declared at 4 A (inert: Ar is neutral), dt 1 fs, the
    radiative thermostat at 298 K from Gaussian velocities, stat every
    200 steps and an RDF sample (to 14 A in 0.02 A bins) every 50.  The
    engine auto-selection takes it to the two-level Verlet list with the
    row-compacted walk; the box follows the density at any ``n_atoms``."""
    os.makedirs(path, exist_ok=True)
    box = (n_atoms / density) ** (1.0 / 3.0)
    pos = min_separation_positions(n_atoms, box, min_sep, seed)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{n_atoms}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        for p in pos:
            f.write(f"Ar\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil  0
eqfreq 100
temperature 298.0\tradi\t0.2
init_vel\tgaus

permittivity  1.0
elec\tfenn\t4.0\t0.4\t6\t6\t6
rdf\t14.0   0.02\t50\t0\tnucl
stat\t200
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write(f"""spec 1
Ar\tAr\t39.948\t0.0\t0.0
red-ox 0
vdw 1
Ar\tAr\tlnjs\t4.0\t{AR_EPS}\t{AR_SIG}
""")

ARGON_GAS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "argon_gas")


def _read_argon_base(src):
    """(n0, box0, (n0, 3) positions) of ``src``/atoms.xyz, read as the
    JAX package's deck tools read their source deck."""
    with open(os.path.join(src, "atoms.xyz")) as f:
        n0 = int(f.readline().split()[0])
        box0 = float(f.readline().split()[1])
        base = np.loadtxt(f, usecols=(1, 2, 3), max_rows=n0)
    return n0, box0, base


def write_scale_argon_deck(path, tiles: int, steps: int = 2000,
                           stat: int = 200, src=ARGON_GAS):
    """Write the scale deck of ``tools/make_bigdeck.py`` from ``src``
    (default examples/argon_gas, case study 1 at full size): its atoms
    tiled image-major on a tiles^3 lattice, jittered by up to 0.05 A
    (``np.random.default_rng(11)``) and wrapped into the box, with the
    tool's control.txt and field.txt.  tiles=2 gives 320,000 atoms and
    tiles=3 1,080,000 from examples/argon_gas.  Returns the atom count."""
    n0, box0, base = _read_argon_base(src)
    t = tiles
    rng = np.random.default_rng(11)
    shifts = np.stack(np.meshgrid(*[np.arange(t) * box0] * 3,
                                  indexing="ij"), -1).reshape(-1, 3)
    pos = (base[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    pos += rng.uniform(-0.05, 0.05, pos.shape)
    box = box0 * t
    pos %= box
    n = len(pos)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{n}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        np.savetxt(f, pos, fmt="Ar\t%.6f\t%.6f\t%.6f")
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""timestep 0.001 ps
nstep {steps}
nequil  0
eqfreq 100
temperature 298.0\tradi\t0.2
init_vel\tzero\t0.0332
permittivity  1.0
cell_list\t85.0
max_neigh\t185
elec\tfenn\t8.0\t0.4\t6\t6\t6
rdf\t14.0   0.02\t50\t{10 * steps}\tnucl
eJump\t0\t1.7\tmetr
Ux\t\t0.0
stat\t\t{stat}
""")
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write("""spec 1
Ar\tAr\t39.9\t0.0\t0.0
red-ox 0
vdw 1
Ar\tAr\tlnjs\t4.0    0.01006\t3.3952
""")
    return n


def write_dilute_argon_deck(path, scale: float = 3.0, steps: int = 10000,
                            stat: int = 200, src=ARGON_GAS):
    """Write the dilute deck of ``tools/make_dilute_deck.py`` from ``src``:
    its positions and box scaled by ``scale`` (density / scale^3; 1.0e-6
    atoms/A^3 at 3 from examples/argon_gas), its field.txt copied, the
    tool's control.txt.  Few rows then have an outer Verlet neighbor, so
    the configuration sets ``nb_orowcap`` and the refine sweeps only the
    outer-occupied rows.  Returns the atom count."""
    n0, box0, base = _read_argon_base(src)
    pos = base * scale
    box = box0 * scale
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{n0}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        for p in pos:
            f.write(f"Ar\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")
    with open(os.path.join(src, "field.txt")) as f:
        field = f.read()
    with open(os.path.join(path, "field.txt"), "w") as f:
        f.write(field)
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(f"""\
timestep 0.001 ps
nstep {steps}
nequil  0
eqfreq 100
temperature 298.0\tradi\t0.2
init_vel\tzero\t0.0332

permittivity  1.0

elec\tfenn\t8.0\t0.4\t6\t6\t6

rdf\t14.0   0.02\t50\t{steps}\tnucl

eJump\t0\t1.7\tmetr

Ux\t\t0.0

stat\t\t{stat}
""")
    return n0


NVE_CONTROL = """timestep 0.001 ps
nstep 100000
nequil  0
eqfreq 100
temperature 298.0\tnone
init_vel\tgaus\t0.0332

permittivity  1.0

cell_list\t85.0
max_neigh\t185

elec\tfenn\t8.0\t0.4\t6\t6\t6

eJump\t0\t1.7\tmetr

Ux\t\t0.0

rdf\t14.0   0.02\t50\t500000\tnucl
stat\t\t200
"""


def write_argon_nve_deck(path, src=ARGON_GAS):
    """Write the NVE drift deck of ``tools/make_nve_deck.py``: ``src``'s
    atoms.xyz and field.txt copied, thermostat off, Gaussian velocities
    at 298 K, 100,000 steps of 1 fs."""
    os.makedirs(path, exist_ok=True)
    for name in ("atoms.xyz", "field.txt"):
        shutil.copy(os.path.join(src, name), os.path.join(path, name))
    with open(os.path.join(path, "control.txt"), "w") as f:
        f.write(NVE_CONTROL)


# pre-scaled parameters per VdW family (parse-time conventions of
# aztotmd_tpu/io/field.py; LJ: p0=4e, p1=s^2, p2=24e)
FAMILY_PARAMS = {
    "lnjs": dict(p0=4 * 0.01, p1=3.4 * 3.4, p2=24 * 0.01),
    "buck": dict(p0=1200.0, p1=0.31, p2=27.88),
    "p746": dict(p0=100.0, p1=5.0, p2=20.0),
    "bmhs": dict(p0=300.0, p1=3.0, p2=2.5, p3=50.0, p4=100.0),
    "elin": dict(p0=500.0, p1=0.30, p2=2.0),
    "einv": dict(p0=500.0, p1=0.30, p2=5.0),
}


def _pair_field(nsp, elec, radii, rcut=5.0):
    """(ctl, fld) of the pair-pass checks: ``nsp`` species with
    alternating charges when ``elec`` (an ELEC_* type) is set, LJ or
    (``radii``) Surkov pairs, cutoff ``rcut``."""
    f = FieldSpec()
    f.species = [SpeciesSpec(name=f"S{k}", nuclei=0,
                             mass=39.9 * units.M_SCALE,
                             charge=(0.5 if k % 2 else -0.5)
                             * units.Q_SCALE if elec else 0.0,
                             energy=0.0)
                 for k in range(nsp)]
    f.nnames = [s.name for s in f.species]
    f.nnumbers = [0] * nsp
    f.vdw_index = [[None] * nsp for _ in range(nsp)]
    for a in range(nsp):
        for b in range(a, nsp):
            if radii:
                pp = VdWSpec(type=VDW_SURK, spec1=a, spec2=b,
                             r2cut=rcut * rcut, p0=75.0, p1=8.0,
                             p2=1.0, p3=1.0, use_radii=1)
            else:
                pp = VdWSpec(type=VDW_LJ, spec1=a, spec2=b,
                             r2cut=rcut * rcut, **FAMILY_PARAMS["lnjs"])
            f.vdw_index[a][b] = f.vdw_index[b][a] = len(f.pairpots)
            f.pairpots.append(pp)
    f.maxRvdw = rcut
    ctl = ControlSpec(t_step=0.001, n_step=1,
                      tstat=TStatSpec(type=0, temp=100.0),
                      elec=ElecSpec(type=elec, r_real=rcut, alpha=0.3))
    return ctl, f


def clustered_specs(n_atoms=257, nsp=1, elec=0, seed=3, radii=False):
    """A dense cluster for pair-pass checks: atoms in a 12 A sub-box of a
    30 A periodic box, with the species and pairs of ``_pair_field``.
    Returns (ctl, fld, box, pos, types, radii-or-None) as host specs."""
    rng = np.random.default_rng(seed)
    box = 30.0
    pos = rng.uniform(2.0, 14.0, size=(n_atoms, 3))
    ctl, f = _pair_field(nsp, elec, radii)
    types = np.asarray(rng.integers(0, nsp, n_atoms), np.int32)
    rad = 0.577 + 0.1 * rng.uniform(size=n_atoms) if radii else None
    return ctl, f, box, pos, types, rad


def multi_cluster_specs(n_atoms=1500, n_clusters=5, nsp=2, elec=1,
                        box=120.0, seed=7, radii=False):
    """Several dense clusters (12 A cubes) scattered in a large periodic
    box, the regime of the block-sparse pass; cluster 0 sits on the box
    corner, so it wraps all three axes.  Atoms that do not divide evenly
    into clusters are spread over the box.  Species and pairs as
    ``_pair_field``; specs as ``clustered_specs``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10.0, box - 10.0, size=(n_clusters, 3))
    centers[0] = (0.5, box - 0.5, 0.5)
    per = n_atoms // n_clusters
    chunks = [centers[k] + rng.uniform(-6.0, 6.0, size=(per, 3))
              for k in range(n_clusters)]
    rest = n_atoms - per * n_clusters
    if rest:
        chunks.append(rng.uniform(0.0, box, size=(rest, 3)))
    pos = np.concatenate(chunks) % box
    ctl, f = _pair_field(nsp, elec, radii)
    types = np.asarray(rng.integers(0, nsp, n_atoms), np.int32)
    rad = 0.577 + 0.1 * rng.uniform(size=n_atoms) if radii else None
    return ctl, f, box, pos, types, rad


def family_specs(fam: str):
    """One VdW family (a key of FAMILY_PARAMS) on a jittered 7^3 lattice
    in a 24 A box (nearest separation ~2.4 A), rcut 5 A."""
    rng = np.random.default_rng(5)
    box = 24.0
    g = (np.arange(7) + 0.5) * (box / 7)
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos += rng.uniform(-0.5, 0.5, pos.shape)
    f = FieldSpec()
    f.species = [SpeciesSpec(name="S0", nuclei=0, mass=39.9 * units.M_SCALE,
                             charge=0.0, energy=0.0)]
    f.nnames = ["S0"]
    f.nnumbers = [0]
    f.pairpots = [VdWSpec(type=_VDW_ABBR[fam], spec1=0, spec2=0,
                          r2cut=25.0, **FAMILY_PARAMS[fam])]
    f.vdw_index = [[0]]
    f.maxRvdw = 5.0
    ctl = ControlSpec(t_step=0.001, n_step=1,
                      tstat=TStatSpec(type=0, temp=100.0),
                      elec=ElecSpec(type=0, r_real=5.0))
    return ctl, f, box, pos, np.zeros(len(pos), np.int32), None


def pair_system(specs, dtype: str = "f32", device=None,
                pair_engine: str = "pallas"):
    """(cfg, ff, pos, types, radii) tensors of host specs for a pair
    pass, the engine forced to ``pair_engine`` ("pallas" for the dense or
    stacked cell-block kernel, "sparse" for the block-sparse one, "block"
    for the cell-block engine)."""
    import torch
    from .core.config import build_sim_config
    from .core.ffield import build_forcefield
    ctl, fld, box, pos, types, rad = specs
    tdt = torch.float64 if dtype == "f64" else torch.float32
    cfg = build_sim_config(ctl, fld, (box, box, box), len(pos), dtype=dtype,
                           pos=pos, pair_engine=pair_engine)
    ff = build_forcefield(fld, ctl.t_step, eps=ctl.elec.eps, dtype=tdt,
                          device=device)
    t = lambda a, d: torch.as_tensor(np.asarray(a), dtype=d, device=device)
    return (cfg, ff, t(pos, tdt), t(types, torch.int32),
            t(rad, tdt) if rad is not None else None)


def rect_system(specs, n_i: int, empty: float = 0.2, seed: int = 6,
                n_slab: int = 1, device=None):
    """(cfg, ff, args, kwargs) of the rectangular pass K2 from pair-pass
    specs: n_slab copies of one slab whose j slots are the specs' atoms
    with a share ``empty`` of them turned into empty slots (zero position,
    type 0, radius 1) at random, and whose i slots are the first ``n_i``
    j slots.  ``args``/``kwargs`` go to
    ``ops.allpairs.pair_forces_allpairs_rect``."""
    import torch
    ctl, fld, box, pos, types, rad = specs
    valid = np.random.default_rng(seed).uniform(size=len(pos)) >= empty
    pos = np.where(valid[:, None], pos, 0.0)
    types = np.where(valid, types, 0)
    if rad is not None:
        rad = np.where(valid, rad, 1.0)
    cfg, ff, p, t, r = pair_system((ctl, fld, box, pos, types, rad),
                                   device=device)
    v = torch.as_tensor(valid, device=device)
    rep = lambda a: (None if a is None else
                     a.expand((n_slab,) + tuple(a.shape)).contiguous())
    args = (rep(p[:n_i]), rep(t[:n_i]), rep(v[:n_i]), rep(p), rep(t), rep(v))
    kwargs = dict(radii_i=rep(r[:n_i]) if r is not None else None,
                  radii_j=rep(r))
    return cfg, ff, args, kwargs


# The RDF edge decks: (box, r_rdf, d_rdf).  "exact": r_rdf and the bin
# edges exact in binary, r_rdf half the y side; "rounded": d_rdf inexact,
# r_rdf not a multiple of it (the last bin clamped), x half-side in range.
RDF_EDGE_SETUPS = {"exact": ((12.0, 14.0, 16.0), 7.0, 0.25),
                   "rounded": ((11.0, 12.6, 13.8), 6.1, 0.3)}


def rdf_edge_deck(setup: str, n_spec: int, dtype=np.float32, seed: int = 0):
    """(cfg, rdf, pos, types) of a deck of crafted pairs that put the
    all-pairs RDF's arithmetic on its edges, for the ``RDF_EDGE_SETUPS``
    entry ``setup``: ``cfg`` holds ``n_at``, ``box`` and ``volume``,
    ``rdf`` the fields of an ``RdfConfig`` (one nucleus, no nuclei
    histogram, no grid), ``pos`` (N, 3) is in ``dtype`` and ``types``
    int32.  Each pair is two atoms at 0 and at delta on one or two axes
    (the others shared), listed in both orders so that d = p_i - p_j
    takes both signs; delta is, each a few ulps either side: r_rdf on
    every axis; every bin edge k * d_rdf; half the box on every axis (the
    min-image's round(+-0.5)); half the x side beside bin edges on y; and
    r in the clamped last bin."""
    box, r_rdf, d_rdf = RDF_EDGE_SETUPS[setup]
    n_bin = int(min(r_rdf, min(box)) / d_rdf)
    f = np.dtype(dtype).type

    def hairs(x, m=2):
        out, up, dn = [f(x)], f(x), f(x)
        for _ in range(m):
            up = np.nextafter(up, f(np.inf))
            dn = np.nextafter(dn, f(-np.inf))
            out += [up, dn]
        return out

    deltas = []
    for a in range(3):
        deltas += [{a: v} for v in hairs(r_rdf, 3)]
        deltas += [{a: v} for v in hairs(0.5 * box[a])]
    for k in range(1, n_bin + 1):
        deltas += [{k % 3: v} for v in hairs(k * d_rdf)]
    for k in range(1, n_bin, 3):
        deltas += [{0: v, 1: f(k * d_rdf)} for v in hairs(0.5 * box[0], 1)]
    deltas += [{2: v} for v in hairs(0.5 * (n_bin * d_rdf + r_rdf))]
    rng = np.random.default_rng(seed)
    pos = []
    for dl in deltas:
        base = rng.uniform(0.0, 1.0, 3) * np.asarray(box)
        for a in dl:
            base[a] = 0.0
        far = base.copy()
        for a, v in dl.items():
            far[a] = v
        pos += [base, far, far, base]
    pos = np.asarray(pos).astype(dtype)
    types = rng.integers(0, n_spec, len(pos)).astype(np.int32)
    cfg = SimpleNamespace(n_at=len(pos), box=box,
                          volume=box[0] * box[1] * box[2])
    rdf = dict(n_bin=n_bin, d_rdf=d_rdf, r2_max=r_rdf * r_rdf,
               n_spec=n_spec, n_nucl=1, nuclei=False, grid=None)
    return cfg, rdf, pos, types


if __name__ == "__main__":
    import sys
    dest = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "examples", "surkov_cluster")
    name = os.path.basename(os.path.normpath(dest))
    if name == "liquid_argon":
        write_liquid_argon_deck(dest)
    elif name == "argon_gas":
        write_argon_gas_deck(dest)
    else:
        write_surkov_cluster_deck(dest)
