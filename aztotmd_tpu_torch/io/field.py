"""field.txt parser — species, pair potentials, bonds, angles, linkage.

Reproduces the reference reader semantics (reference: src/sys_init.cpp:174-484
``read_field``; src/vdw.cpp:234-308 ``read_vdw``; src/bonds.cpp:125-364
``read_bond`` and :703-729 ``read_linkage``; src/angles.cpp:78-131
``read_angle``) on top of the C-scanf-compatible scanner, so that reference
decks parse to identical numbers.  Everything here is host-side, double
precision, plain Python — the device pytrees are built from these specs in
``aztotmd_tpu.core.field``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from .. import units
from .cscan import CScan

# pair-potential type ids (reference: src/vdw.cpp:192-196 vdw_abbr order)
VDW_NONE = 0
VDW_LJ = 1          # "lnjs"  U = 4e[(s/r)^12 - (s/r)^6]
VDW_BUCK = 2        # "buck"  U = A exp(-r/ro) - C/r^6
VDW_746 = 3         # "p746"  U = A/r^7 - B/r^4 - C/r^6
VDW_BHM = 4         # "bmhs"  U = A exp[B(s-r)] - C/r^6 - D/r^8
VDW_ELIN = 5        # "elin"  U = A exp(-r/ro) + C*r
VDW_EINV = 6        # "einv"  U = A exp(-r/ro) - C/r
VDW_SURK = 7        # "surk"  radius-dependent Surkov potential (cuVdW.cu:236)

_VDW_ABBR = {"lnjs": VDW_LJ, "buck": VDW_BUCK, "p746": VDW_746,
             "bmhs": VDW_BHM, "elin": VDW_ELIN, "einv": VDW_EINV,
             "surk": VDW_SURK}
# number of parameters per type (vdw.cpp:195 vdw_nparam)
_VDW_NPARAM = {VDW_LJ: 2, VDW_BUCK: 3, VDW_746: 3, VDW_BHM: 5,
               VDW_ELIN: 3, VDW_EINV: 3, VDW_SURK: 4}

# bond potential type ids (reference: src/bonds.cpp:160-260)
BOND_HARM = 1       # U = 1/2 k (r-r0)^2
BOND_MORSE = 2      # U = D[1-exp(-a(r-r0))]^2 - C
BOND_PEDONE = 3     # U = D[1-exp(-a(r-r0))]^2 - C - E/r^12
BOND_BUCK = 4       # U = A exp(-r/ro) - C/r^6
BOND_E612 = 5       # U = A exp(-r/ro) - C/r^6 - D/r^8 - F/r^12

ANGLE_HCOS = 1      # U = 1/2 k (cos th - cos0)^2 (angles.cpp:108-116)

# donor/acceptor bit flags (reference: src/ejump.h:4-6)
BF_DONOR = 0
BF_ACCEPTOR = 1


@dataclass
class SpeciesSpec:
    """One atom species (reference: dataStruct.h:244-290 ``Spec``)."""
    name: str
    nuclei: int                 # index into FieldSpec.nnames
    mass: float                 # internal units (amu * M_SCALE)
    charge: float
    energy: float               # own energy (for e-jump dE)
    number: int = 0
    frozen: int = 0
    donacc: int = 0             # bit0 donor, bit1 acceptor
    oxForm: int = 0             # 1-based species index (0 = none)
    redForm: int = 0
    varNumber: int = 0
    nFreeEl: int = 0
    angleType: int = 0
    idCentral: int = 0          # CN output flags
    idCounter: int = 0
    radA: float = 0.0           # thermal-radius params (radii section)
    radB: float = 1.0
    mxEng: float = 0.0

    @property
    def charged(self) -> bool:
        return abs(self.charge) >= 1.0e-10   # sys_init.cpp:110


@dataclass
class VdWSpec:
    """One pair potential (reference: dataStruct.h:293-303 ``VdW``)."""
    type: int
    spec1: int
    spec2: int
    r2cut: float
    p0: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    p3: float = 0.0
    p4: float = 0.0
    use_radii: int = 0


@dataclass
class BondSpec:
    """One bond type (reference: dataStruct.h:321-339 ``Bond``).

    Index 0 in FieldSpec.bonds is the reserved 'empty bond'.
    """
    type: int = 0
    spec1: int = 0
    spec2: int = 0
    p0: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    p3: float = 0.0
    p4: float = 0.0
    mnEx: int = 0               # has a lower-limit mutation
    mxEx: int = 0               # has an upper-limit mutation/break
    r2min: float = 0.0
    r2max: float = 0.0
    new_type: tuple = (0, 0)    # bond type after mutation: [0] r<rmin [1] r>rmax
    new_spec1: tuple = (0, 0)
    new_spec2: tuple = (0, 0)
    hatom: int = -1             # -1 covalent; else species id of H atom
    evol: int = 0
    number: int = 0


@dataclass
class AngleSpec:
    """One valence-angle type (reference: dataStruct.h:341-346)."""
    type: int = 0
    central: int = 0
    p0: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


@dataclass
class FieldSpec:
    """Parsed force field (reference: dataStruct.h:369-412 ``Field``)."""
    species: list = dfield(default_factory=list)
    nnames: list = dfield(default_factory=list)      # nucleus names
    nnumbers: list = dfield(default_factory=list)
    pairpots: list = dfield(default_factory=list)    # list[VdWSpec]
    vdw_index: list = dfield(default_factory=list)   # nsp x nsp -> pairpot id or -1
    maxRvdw: float = 0.0
    minRvdw: float = 999999.9
    bonds: list = dfield(default_factory=list)       # list[BondSpec], [0] empty
    bond_matrix: list = dfield(default_factory=list) # nsp x nsp default bond type (+/-)
    bonding_matr: list = dfield(default_factory=list)
    bindR2matrix: list = dfield(default_factory=list)
    maxRbind: float = 0.0
    angles: list = dfield(default_factory=list)      # list[AngleSpec], [0] empty
    use_bnd: int = 0            # 0 none / 1 constant / 2 variable
    use_angl: int = 0
    use_linkage: int = 0
    has_bond_list: bool = False  # field.txt contains 'bond_list' marker
    has_angle_list: bool = False

    @property
    def nSpec(self) -> int:
        return len(self.species)

    @property
    def nPair(self) -> int:
        n = self.nSpec
        return n * (n - 1) // 2 + n

    @property
    def charged_spec(self) -> bool:
        return any(s.charged for s in self.species)

    def spec_id(self, name: str):
        for i, s in enumerate(self.species):
            if s.name == name:
                return i
        return None

    def pair_index(self, ti: int, tj: int) -> int:
        """Flattened index of an unordered species pair
        (reference: rdf.cpp:116 ``iPair = iMin*m + iMin*(1-iMin)/2 + iMax``)."""
        mn, mx = (ti, tj) if ti <= tj else (tj, ti)
        m = self.nSpec - 1
        return mn * m + mn * (1 - mn) // 2 + mx


def _read_vdw_line(sc: CScan, fld: FieldSpec, idx: int) -> VdWSpec:
    """One vdw line (reference: src/vdw.cpp:234-308 ``read_vdw``)."""
    vals = sc.scanf(" %8s %8s %8s %lf %lf %lf ")
    aname, bname, cname, rcut, p0, p1 = vals
    tp = _VDW_ABBR.get(cname)
    if tp is None:
        raise ValueError(f"Unknown potential type ({cname}) in vdw-line {idx + 1}")
    params = [p0, p1, 0.0, 0.0, 0.0]
    for i in range(2, _VDW_NPARAM[tp]):
        params[i] = sc.scanf(" %lf")[0]

    at1 = fld.spec_id(aname)
    at2 = fld.spec_id(bname)
    if at1 is None or at2 is None:
        raise ValueError(f"Unknown atom type in vdw-line: {aname} {bname} {cname}")

    rcut *= units.R_SCALE
    fld.minRvdw = min(fld.minRvdw, rcut)
    fld.maxRvdw = max(fld.maxRvdw, rcut)

    # unit scaling (vdw.cpp vdw_scale0..4 tables; all factors are 1.0 in the
    # A/ps/eV/e system except the derived LJ preparation below)
    pp = VdWSpec(type=tp, spec1=at1, spec2=at2, r2cut=rcut * rcut,
                 p0=params[0], p1=params[1], p2=params[2],
                 p3=params[3], p4=params[4])
    if tp == VDW_LJ:
        # LJ pre-scaling: p0 = 4*eps, p1 = sigma^2, p2 = 24*eps
        # (vdw.cpp:283-288)
        pp.p0 *= 4.0
        pp.p1 = pp.p1 * pp.p1
        pp.p2 = 6.0 * pp.p0
    if tp == VDW_SURK:
        pp.use_radii = 1
    return pp


def _read_bond_line(sc: CScan, fld: FieldSpec, bid: int) -> BondSpec:
    """One bond-type line (reference: src/bonds.cpp:125-364 ``read_bond``)."""
    _n, s1, s2, key = sc.scanf("%d %8s %8s %8s")
    i1, i2 = fld.spec_id(s1), fld.spec_id(s2)
    if i1 is None or i2 is None:
        raise ValueError(f"Unknown species in bonds declaration: {s1} {s2}")
    b = BondSpec(spec1=i1, spec2=i2)

    fld.bond_matrix[i1][i2] = bid
    fld.bond_matrix[i2][i1] = bid if i1 == i2 else -bid

    if key == "harm":
        b.type = BOND_HARM
        b.p0, b.p1 = sc.scanf("%lf %lf")
    elif key == "mors":
        b.type = BOND_MORSE
        b.p0, b.p1, b.p2, b.p3 = sc.scanf("%lf %lf %lf %lf")
    elif key == "pdn":
        b.type = BOND_PEDONE
        b.p0, b.p1, b.p2, b.p3, b.p4 = sc.scanf("%lf %lf %lf %lf %lf")
    elif key == "buck":
        b.type = BOND_BUCK
        b.p0, b.p1, b.p2 = sc.scanf("%lf %lf %lf")
    elif key == "e612":
        b.type = BOND_E612
        b.p0, b.p1, b.p2, b.p3, b.p4 = sc.scanf("%lf %lf %lf %lf %lf")
    else:
        raise ValueError(f"Unknown bond potential type: {key}")

    new_type = [0, 0]
    new_spec1 = [0, 0]
    new_spec2 = [0, 0]

    # lower limit (bonds.cpp:263-283)
    key = sc.scanf("%8s")[0]
    if key == "con":
        b.mnEx = 0
    elif key == "mut":
        fld.use_bnd = 2
        b.mnEx = 1
        rmin, new_type[0] = sc.scanf("%lf %d")
        b.r2min = rmin * rmin
    else:
        raise ValueError(f"Unknown lower bond limit type: {key}")

    # upper limit (bonds.cpp:286-337)
    key = sc.scanf("%8s")[0]
    if key == "con":
        b.mxEx = 0
    elif key == "mut":
        fld.use_bnd = 2
        b.mxEx = 1
        rmax, new_type[1] = sc.scanf("%lf %d")
        b.r2max = rmax * rmax
    elif key == "br":
        fld.use_bnd = 2
        b.mxEx = 1
        rmax, s1, s2 = sc.scanf("%lf %8s %8s")
        new_type[1] = 0
        b.r2max = rmax * rmax
        j1, j2 = fld.spec_id(s1), fld.spec_id(s2)
        if j1 is None or j2 is None:
            raise ValueError(f"Unknown species in break bond declaration: {s1} {s2}")
        new_spec1[1] = j1
        new_spec2[1] = j2
        if b.spec1 != j1:
            fld.species[b.spec1].varNumber = 1
            fld.species[j1].varNumber = 1
        if b.spec2 != j2:
            fld.species[b.spec2].varNumber = 1
            fld.species[j2].varNumber = 1
    else:
        raise ValueError(f"Unknown upper bond limit type: {key}")

    b.new_type = tuple(new_type)
    b.new_spec1 = tuple(new_spec1)
    b.new_spec2 = tuple(new_spec2)
    return b


def parse_field(text: str) -> FieldSpec:
    """Parse a complete field.txt (reference: sys_init.cpp:174-484)."""
    sc = CScan(text)
    fld = FieldSpec()

    # --- species ---
    n = sc.find_number(" spec %d")
    if not n:
        raise ValueError("There is no 'spec' section in the field file")
    for i in range(n):
        name, nucl, mass, charge, energy = sc.scanf("%8s %8s %lf %lf %lf")
        if nucl in fld.nnames:
            nid = fld.nnames.index(nucl)
        else:
            nid = len(fld.nnames)
            fld.nnames.append(nucl)
            fld.nnumbers.append(0)
        fld.species.append(SpeciesSpec(
            name=name, nuclei=nid, mass=mass * units.M_SCALE,
            charge=charge * units.Q_SCALE, energy=energy))

    # --- red-ox sequences (sys_init.cpp:136-238) ---
    n = sc.find_number(" red-ox %d")
    for _ in range(n):
        k, aname = sc.scanf(" %d %8s")
        at1 = fld.spec_id(aname)
        if at1 is None:
            raise ValueError(f"unknown first specie ({aname}) in red-ox line")
        fld.species[at1].varNumber = 1
        for _j in range(1, k):
            bname = sc.scanf(" %8s")[0]
            at2 = fld.spec_id(bname)
            if at2 is None:
                raise ValueError(f"unknown specie ({bname}) in red-ox line")
            fld.species[at1].donacc |= 1 << BF_ACCEPTOR
            fld.species[at2].donacc |= 1 << BF_DONOR
            fld.species[at1].redForm = at2 + 1
            fld.species[at2].oxForm = at1 + 1
            fld.species[at2].varNumber = 1
            at1 = at2
    if n:
        # count free electrons per species (sys_init.cpp:228-237)
        for s in fld.species:
            cnt, j = 0, s
            while j.oxForm and (j.donacc >> BF_DONOR) & 1:
                cnt += 1
                j = fld.species[j.oxForm - 1]
            s.nFreeEl = cnt

    # --- frozen species ---
    n = sc.find_number(" frozensp %d")
    for _ in range(n):
        aname = sc.scanf("%s")[0]
        sid = fld.spec_id(aname)
        if sid is not None:
            fld.species[sid].frozen = 1

    # --- van der Waals ---
    nsp = fld.nSpec
    fld.vdw_index = [[-1] * nsp for _ in range(nsp)]
    n = sc.find_number(" vdw %d")
    for i in range(n):
        pp = _read_vdw_line(sc, fld, i)
        fld.pairpots.append(pp)
        fld.vdw_index[pp.spec1][pp.spec2] = i
        if pp.type != VDW_SURK:      # Surkov is asymmetric (vdw.cpp:303-306)
            fld.vdw_index[pp.spec2][pp.spec1] = i

    # --- bond types ---
    n = sc.find_number(" bonds %d")
    if n:
        fld.use_bnd = max(fld.use_bnd, 1)
        fld.bond_matrix = [[0] * nsp for _ in range(nsp)]
        fld.bonding_matr = [[0] * nsp for _ in range(nsp)]
        fld.bindR2matrix = [[0.0] * nsp for _ in range(nsp)]
        fld.bonds = [BondSpec()]                 # [0] = empty bond
        for i in range(1, n + 1):
            fld.bonds.append(_read_bond_line(sc, fld, i))
        # resolve new_spec for mutable bonds (sys_init.cpp:317-352)
        for b in fld.bonds[1:]:
            ns1 = list(b.new_spec1)
            ns2 = list(b.new_spec2)
            for lim in (0, 1):
                if (lim == 0 and b.mnEx or lim == 1 and b.mxEx) and b.new_type[lim]:
                    t = b.new_type[lim]
                    ref = fld.bonds[abs(t)]
                    if t < 0:
                        ns1[lim], ns2[lim] = ref.spec2, ref.spec1
                    else:
                        ns1[lim], ns2[lim] = ref.spec1, ref.spec2
            b.new_spec1, b.new_spec2 = tuple(ns1), tuple(ns2)

    # --- evol bonds ---
    n = sc.find_number(" evol_bonds %d")
    for _ in range(n):
        j = sc.scanf("%d")[0]
        sc.match_literal("-")
        k = sc.scanf("%d")[0]
        if 1 <= j < len(fld.bonds) and 1 <= k < len(fld.bonds):
            fld.bonds[j].evol = k

    # --- h-bonds ---
    n = sc.find_number(" h-bonds %d")
    for _ in range(n):
        k, aname = sc.scanf("%d %s")
        at1 = fld.spec_id(aname)
        if (1 <= k < len(fld.bonds) and at1 is not None
                and at1 in (fld.bonds[k].spec1, fld.bonds[k].spec2)):
            fld.bonds[k].hatom = at1

    # --- angle types ---
    n = sc.find_number(" angles %d ")
    if n:
        fld.use_angl = 1
        fld.angles = [AngleSpec()]
        for i in range(1, n + 1):
            _id, s1, key, p0, p1 = sc.scanf("%d %8s %8s %lf %lf")
            sid = fld.spec_id(s1)
            if sid is None:
                raise ValueError(f"Unknown species in angle declaration: {s1}")
            if key != "hcos":
                raise ValueError(f"Unknown angle potential type: {key}")
            fld.angles.append(AngleSpec(type=ANGLE_HCOS, central=sid, p0=p0, p1=p1))

    # --- auto-forming angles ---
    n = sc.find_number(" angle_forming %d ")
    if n and fld.use_angl:
        for _ in range(n):
            aname, k = sc.scanf("%s %d")
            sid = fld.spec_id(aname)
            if sid is None:
                raise ValueError(f"wrong species ({aname}) in angle_forming")
            fld.species[sid].angleType = k
        fld.use_angl = 2

    # --- linkage (new-bond formation) ---
    n = sc.find_number(" linkage %d")
    if n and fld.bonds:
        for i in range(n):
            ion, ion2, r, k = sc.scanf("%8s %8s %lf %d")
            s1, s2 = fld.spec_id(ion), fld.spec_id(ion2)
            if s1 is None or s2 is None:
                raise ValueError(f"Unknown species in linkage: {ion} {ion2}")
            fld.bonding_matr[s1][s2] = k
            fld.bonding_matr[s2][s1] = -k
            fld.bindR2matrix[s1][s2] = r * r
            fld.bindR2matrix[s2][s1] = r * r
            fld.maxRbind = max(fld.maxRbind, r)
        fld.use_bnd = 2
        fld.use_linkage = 1

    # --- variable radii (radiative thermostat / Surkov) ---
    if sc.find(" radii %d") is not None:
        for _ in range(fld.nSpec):
            aname = sc.scanf("%s")[0]
            sid = fld.spec_id(aname)
            if sid is None:
                raise ValueError(f"wrong species ({aname}) in radii section")
            radA, radB, mxEng = sc.scanf("%lf %lf %lf")
            sp = fld.species[sid]
            sp.radA, sp.radB, sp.mxEng = radA, radB, mxEng

    # markers consumed by read_sim (sys_init.cpp:627-673)
    fld.has_bond_list = sc.find(" bond_list %d") is not None
    fld.has_angle_list = sc.find(" angle_list %d") is not None

    return fld


def parse_field_file(path) -> FieldSpec:
    with open(path, "r", errors="replace") as f:
        return parse_field(f.read())
