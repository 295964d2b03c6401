"""bonds.txt / angles.txt readers and writers (the port's copy of
``aztotmd_tpu/io/toplists.py``).

Formats (reference: src/bonds.cpp:25-123 ``read_bondlist``/``save_bondlist``;
src/angles.cpp:22-75 ``read_anglelist``/``save_anglelist``):

    bonds.txt:   <nBonds> then per line "<at1> <at2> <type>"
    angles.txt:  <nAngles> then per line "<central> <lig1> <lig2> <type>"

``read_bondlist`` additionally orients each bond so that
``types[at1] == bond.spec1`` (swapping at1/at2 when needed), counts
per-atom bonds and sets parents — we reproduce that here on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from .cscan import CScan


@dataclass
class BondList:
    at1: np.ndarray             # (nB,) int32
    at2: np.ndarray
    btype: np.ndarray           # bond-type id (index into FieldSpec.bonds)
    nbonds: np.ndarray          # per-atom covalent bond count (N,)
    parents: np.ndarray         # per-atom partner (N,), -1 when none

    @property
    def n_bonds(self) -> int:
        return len(self.at1)


def parse_bondlist(text: str, atom_types, bond_specs) -> BondList:
    """``atom_types``: (N,) species id per atom; ``bond_specs``: list of
    BondSpec where index 0 is the empty bond."""
    sc = CScan(text)
    n = sc.scanf("%d")[0]
    n_at = len(atom_types)
    at1 = np.zeros(n, dtype=np.int32)
    at2 = np.zeros(n, dtype=np.int32)
    bt = np.zeros(n, dtype=np.int32)
    nbonds = np.zeros(n_at, dtype=np.int32)
    parents = np.full(n_at, -1, dtype=np.int32)
    toks = sc.text[sc.pos:].split()
    if len(toks) < 3 * n:
        raise ValueError("bonds.txt truncated")
    for i in range(n):
        a1 = int(toks[3 * i])
        a2 = int(toks[3 * i + 1])
        k = int(toks[3 * i + 2])
        b = bond_specs[k]
        # orient the bond so types[at1] == spec1 (bonds.cpp:50-79)
        if b.spec1 == atom_types[a1]:
            if b.spec2 != atom_types[a2]:
                raise ValueError(f"incorrect type of 2nd atom in bond "
                                 f"(type {k}, line {i})")
        elif b.spec1 == atom_types[a2]:
            if b.spec2 != atom_types[a1]:
                raise ValueError(f"incorrect type of 1st atom in bond "
                                 f"(type {k}, line {i})")
            a1, a2 = a2, a1
        else:
            raise ValueError(f"incorrect types of atoms for bond type {k} "
                             f"in bond list, line {i}")
        at1[i], at2[i], bt[i] = a1, a2, k
        if b.hatom == -1:       # usual (covalent) bond
            nbonds[a1] += 1
            nbonds[a2] += 1
            parents[a1] = a2
            parents[a2] = a1
        else:                   # H-bond: only the H atom gets a parent
            if atom_types[a1] == b.hatom:
                parents[a1] = a2
            else:
                parents[a2] = a1
    return BondList(at1=at1, at2=at2, btype=bt, nbonds=nbonds, parents=parents)


def parse_bondlist_file(path, atom_types, bond_specs) -> BondList:
    with open(path, "r", errors="replace") as f:
        return parse_bondlist(f.read(), atom_types, bond_specs)


@dataclass
class AngleList:
    central: np.ndarray         # (nA,) int32
    lig1: np.ndarray
    lig2: np.ndarray
    atype: np.ndarray

    @property
    def n_angles(self) -> int:
        return len(self.central)


def parse_anglelist(text: str, atom_types=None, angle_specs=None) -> AngleList:
    sc = CScan(text)
    n = sc.scanf("%d")[0]
    c = np.zeros(n, dtype=np.int32)
    l1 = np.zeros(n, dtype=np.int32)
    l2 = np.zeros(n, dtype=np.int32)
    at = np.zeros(n, dtype=np.int32)
    toks = sc.text[sc.pos:].split()
    if len(toks) < 4 * n:
        raise ValueError("angles.txt truncated")
    for i in range(n):
        c[i] = int(toks[4 * i])
        l1[i] = int(toks[4 * i + 1])
        l2[i] = int(toks[4 * i + 2])
        x = int(toks[4 * i + 3])
        if angle_specs is not None and not (0 < x < len(angle_specs)):
            raise ValueError(f"wrong angle type number in angles.txt line {i}")
        at[i] = x
        if (atom_types is not None and angle_specs is not None
                and atom_types[c[i]] != angle_specs[x].central):
            raise ValueError(f"wrong central atom type in angle list "
                             f"(position {i})")
    return AngleList(central=c, lig1=l1, lig2=l2, atype=at)


def parse_anglelist_file(path, atom_types=None, angle_specs=None) -> AngleList:
    with open(path, "r", errors="replace") as f:
        return parse_anglelist(f.read(), atom_types, angle_specs)


def write_bondlist(path, at1, at2, btype) -> None:
    """save_bondlist format (bonds.cpp:112-123)."""
    with open(path, "w") as f:
        f.write(f"{len(at1)}\n")
        for a, b, k in zip(at1, at2, btype):
            f.write(f"{int(a)} {int(b)} {int(k)}\n")


def write_anglelist(path, central, lig1, lig2, atype) -> None:
    with open(path, "w") as f:
        f.write(f"{len(central)}\n")
        for c, a, b, k in zip(central, lig1, lig2, atype):
            f.write(f"{int(c)} {int(a)} {int(b)} {int(k)}\n")
