"""atoms.xyz reader (the port's copy of ``aztotmd_tpu/io/atoms.py``'s
parser, without the JAX package's native row parser: rows are split in
Python).

Format (reference: src/sys_init.cpp:487-566 ``read_atoms_box``,
src/box.cpp:9-27 ``read_box``, src/out_md.cpp:65-87 ``out_atoms``):

    <nAt>
    <box type=1> <la> <lb> <lc>
    <name> <x> <y> <z>
    ...

Only the rectangular box (type 1) exists in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cscan import CScan

BOX_RECT = 1


@dataclass
class AtomsData:
    """Host-side atom configuration in double precision."""
    names: list                 # species name per atom (as read)
    pos: np.ndarray             # (N, 3) float64
    box: tuple                  # (la, lb, lc)
    box_type: int = BOX_RECT

    @property
    def n_atoms(self) -> int:
        return len(self.names)


def parse_atoms(text: str) -> AtomsData:
    sc = CScan(text)
    n = sc.scanf("%d")[0]
    box_type = sc.scanf("%d")[0]
    if box_type != BOX_RECT:
        raise ValueError(f"Unknown box type: {box_type}")
    la, lb, lc = sc.scanf("%lf %lf %lf")
    names = []
    pos = np.empty((n, 3), dtype=np.float64)
    # the reference scans "%s %lf %lf %lf" per atom; a simple split is
    # equivalent for well-formed decks and much faster for 1e5+ atoms
    toks = sc.text[sc.pos:].split()
    if len(toks) < 4 * n:
        raise ValueError("atoms.xyz truncated")
    for i in range(n):
        names.append(toks[4 * i])
        pos[i, 0] = float(toks[4 * i + 1])
        pos[i, 1] = float(toks[4 * i + 2])
        pos[i, 2] = float(toks[4 * i + 3])
    return AtomsData(names=names, pos=pos, box=(la, lb, lc))


def parse_atoms_file(path) -> AtomsData:
    with open(path, "r", errors="replace") as f:
        return parse_atoms(f.read())
