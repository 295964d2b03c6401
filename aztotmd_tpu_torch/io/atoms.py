"""atoms.xyz reader and writers (the port's copy of
``aztotmd_tpu/io/atoms.py``, without the JAX package's native row parser:
rows are split in Python).

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


def write_atoms(path, names, pos, box) -> None:
    """Write an .xyz configuration (reference: out_md.cpp:65-87 format —
    ``%s\\t%f\\t%f\\t%f`` rows after the count and box lines)."""
    pos = np.asarray(pos, dtype=np.float64)
    with open(path, "w") as f:
        f.write(f"{len(names)}\n")
        f.write("%d %f %f %f\n" % (BOX_RECT, box[0], box[1], box[2]))
        for nm, (x, y, z) in zip(names, pos):
            f.write("%s\t%f\t%f\t%f\n" % (nm, x, y, z))


def write_velocities(path, spec_names, types, vel) -> None:
    """velocities.dat writer (reference: out_md.cpp:126-194
    ``out_velocities``): columns grouped by species, |v| then components."""
    vel = np.asarray(vel, dtype=np.float64)
    types = np.asarray(types)
    nsp = len(spec_names)
    per_spec = [np.nonzero(types == t)[0] for t in range(nsp)]
    mx = max((len(ix) for ix in per_spec), default=0)
    speed = np.sqrt((vel * vel).sum(axis=1))
    with open(path, "w") as f:
        f.write("No")
        for nm in spec_names:
            f.write(f"\t{nm}\tx\ty\tz")
        f.write("\n")
        for i in range(mx):
            f.write(str(i + 1))
            for t in range(nsp):
                ix = per_spec[t]
                if i < len(ix):
                    a = ix[i]
                    f.write("\t%f\t%f\t%f\t%f"
                            % (speed[a], vel[a, 0], vel[a, 1], vel[a, 2]))
                else:
                    f.write("\t\t\t\t")
            f.write("\n")
