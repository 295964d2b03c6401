"""Total-energy drift of a run from its stat.dat.

    python -m aztotmd_tpu_torch.drift OUT/stat.dat [--equil STEPS]

Reads the engTot column of every row and prints, as one JSON line, the
relative drift (last row's engTot minus the reference, over |reference|)
and the largest relative deviation from the reference, where the
reference is the first row at or after ``--equil`` steps (default 0: the
first row).  For an NVE deck (``systems.write_argon_nve_deck``, the deck
of ``tools/make_nve_deck.py``) this is the energy conservation of the
integrator in the run's precision.
"""

from __future__ import annotations

import argparse
import json


def read_stat(path):
    """(steps, engTot) of stat.dat's rows (two header lines)."""
    steps, tot = [], []
    with open(path) as f:
        for line in f.readlines()[2:]:
            v = line.split()
            steps.append(int(float(v[1])))
            tot.append(float(v[2]))
    return steps, tot


def energy_drift(path, equil: int = 0) -> dict:
    """{"ref_step", "ref", "last_step", "last", "rel_drift",
    "rel_max_dev", "rows"} of stat.dat at ``path``."""
    steps, tot = read_stat(path)
    k = next(i for i, s in enumerate(steps) if s >= equil)
    e0 = tot[k]
    return {"ref_step": steps[k], "ref": e0, "last_step": steps[-1],
            "last": tot[-1], "rel_drift": (tot[-1] - e0) / abs(e0),
            "rel_max_dev": max(abs(e - e0) for e in tot[k:]) / abs(e0),
            "rows": len(tot) - k}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m aztotmd_tpu_torch.drift",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("stat", help="stat.dat of a run")
    ap.add_argument("--equil", type=int, default=0,
                    help="steps before the reference row")
    args = ap.parse_args(argv)
    res = energy_drift(args.stat, args.equil)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
