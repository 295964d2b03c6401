"""Tiny copies of the benchmark's tree for CPU tests: the same files with
the configurations cut to a few hundred atoms, so that a whole run with
its check takes seconds."""

import json
import os
import shutil

from mdbench import registry

SIZES = {"surkov_cluster_cs2": 256, "argon_gas_cs1": 600}
# the size of a configuration that SIZES does not list (a lattice takes
# the nearest cube)
DEFAULT_SIZE = 512

# A test-only Nose-Hoover liquid: 512 Ar at 0.021 A^-3 (liquid argon near
# its boiling point), LJ eps 0.01006 eV and sigma 3.3952 A cut at 8.5 A,
# Nose-Hoover at 90 K with tau 0.5 ps, from a jittered lattice, with the
# control and field text of examples/liquid_argon.
LIQUID_CONFIG = {
    "name": "liquid_argon_tiny",
    "source": "examples/liquid_argon cut to 512 atoms",
    "why": "a test: LJ liquid under Nose-Hoover from a lattice start",
    "reduced": ["n_atoms"],
    "precision": "float32",
    "generator": "lattice",
    "generator_params": {"n_atoms": 512, "density": 0.021, "jitter": 0.05,
                         "species": "Ar"},
    "decks": {"published": {
        "control": "timestep 0.001 ps\nnstep 10000\nnequil 500\n"
                   "eqfreq 100\ntemperature 90.0\tnose\t0.5\n"
                   "init_vel\tgaus\n\npermittivity 1.0\nelec\tnone\n\n"
                   "rdf\t10.0 0.05\t200\t0\t-nucl\nstat\t200\n",
        "field": "spec 1\nAr\tAr\t39.948\t0.0\t0.0\nred-ox 0\nvdw 1\n"
                 "Ar\tAr\tlnjs\t8.5\t0.01006\t3.3952\n"}},
}
LIQUID_CELL = {
    "config": "liquid_argon_tiny", "traffic": "published", "chips": 1,
    "why": "a test", "steps_per_second": 2000,
    # set by PERF.md's rule, lower^0.4 x upper^0.6 rounded down, from CPU
    # readings of this tiny cell: lower the largest of 12 sound seeds,
    # upper the least of the bfloat16 control on 4 of them
    "limits": {"start": 2e-05, "pos_A": 8e-04, "vel": 4e-05,
               "force": 9e-04, "energy": 1e-05, "tstat": 2e-05,
               "rdf": 5e-04, "rows": 0},
}
LIQUID = "lj_liquid_tiny"


def tiny_size(name, cfg):
    n = SIZES.get(name, DEFAULT_SIZE)
    if cfg["generator"] == "lattice":
        n = round(n ** (1.0 / 3.0)) ** 3
    return n


def tiny_root(dst, liquid=False):
    """A copy of the benchmark's tree at ``dst`` with tiny sizes; with
    ``liquid``, also the test-only Nose-Hoover liquid, cell ``LIQUID``."""
    shutil.copytree(registry.ROOT, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    if liquid:
        for kind, name, obj in (("configs", LIQUID_CONFIG["name"],
                                 LIQUID_CONFIG),
                                ("workloads", LIQUID, LIQUID_CELL)):
            with open(os.path.join(dst, kind, name + ".json"), "w") as f:
                json.dump(obj, f)
    cdir = os.path.join(dst, "configs")
    for fn in os.listdir(cdir):
        path = os.path.join(cdir, fn)
        with open(path) as f:
            c = json.load(f)
        c["generator_params"]["n_atoms"] = tiny_size(fn[:-5], c)
        with open(path, "w") as f:
            json.dump(c, f)
    return dst
