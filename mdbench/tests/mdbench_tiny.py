"""Tiny copies of the benchmark's tree for CPU tests: the same files with
the configurations cut to a few hundred atoms, so that a whole run with
its check takes seconds."""

import json
import os
import shutil

from mdbench import registry

SIZES = {"surkov_cluster_cs2": 256, "argon_gas_cs1": 600}


def tiny_root(dst):
    """A copy of the benchmark's tree at ``dst`` with tiny sizes."""
    shutil.copytree(registry.ROOT, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, n in SIZES.items():
        path = os.path.join(dst, "configs", name + ".json")
        with open(path) as f:
            c = json.load(f)
        c["generator_params"]["n_atoms"] = n
        with open(path, "w") as f:
            json.dump(c, f)
    return dst
