"""CUDA-graph launches a thousand window steps: the ``graph:<program>``
counters of the runner's record of the window's unprofiled stretch
(``runtime/graph.py::launch_counts``: ``Program.replay(n)`` adds n),
summed over the programs.  Null where the program keeps no such record."""

from mdbench.records import window_record

META = {"unit": "launches/kstep", "better": "lower",
        "source": "program_counter", "layer": "CUDA graphs",
        "moves": "ns_per_day", "workloads": None}


def read(ctx):
    rec = window_record(ctx)
    if rec is None:
        return None
    n = sum(v for k, v in rec["counters"].items() if k.startswith("graph:"))
    return n * 1000.0 / rec["steps"]
