"""The readers of the runner's record (``mdbench/records.py``: graph
launches, the ``steps`` and ``sampling`` spans a thousand steps) on the
CPU: finite from a tiny traced cell's records, null where the record
before the last is of other steps or the program keeps no records."""

import math
import time
from types import SimpleNamespace

import pytest

from mdbench import harness, registry
from mdbench import trace as trace_mod

from .mdbench_tiny import tiny_root

NAMES = ("graph_launches_per_kstep", "enqueue_ms_per_kstep",
         "sampling_ms_per_kstep")


def _readers():
    mods = registry.metric_modules()
    return {n: mods[n] for n in NAMES}


@pytest.mark.parametrize("cell", ["cs2_surkov_4k", "cs1_argon_40k"])
def test_readers_of_a_tiny_traced_cell(tmp_path, monkeypatch, cell):
    """A traced run on the CPU (the profiler's stretch run unprofiled, as
    the CPU has no device trace): the three read finite values from the
    window's record; on the CPU no program is a graph."""
    root = tiny_root(str(tmp_path / "root"))
    monkeypatch.setattr(trace_mod, "profile", lambda fn, dev: (
        fn(), trace_mod.reduce_events([], 0.0))[1])
    monkeypatch.setattr(registry, "metrics_for",
                        lambda cell, root=None: _readers())
    res = harness.run_cell(cell, 3, 0.1, True, "cpu", time.perf_counter(),
                           root=root)
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["layer"].items()}
    assert set(got) == set(NAMES)
    assert all(math.isfinite(v) for v in got.values()), got
    assert got["graph_launches_per_kstep"] == 0.0
    assert got["enqueue_ms_per_kstep"] > got["sampling_ms_per_kstep"] > 0


def _ctx(calls, win_steps=1000):
    timer = SimpleNamespace(calls=calls)
    return SimpleNamespace(runner=SimpleNamespace(timer=timer),
                           win_steps=win_steps)


def test_readers_of_a_record():
    rec = {"steps": 2000, "wall_s": 2.0,
           "spans": {"steps": [1.2, 2], "wait": [0.5, 3],
                     "sampling": [0.01, 3]},
           "counters": {"regrow": 0, "captures": 0, "graph:step": 2000,
                        "graph:row": 10, "graph:ring_reset": 2}}
    last = dict(rec, steps=1000)
    r = _readers()
    ctx = _ctx([rec, last], win_steps=2000)
    assert r["graph_launches_per_kstep"].read(ctx) == pytest.approx(1006.0)
    assert r["enqueue_ms_per_kstep"].read(ctx) == pytest.approx(600.0)
    assert r["sampling_ms_per_kstep"].read(ctx) == pytest.approx(5.0)
    no_sampling = dict(rec, spans={"steps": [1.2, 2]})
    assert r["sampling_ms_per_kstep"].read(
        _ctx([no_sampling, last], 2000)) == 0.0
    for ctx in (_ctx([rec, last], win_steps=1000), _ctx([last]),
                _ctx([]),
                SimpleNamespace(runner=SimpleNamespace(
                    timer=SimpleNamespace(total={}, count={})),
                    win_steps=2000)):
        assert all(m.read(ctx) is None for m in r.values())
