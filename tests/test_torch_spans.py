"""The runner's spans and records, the graphs' launch counts and the
idle-by-span reduction (``aztotmd_tpu_torch/utils/profiling.py``,
``runtime/runner.py``, ``runtime/graph.py``), on the CPU.

A span reads the host's clock and never waits on the card; ``MDRunner``
always records its spans ``steps``, ``wait`` and ``sampling``, which never
nest, and keeps one record a ``run()`` call; a span is a profiler range
only while a profiler records; ``Program.replay(n)`` counts n launches of
its program; ``trace()``'s reduction labels each idle gap of the card by
the innermost span the host was in."""

import ast
import dataclasses
import inspect
import os

import pytest
import torch

from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.runtime import graph as graph_mod
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.utils import profiling

torch.set_num_threads(1)

SPANS = set(profiling.SPANS)


@pytest.fixture(scope="module")
def ring_deck(tmp_path_factory):
    """200 Surkov atoms with a stat row every 20 steps and an RDF sample
    every 10: the stat ring's plan."""
    d = str(tmp_path_factory.mktemp("surkov200"))
    systems.write_surkov_cluster_deck(d, n_atoms=200, box=18.0, steps=100,
                                      n_equil=20)
    path = os.path.join(d, "control.txt")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("stat\t200", "stat\t20"))
    return d


def _runner(deck, tmp_path, monkeypatch, **kw):
    """A runner on the CPU whose ring windows are one stat period."""
    monkeypatch.setenv("AZTOTMD_RING_STEPS", "20")
    r = MDRunner(load_deck_dir(deck, device="cpu"),
                 out_dir=str(tmp_path / "out"), quiet=True, **kw)
    assert r.ring_ok and r.p_stat == 20 and r.s_cap == 1
    return r


def _raise(*a, **k):
    raise AssertionError("called")


def test_spans_never_synchronise(ring_deck, tmp_path, monkeypatch, capfd):
    """With every way to wait on the card made to raise, a run with its
    report finishes; ``utils/profiling.py`` calls no ``synchronize`` and
    no stream, and its spans take no tensor to wait on."""
    for holder, name in ((torch.cuda, "synchronize"),
                         (torch.cuda, "current_stream"),
                         (torch.cuda.Event, "synchronize"),
                         (torch.cuda.Stream, "synchronize")):
        monkeypatch.setattr(holder, name, _raise)
    r = _runner(ring_deck, tmp_path, monkeypatch, profile=True)
    r.run(60)
    assert int(r.state.step) == 60
    assert "\nsteps " in capfd.readouterr().err
    tree = ast.parse(inspect.getsource(profiling))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)}
    assert not called & {"synchronize", "current_stream", "wait_stream",
                         "block_until_ready"}
    assert list(inspect.signature(
        profiling.StageTimer.stage).parameters) == ["self", "name"]


def test_one_record_per_call(ring_deck, tmp_path, monkeypatch):
    """One record a ``run()`` call: its steps, spans that never nest (so
    their sum is within the wall, and ``other`` the rest), a ``steps``
    span a ring window, a ``wait`` a flush and the closing one, a
    ``sampling`` a flush and a host event; the counters; the pair pass
    in words (the Surkov deck's dense pass, K1's plain version on the
    CPU), also in the report; the last ``KEEP_CALLS`` kept."""
    r = _runner(ring_deck, tmp_path, monkeypatch)
    for end in (40, 100):
        n0, f0 = r.n_dispatch, r.n_flush
        start = int(r.state.step)
        r.run(end)
        rec = r.timer.calls[-1]
        assert set(rec) == {"steps", "wall_s", "spans", "counters",
                            "pair_pass"}
        assert rec["pair_pass"] == "allpairs (the plain version of K1)"
        assert rec["steps"] == end - start
        assert set(rec["spans"]) == SPANS
        windows, flushes = r.n_dispatch - n0, r.n_flush - f0
        assert windows == (end - start) // 20 == flushes
        assert rec["spans"]["steps"][1] == windows
        assert rec["spans"]["wait"][1] == flushes + 1
        assert rec["spans"]["sampling"][1] == flushes + 1
        busy = sum(t for t, _ in rec["spans"].values())
        assert 0 < busy <= rec["wall_s"]
        other = rec["wall_s"] - busy
        assert other < 0.5 * rec["wall_s"]
        assert rec["counters"]["regrow"] == 0
        assert rec["counters"]["captures"] == 0
        lines = r.timer.report().splitlines()
        assert lines[0].startswith("stage ")
        row = next(ln.split() for ln in lines if ln.startswith("other "))
        assert float(row[1]) == pytest.approx(other, abs=1e-3)
        assert any(ln.split()[:2] == ["regrow", "0"] for ln in lines)
        assert lines[-1].split(None, 1) == ["pair_pass", rec["pair_pass"]]
    assert len(r.timer.calls) == 2
    for k in range(profiling.KEEP_CALLS + 2):
        r.run(120 + 20 * k)
    assert len(r.timer.calls) == profiling.KEEP_CALLS
    assert [c["steps"] for c in r.timer.calls] == [20] * profiling.KEEP_CALLS
    assert int(r.state.step) == 120 + 20 * (profiling.KEEP_CALLS + 1)


def test_regrow_is_counted(tmp_path, monkeypatch):
    """A neighbor capacity below what the deck needs regrows inside the
    call (the flush at its end reads the monitor): ``regrow`` 1."""
    deck = str(tmp_path / "lj")
    os.makedirs(deck)
    systems.write_lj_deck(deck)
    p = load_deck_dir(deck, device="cpu")
    c = p["cfg"] = dataclasses.replace(p["cfg"], n_neigh=4)
    N = c.n_at
    p["state"] = p["state"].replace(
        nbr_idx=torch.full((N, 4), N, dtype=torch.int32),
        nbrow_idx=torch.full((c.nb_rowcap, 5), N, dtype=torch.int32))
    r = MDRunner(p, out_dir=str(tmp_path / "out"), quiet=True)
    assert r.ring_ok and r.cfg.pair_engine == "neighbor"
    r.run(r.p_stat)
    assert r.cfg.n_neigh > 4
    assert r.timer.calls[-1]["counters"]["regrow"] == 1
    r.run(2 * r.p_stat)
    assert r.timer.calls[-1]["counters"]["regrow"] == 0


def test_no_range_without_a_profiler(ring_deck, tmp_path, monkeypatch):
    """With every way to open a profiler range made to raise, a run
    finishes: no span enters one while no profiler records."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise,
                        raising=False)
    monkeypatch.setattr(profiling, "profiler_range", _raise)
    r = _runner(ring_deck, tmp_path, monkeypatch)
    r.run(40)
    assert int(r.state.step) == 40


def test_spans_are_profiler_ranges(ring_deck, tmp_path, monkeypatch,
                                   capfd):
    """Under torch.profiler on the CPU the profiler's events hold host
    ranges named ``steps``, ``wait`` and ``sampling``, as many as the
    record's calls; ``trace()`` writes its trace and the idle table."""
    from torch.profiler import ProfilerActivity, profile
    r = _runner(ring_deck, tmp_path, monkeypatch)
    r.run(20)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.run(60)
    names = [e.name for e in prof.events()]
    rec = r.timer.calls[-1]
    for s in SPANS:
        assert names.count(s) == rec["spans"][s][1], s
    with profiling.trace(str(tmp_path / "trace")):
        r.run(80)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert "idle by span" in capfd.readouterr().err


class _Graph:
    """A stand-in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _program(name):
    prog = graph_mod.Program.__new__(graph_mod.Program)
    prog.name, prog.graph = name, _Graph()
    prog.per_replay, prog._counters = [], []
    return prog


def test_replay_counts_launches():
    """``Program.replay(n)`` launches its graph n times and adds n to
    ``launch_counts["graph:<name>"]``; under a profiler the call is a
    range of that name."""
    from torch.profiler import ProfilerActivity, profile
    prog = _program("stand-in")
    key = "graph:stand-in"
    before = graph_mod.launch_counts.get(key, 0)
    prog.replay(7)
    prog.replay()
    assert prog.graph.replays == 8
    assert graph_mod.launch_counts[key] == before + 8
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.replay(3)
    assert [e.name for e in prof.events()].count(key) == 1
    assert graph_mod.launch_counts[key] == before + 11


def test_idle_by_span_on_hand_made_events():
    """Gaps between device events (overlapping ones merged) labelled by
    the innermost span or graph range running when each began; a host
    event that is no span labels nothing; ``other`` outside every span."""
    ev = [
        # device: busy 0-10, 15-20, 30-40 (two overlapping), 41-50,
        # 60-70, 80-90
        (True, "k", 0.0, 10.0), (True, "k", 15.0, 20.0),
        (True, "k", 30.0, 38.0), (True, "k", 32.0, 40.0),
        (True, "k", 41.0, 50.0), (True, "k", 60.0, 70.0),
        (True, "k", 80.0, 90.0),
        # host: a window's enqueue with a replay inside, then the wait
        (False, "steps", 0.0, 35.0), (False, "graph:step", 12.0, 33.0),
        (False, "cudaGraphLaunch", 19.0, 21.0),
        (False, "wait", 38.0, 55.0), (False, "sampling", 56.0, 65.0),
        (False, "aten::detach", 69.0, 75.0),
    ]
    idle = profiling.idle_by_span(ev)
    assert idle == {"steps": [pytest.approx(5e-6), 1],
                    "graph:step": [pytest.approx(10e-6), 1],
                    "wait": [pytest.approx(11e-6), 2],
                    "other": [pytest.approx(10e-6), 1]}
    assert profiling.idle_by_span([(False, "steps", 0.0, 1.0)]) == {}
    table = profiling.idle_report(idle).splitlines()
    assert table[1].split()[0] in ("graph:step", "wait")
    assert len(table) == 5
