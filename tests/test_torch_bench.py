"""The port's headline bench (``aztotmd_tpu_torch/bench.py``) on the CPU,
eager, at a tiny chunk on small in-tree decks: one JSON line per deck on
standard output with exactly bench.py's four keys, its ``#`` line on
standard error, and exit 1 (after the other decks ran) when a deck
fails; and the energy-drift reader (``aztotmd_tpu_torch/drift.py``) that
the NVE measurements use."""

import json
import os

import pytest
import torch

from aztotmd_tpu_torch import bench, systems

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--eager", "--chunk", "4", "--windows", "2"]


@pytest.fixture(scope="module")
def gas(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bench_gas"))
    systems.write_argon_gas_deck(d, n_atoms=300, steps=100)
    return d


@pytest.fixture(autouse=True)
def short_cli(monkeypatch):
    """10 runner steps for the CLI rate (1,000 on the card)."""
    monkeypatch.setattr(bench, "CLI_STEPS", 10)


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def test_bench_deck_prints_four_keys(gas, capsys):
    recs = bench.main(["--deck", gas] + ARGS, device="cpu")
    out, err = capsys.readouterr()
    lines = _lines(out)
    assert len(lines) == 1 == len(recs)
    line = lines[0]
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "steps_per_sec_custom_deck"
    assert line["unit"] == "steps/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / bench.BASELINE_STEPS_PER_SEC, abs=1e-3)
    rec = recs[0]
    assert rec["line"] == line and rec["mode"] == "eager"
    assert rec["n_at"] == 300 and rec["engine"] == "neighbor"
    assert len(rec["windows"]) == 2 and rec["chunk"] == 4
    assert rec["cli_steps_per_sec"] > 0 and rec["rdf_sample_ms"] > 0
    assert rec["graph_steps_per_sec"] is None     # no graphs on the CPU
    head = [ln for ln in err.splitlines() if ln.startswith("# deck=")]
    assert len(head) == 1
    for key in ("mode=eager", "ns/day=", "windows=", "chunk=4", "n_at=300",
                "engine=neighbor", "card='cpu'", "CLI steps/s=",
                "replayed RDF sample ms="):
        assert key in head[0], key


def test_bench_names_the_rdf_plan(tmp_path, capsys):
    """The ``#`` line names the runner's RDF plan and times its sampler
    beside the cell-candidate one: a 1,000-atom gas at 3e-4 atoms/A^3
    samples from the outer Verlet list (JAX's ``rdf_from_outer``),
    examples/bonded_fluid from all pairs (no RDF list)."""
    dilute = str(tmp_path / "gas1k")
    systems.write_argon_gas_deck(dilute, n_atoms=1000, density=3e-4,
                                 steps=100)
    recs = bench.main(["--deck", dilute] + ARGS, device="cpu")
    recs += bench.main(["--deck", os.path.join(ROOT, "examples",
                                               "bonded_fluid")] + ARGS,
                       device="cpu")
    err = capsys.readouterr().err
    assert [r["rdf_plan"] for r in recs] == ["from_outer", "cells"]
    assert recs[0]["rdf_plan_sample_ms"] > 0 and recs[0]["rdf_sample_ms"] > 0
    assert recs[1]["rdf_plan_sample_ms"] is None
    assert all(r["cli_rebuilds"] >= 1 for r in recs)
    head = [ln for ln in err.splitlines() if ln.startswith("# deck=")]
    assert "rdf_plan=from_outer" in head[0] and "rdf_plan=cells" in head[1]
    assert "rdf_plan_sample_ms=null" in head[1]


def test_failing_deck_exits_1_after_the_others(gas, tmp_path, capsys,
                                               monkeypatch):
    """A deck that cannot load prints its traceback; the other deck still
    prints its line; the bench exits 1."""
    monkeypatch.setattr(bench, "DECKS", [
        ("steps_per_sec_missing", str(tmp_path / "missing")),
        ("steps_per_sec_gas", gas)])
    with pytest.raises(SystemExit) as e:
        bench.main(ARGS, device="cpu")
    assert e.value.code == 1
    out, err = capsys.readouterr()
    assert [ln["metric"] for ln in _lines(out)] == ["steps_per_sec_gas"]
    assert "Traceback" in err


def test_default_decks_are_in_tree():
    """argon_gas first (case study 1's shape), then surkov_cluster."""
    assert [m for m, _ in bench.DECKS] == [
        "steps_per_sec_argon_gas_40k_ar_lj",
        "steps_per_sec_surkov_cluster_4k_surkov"]
    for _, deck in bench.DECKS:
        assert os.path.commonpath([deck, ROOT]) == ROOT
        for name in ("atoms.xyz", "control.txt", "field.txt"):
            assert os.path.exists(os.path.join(deck, name))


def test_bench_without_a_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--deck", "x"])
    assert "no CUDA device" in str(e.value.code)


def test_energy_drift_reads_stat_dat(tmp_path, capsys):
    """``python -m aztotmd_tpu_torch.drift``: the relative drift and the
    largest relative deviation of engTot from the first row at or after
    ``--equil`` steps."""
    from aztotmd_tpu_torch import drift
    path = tmp_path / "stat.dat"
    rows = [(200, 100.0), (400, 100.5), (600, 99.0), (800, 101.0)]
    path.write_text("time\tstep\tengTot\nps\tn\teV\n" + "".join(
        f"{s * 0.001:.3f}\t{s}\t{e:.6f}\t1.0\n" for s, e in rows))
    res = drift.main([str(path), "--equil", "300"])
    assert res["ref_step"] == 400 and res["last_step"] == 800
    assert res["rel_drift"] == pytest.approx(0.5 / 100.5)
    assert res["rel_max_dev"] == pytest.approx(1.5 / 100.5)
    assert res["rows"] == 3
    assert json.loads(capsys.readouterr().out) == res
