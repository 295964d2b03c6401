"""The port's stat-period plan (``MDRunner._ring_plan``, the JAX stat
ring's RDF-list plan) against the JAX package's runner with its on-device
stat ring.

- The plan dict equals JAX's on every ``examples/`` deck and on the NVE,
  dilute and 2^3 tool decks (``systems.py``).
- Each regime end to end, on a small argon gas on which JAX's plan shows
  it: ``rdf_from_outer`` (its superblocks, and a window of 5 periods cut
  4 + 1, as examples/argon_gas's 1,000-step run), ``rdf_covers_outer``,
  ``refine_blocks`` with the RDF list and neither of those, the RDF list
  on engines without a Verlet list ("gather", "block").  f64: rdf.dat
  within rtol
  1e-8 of the ring's, final positions within 1e-12 A, the
  full rebuilds and refines (``runtime/step.py::nbr_counts``) and the
  samples of each RDF sampler (``ops/rdf.py::rdf_counts``) those that
  JAX's windows and superblocks imply.  (The ring packs its stat rows
  in f32: stat.dat is held to half an f32 ulp.)
- A forced small ``k_cap`` regrows with JAX's warning and capacity and
  the same outputs; an atom-sharded run takes the one-device plan and
  writes its files byte for byte.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.ops import rdf as ops_rdf
from aztotmd_tpu_torch.runtime import step as step_mod
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")
EXAMPLES = sorted(n for n in os.listdir(EX)
                  if os.path.isdir(os.path.join(EX, n)))
TOOL_DECKS = {"nve": systems.write_argon_nve_deck,
              "dilute": systems.write_dilute_argon_deck,
              "scale_x2": lambda d: systems.write_scale_argon_deck(d, 2)}


@pytest.fixture(autouse=True)
def _ring_env(monkeypatch):
    # JAX's runner takes its stat ring unless told not to
    monkeypatch.delenv("AZTOTMD_NO_RING", raising=False)
    monkeypatch.delenv("AZTOTMD_RDF_ROWS", raising=False)
    monkeypatch.delenv("AZTOTMD_RING_STEPS", raising=False)


def _table(path):
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append([float(v) for v in line.split()])
            except ValueError:
                continue
    return np.asarray(rows)


@pytest.mark.parametrize("deck", EXAMPLES + list(TOOL_DECKS))
def test_ring_plan_matches_jax(deck, tmp_path):
    """The plan of each deck, key for key; argon_gas and the tool decks
    take ``rdf_from_outer`` with ``k_super`` 4 in both packages."""
    if deck in TOOL_DECKS:
        d = str(tmp_path / deck)
        TOOL_DECKS[deck](d)
    else:
        d = os.path.join(EX, deck)
    jr = JRunner(j_load_deck_dir(d), str(tmp_path / "jax"), quiet=True)
    pr = MDRunner(load_deck_dir(d, device="cpu"), str(tmp_path / "torch"),
                  quiet=True)
    assert jr.ring_ok and pr.ring_ok
    assert pr._ring_plan == jr._ring_plan
    assert pr.s_cap == jr.s_cap
    if deck == "argon_gas" or deck in TOOL_DECKS:
        assert pr._ring_plan["rdf_from_outer"] \
            and pr._ring_plan["k_super"] == 4
    assert pr.refine_blocks == pr._ring_plan["refine_blocks"]


def _gas(d, n_atoms, density, rdf=None, temp=None):
    """write_argon_gas_deck with the RDF reach (A) or the temperature
    (K) replaced."""
    systems.write_argon_gas_deck(d, n_atoms=n_atoms, density=density,
                                 steps=1000)
    path = os.path.join(d, "control.txt")
    with open(path) as f:
        text = f.read()
    if rdf:
        text = text.replace("rdf\t14.0", f"rdf\t{rdf}")
    if temp:
        text = text.replace("temperature 298.0", f"temperature {temp}")
    with open(path, "w") as f:
        f.write(text)
    return d


def _compare_outputs(out_t, out_j):
    """stat.dat and rdf.dat of the port against JAX's ring.  The ring
    packs each stat row in f32 on the device (``aztotmd_tpu/runtime/
    statring.py::make_stat_row``) where the port writes its f64 state: a
    stat value is held to half an f32 ulp (rtol 2^-24) and the files' six
    printed decimals (atol 1e-6).  The RDF histograms are f32 in both
    packages: rdf.dat within rtol 1e-8."""
    for name, rtol in (("stat.dat", 2.0 ** -24), ("rdf.dat", 1e-8)):
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=name)


# regime -> (deck writer, load keywords, steps, the plan's
# flags (covers, from_outer, k_super), full rebuilds, refines, RDF list
# builds, samples of the sampler it takes).  Stat every 200 steps, an
# RDF sample every 50: 4 samples a period.  The window: every run starts
# at step 0 with no host period, so it is the whole run (n_fix periods,
# at most s_cap 40).
REGIMES = {
    # 3,000 atoms at case study 1's density: n_fix 5, superblocks of 4:
    # a rebuild at periods 0 and 4 of the window, a refine a block
    "rdf_from_outer": (lambda d: _gas(d, 3000, 2.69e-5), {}, 1000,
                       (False, True, 4), 2, 20, 0, ("list", 20)),
    # 2,000 atoms at 1e-3: the RDF list (reach 19.2 A) covers the outer
    # reach (16 A): no full rebuild, the outer list refined from it
    "rdf_covers_outer": (lambda d: _gas(d, 2000, 1e-3), {}, 400,
                         (True, False, 1), 0, 8, 2, ("list", 8)),
    # at 10 K the inner rebuild period is 200 steps and the RDF skin its
    # 1 A floor: an RDF reach of 14.75 A leaves too little slack for even
    # one period off the outer list and does not cover it
    "refine_blocks": (lambda d: _gas(d, 2000, 1e-3, rdf="14.75", temp=10.0),
                      {}, 400, (False, False, 0), 2, 8, 2, ("list", 8)),
    "gather": (lambda d: _gas(d, 1000, 3e-4), {"pair_engine": "gather"},
               400, (False, False, 1), 0, 0, 2, ("list", 8)),
    "block": (lambda d: _gas(d, 1000, 3e-4), {"pair_engine": "block"},
              200, (False, False, 1), 0, 0, 1, ("list", 4)),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_regime_matches_jax_ring(regime, tmp_path):
    (write, load_kw, steps, flags, rebuilds, refines, builds,
     (sampler, samples)) = REGIMES[regime]
    deck = write(str(tmp_path / "deck"))
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    jr = JRunner(j_load_deck_dir(deck, dtype="f64", **load_kw), out_j,
                 quiet=True)
    pr = MDRunner(load_deck_dir(deck, dtype="f64", device="cpu", **load_kw),
                  out_t, quiet=True)
    plan = jr._ring_plan
    assert pr._ring_plan == plan
    assert (plan["rdf_covers_outer"], plan["rdf_from_outer"],
            plan["k_super"]) == flags
    assert not plan["rdf_rows"]
    assert plan["refine_blocks"] == (load_kw == {})
    assert jr.rcfg.k_cap > 0 and (pr.p_stat, pr.p_rdf) == (200, 50)
    step_mod.nbr_counts.update(rebuild=0, refine=0)
    ops_rdf.rdf_counts.update({k: 0 for k in ops_rdf.rdf_counts})
    pr.run(steps)
    assert step_mod.nbr_counts == {"rebuild": rebuilds, "refine": refines}
    want = {k: 0 for k in ops_rdf.rdf_counts}
    want[sampler] = samples
    want["list_build"] = builds
    assert ops_rdf.rdf_counts == want
    jr.run(steps)
    pr.finalize()
    jr.finalize()
    _compare_outputs(out_t, out_j)
    assert _table(os.path.join(out_t, "rdf.dat"))[:, 1].max() > 0.0
    np.testing.assert_allclose(pr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=0, atol=1e-12)
    assert int(pr.state.rdf_over) == int(jr.state.rdf_over)
    assert int(pr.state.nbr_viol) == int(jr.state.nbr_viol) == 0


def test_row_compaction_flag_is_jax_alone(tmp_path, monkeypatch):
    """Under ``AZTOTMD_RDF_ROWS=1`` JAX's plan compacts the outer list to
    its rows in reach on a 4,096-atom gas with its RDF to 8 A (the
    occupied rows fit JAX's 70% gate); the port, which does not port that
    opt-in, keeps JAX's plan otherwise, samples the whole outer list, and
    writes what JAX's row-compacted ring writes.  (The test's name holds
    no "rdf": JAX's runner names rdf_n.dat by replacing "rdf" in the whole
    path.)"""
    monkeypatch.setenv("AZTOTMD_RDF_ROWS", "1")
    deck = _gas(str(tmp_path / "deck"), 4096, 2.69e-5, rdf="8.0")
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    jr = JRunner(j_load_deck_dir(deck, dtype="f64"), out_j, quiet=True)
    pr = MDRunner(load_deck_dir(deck, dtype="f64", device="cpu"), out_t,
                  quiet=True)
    plan = jr._ring_plan
    assert plan["rdf_rows"] and plan["rdf_rowcap"] > 0 \
        and plan["rdf_from_outer"]
    assert pr._ring_plan == dict(plan, rdf_rows=False, rdf_rowcap=0,
                                 rdf_rowk=0)
    ops_rdf.rdf_counts.update({k: 0 for k in ops_rdf.rdf_counts})
    pr.run(400)
    jr.run(400)
    assert ops_rdf.rdf_counts["list"] == 8
    pr.finalize()
    jr.finalize()
    _compare_outputs(out_t, out_j)
    np.testing.assert_allclose(pr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=0, atol=1e-12)


def _warnings(text):
    return [ln for ln in text.splitlines() if ln.startswith("WARNING")]


def test_k_cap_regrow_matches_jax(tmp_path, capfd):
    """The covers-outer gas with ``k_cap`` forced to 16 in both runners
    (its rows hold up to ~60 entries), run one stat period a call (so
    that JAX's ring checks its monitors after each period, as the port
    does at each stat row): the first period's list is truncated (and
    the outer list refined from it), the stat row warns and regrows
    ``k_cap`` with JAX's text and capacity, and the outputs stay JAX's."""
    deck = _gas(str(tmp_path / "deck"), 2000, 1e-3)
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    jr = JRunner(j_load_deck_dir(deck, dtype="f64"), out_j, quiet=True)
    pr = MDRunner(load_deck_dir(deck, dtype="f64", device="cpu"), out_t,
                  quiet=True)
    assert pr._ring_plan == jr._ring_plan and jr._ring_plan[
        "rdf_covers_outer"]
    for r in (pr, jr):
        r.rcfg = dataclasses.replace(r.rcfg, k_cap=16)
        r._build_programs()
    for n in (200, 400, 600):
        pr.run(n)
        jr.run(n)
    warn = _warnings(capfd.readouterr().err)
    assert len(warn) == 2 and warn[0] == warn[1], warn
    assert warn[0].startswith("WARNING: RDF-list neighbor count ") \
        and "exceeded capacity 16; rebuilding with k_cap=" in warn[0]
    assert pr.rcfg.k_cap == jr.rcfg.k_cap > 16
    assert int(pr.state.rdf_over) == int(jr.state.rdf_over) <= pr.rcfg.k_cap
    pr.finalize()
    jr.finalize()
    _compare_outputs(out_t, out_j)
    np.testing.assert_allclose(pr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=0, atol=1e-12)


def test_atoms_mesh_takes_the_one_device_plan(tmp_path):
    """``--mesh 4 --mesh-mode atoms`` on the rdf_from_outer gas (its RDF
    sampled over the gathered shards): the one-device plan and its
    counts, and the one-device run's files byte for byte."""
    deck = _gas(str(tmp_path / "deck"), 1000, 3e-4)
    runs = {}
    for mode, kw in (("one", {}), ("atoms", {"mesh_devices": 4,
                                             "mesh_mode": "atoms"})):
        out = str(tmp_path / mode)
        r = MDRunner(load_deck_dir(deck, dtype="f64", device="cpu"), out,
                     quiet=True, **kw)
        step_mod.nbr_counts.update(rebuild=0, refine=0)
        ops_rdf.rdf_counts.update({k: 0 for k in ops_rdf.rdf_counts})
        r.run(400)
        r.finalize()
        runs[mode] = (r, out, dict(step_mod.nbr_counts),
                      dict(ops_rdf.rdf_counts))
    (one, o1, c1, s1), (sh, o2, c2, s2) = runs["one"], runs["atoms"]
    assert sh._atoms_mesh is not None and sh.comm is None
    assert sh._ring_plan == one._ring_plan and one._ring_plan[
        "rdf_from_outer"]
    assert c1 == c2 == {"rebuild": 2, "refine": 8}
    assert s1 == s2 and s1["list"] == 8
    for name in ("stat.dat", "rdf.dat", "revcon.xyz"):
        with open(os.path.join(o1, name)) as f, \
                open(os.path.join(o2, name)) as g:
            assert f.read() == g.read(), name


def test_nuclei_rdf_beside_rdf_in_any_directory(tmp_path):
    """rdf_n.dat is written beside rdf.dat also where a directory's name
    holds "rdf" (the name of the file alone becomes rdf_n)."""
    deck = _gas(str(tmp_path / "deck"), 1000, 3e-4)
    out = str(tmp_path / "rdf_out")
    r = MDRunner(load_deck_dir(deck, device="cpu"), out, quiet=True)
    assert r.rcfg.nuclei
    r.run(200)
    r.finalize()
    assert sorted(n for n in os.listdir(out) if n.startswith("rdf")) == [
        "rdf.dat", "rdf_n.dat"]
