"""The Verlet-list engine end to end: the port's multi-step schedule, its
runner, CLI and capacity regrows against the JAX package, on a 3,000-atom
cut of examples/argon_gas (the two-level list, the sorted build, the
row-compacted walk) and examples/bonded_fluid (the dense walk, constant
bonds and angles), in f64.  Positions within 1e-8 A, lists and monitors
exactly equal, the CLI's outputs within rtol 1e-8 of the JAX runner's
host chunk loop (``AZTOTMD_NO_RING``; its on-device stat ring is not
ported), revangles.txt byte for byte."""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from aztotmd_tpu.__main__ import main as j_main
from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.runtime.step import make_multi_step as j_make_multi_step
from aztotmd_tpu.runtime.step import make_step as j_make_step
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.core.config import build_sim_config
from aztotmd_tpu_torch.io import (parse_atoms_file, parse_control_file,
                                  parse_field_file)
from aztotmd_tpu_torch.runtime import step as step_mod
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_multi_step, make_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BONDED = os.path.join(ROOT, "examples", "bonded_fluid")
_LISTS = ("nbr_idx", "nbr2_idx", "nbrow_idx", "nbr_over", "nbr2_over",
          "nbrow_over", "nbr_viol", "cell_overflow")


@pytest.fixture(scope="module")
def gas(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gas3k"))
    systems.write_argon_gas_deck(d, n_atoms=3000, steps=400)
    return d


def _table(path):
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append([float(v) for v in line.split()])
            except ValueError:
                continue
    return np.asarray(rows)


def _both(deck, **cfg_kw):
    """Both packages' f64 systems of a deck with ``cfg_kw`` replaced in
    the config, the states' lists given the new capacities' shapes."""
    j = j_load_deck_dir(deck, dtype="f64")
    p = load_deck_dir(deck, dtype="f64")
    assert dataclasses.asdict(j["cfg"]) == dataclasses.asdict(p["cfg"])
    assert p["cfg"].pair_engine == "neighbor"
    if cfg_kw:
        c = j["cfg"] = p["cfg"] = dataclasses.replace(p["cfg"], **cfg_kw)
        N = c.n_at
        lists = dict(
            nbr_idx=np.full((N, c.n_neigh), N, np.int32),
            nbr2_idx=np.full((N, max(c.n_neigh2, 1)), N, np.int32),
            nbrow_idx=np.full((max(c.nb_rowcap, 1),
                               1 + (c.n_neigh if c.nb_rowcap else 1)), N,
                              np.int32))
        j["state"] = j["state"].replace(
            **{k: jax.numpy.asarray(v) for k, v in lists.items()})
        p["state"] = p["state"].replace(
            **{k: torch.as_tensor(v) for k, v in lists.items()})
    return j, p


def _check_state(got, js, names=_LISTS):
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got["vel"], np.asarray(js.vel), rtol=0,
                               atol=1e-8)
    for name in names:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)),
                                      err_msg=name)
    for k in ("kin", "vdw", "bond", "angle", "temp", "pot", "tot"):
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=1e-8, abs=1e-12), k
    np.testing.assert_array_equal(got["rng"], np.asarray(js.rng))


def test_two_level_schedule_matches_jax(gas):
    """R = 10, Q = 3 in both packages: 70 steps are two superblocks of 30
    (a full rebuild, then refines after 10 and 20 steps) and a last one
    of 10 (a full rebuild).  The row-compacted walk, the sorted build."""
    j, p = _both(gas, nb_rebuild=10, nb_outer=3)
    cfg = p["cfg"]
    assert cfg.nb_rowcap and step_mod.ops_nbr.sorted_build_ok(cfg)
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], 70)
    step_mod.nbr_counts.update(rebuild=0, refine=0)
    st = make_multi_step(cfg, p["aux"])(p["state"], p["ff"], 70)
    assert step_mod.nbr_counts == {"rebuild": 3, "refine": 4}
    got = convert.state_to_numpy(st)
    _check_state(got, js)
    assert int(got["step"]) == 70
    assert (got["nbrow_idx"][:, 0] < cfg.n_at).sum() > 0
    assert int(got["nbr_viol"]) == 0


def test_single_level_auto_rebuild_steps_match_jax(gas):
    """The single-step mode (a rebuild inside the step on schedule or when
    stale) with a skin so thin that the list goes stale: 8 steps of each
    package's make_step, and the scanned single-level schedule (R = 3)
    over the same 8 steps."""
    j, p = _both(gas, nb_outer=1, nb_rebuild=3, nb_skin=0.02, nb_rowcap=0)
    jstep = jax.jit(j_make_step(j["cfg"], j["aux"]))
    step = make_step(p["cfg"], p["aux"])
    js, st = j["state"], p["state"]
    for _ in range(8):
        js = jstep(js, j["ff"])
        st = step(st, p["ff"])
    got = convert.state_to_numpy(st)
    _check_state(got, js, ("nbr_idx", "nbr_over", "nbr_viol",
                           "cell_overflow"))
    assert int(got["nbr_viol"]) > 0
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], 8)
    got = convert.state_to_numpy(
        make_multi_step(p["cfg"], p["aux"])(p["state"], p["ff"], 8))
    _check_state(got, js, ("nbr_idx", "nbr_over", "nbr_viol"))


def test_bonded_fluid_40_steps_match_jax():
    """examples/bonded_fluid: the dense walk (no row cap), the two-level
    list (Q = 4, R = 18), the sorted build, constant bonds and angles."""
    j, p = _both(BONDED)
    cfg = p["cfg"]
    assert (cfg.nb_outer, cfg.nb_rebuild, cfg.nb_rowcap, cfg.use_angl) \
        == (4, 18, 0, 1)
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], 40)
    got = convert.state_to_numpy(
        make_multi_step(cfg, p["aux"])(p["state"], p["ff"], 40))
    _check_state(got, js, _LISTS[:2] + _LISTS[3:])
    assert float(got["energies"]["angle"]) > 0.0


@pytest.mark.parametrize("which", ["gas", "bonded_fluid"])
def test_run_cli_matches_jax_cli(gas, which, tmp_path, monkeypatch):
    """400 steps of the gas (an RDF sample every 50 steps) and 200 of
    bonded_fluid, f64, from both CLIs, both on their host chunk loop
    (AZTOTMD_NO_RING: a full rebuild each RDF block, the stat rows read
    from the f64 state):
    stat.dat, rdf.dat, msd.dat within rtol 1e-8; revangles.txt and
    revbonds.txt byte for byte."""
    deck, n = (gas, 400) if which == "gas" else (BONDED, 200)
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    runner = main(["run", deck, "--cpu", "--dtype", "f64", "-o", out_t,
                   "--quiet", "--steps", str(n)])
    assert int(runner.state.step) == n
    j_main(["--cpu", "run", deck, "-o", out_j, "--dtype", "f64", "--quiet",
            "--steps", str(n)])
    for name in ("stat.dat", "rdf.dat", "msd.dat", "msd_d.dat"):
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=name)
    assert _table(os.path.join(out_t, "rdf.dat"))[:, 1].max() > 0.0
    if which == "bonded_fluid":
        stat = _table(os.path.join(out_t, "stat.dat"))
        assert stat[:, 8].min() > 0.0           # engAngle
        for name in ("revangles.txt", "revbonds.txt"):
            with open(os.path.join(out_t, name)) as f, \
                    open(os.path.join(out_j, name)) as g:
                text = f.read()
                assert text == g.read(), name
        with open(os.path.join(out_t, "revangles.txt")) as f:
            assert int(f.readline()) == 64


def _runners(deck, tmp_path, monkeypatch, n, **cfg_kw):
    """Both packages' runners over ``n`` steps with ``cfg_kw`` replaced
    in the deck's config and an inner rebuild period R shorter than the
    RDF period, so that the stat ring's predicate fails in both packages:
    each takes the host chunk loop, whose every RDF block restarts the
    schedule.  Returns (port runner, JAX runner)."""
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    j, p = _both(deck, nb_rebuild=40, **cfg_kw)
    pr = MDRunner(p, str(tmp_path / "torch"), quiet=True)
    jr = JRunner(j, str(tmp_path / "jax"), quiet=True)
    assert pr.p_rdf > 40 and not pr.refine_blocks
    pr.run(n)
    jr.run(n)
    return pr, jr


def _warnings(text):
    return [line for line in text.splitlines() if line.startswith("WARNING")]


@pytest.mark.parametrize("which", ["gas", "lj"])
def test_capacity_regrows_match_jax(gas, which, tmp_path, monkeypatch,
                                    capfd):
    """Capacities below what the decks need, the same in both packages
    (the gas's largest inner count is 1, so its K cannot be cut; the
    argon deck of ``write_lj_deck`` takes K): after one stat row each
    monitor has regrown with JAX's warning and capacity and the lists the
    new shapes; after 200 more steps the warnings, capacities and states
    are still JAX's."""
    if which == "gas":
        deck = gas
        kw = dict(n_neigh2=8, nb_rowcap=32)
        kinds = ("occupied-row count", "outer neighbor count",
                 "cell occupancy")
    else:
        deck = str(tmp_path / "lj")
        os.makedirs(deck)
        systems.write_lj_deck(deck)
        kw = dict(n_neigh=4, n_neigh2=24, nb_rowcap=64)
        kinds = ("WARNING: neighbor count", "occupied-row count",
                 "outer neighbor count", "cell occupancy")
    g = load_deck_dir(deck)["cfg"].nb_grid
    kw["nb_grid"] = dataclasses.replace(g, cap=2 if which == "gas" else 8)
    pr, jr = _runners(deck, tmp_path, monkeypatch, 200, **kw)
    warn = _warnings(capfd.readouterr().err)
    n = len(warn) // 2
    assert warn[:n] == warn[n:] and n == len(kinds), warn
    for text, w in zip(kinds, warn[:n]):
        assert text in w, (text, w)
    assert dataclasses.asdict(pr.cfg) == dataclasses.asdict(jr.cfg)
    for name, small in kw.items():
        assert getattr(pr.cfg, name) != small, name
    assert pr.state.nbrow_idx.shape == (pr.cfg.nb_rowcap, 1 + pr.cfg.n_neigh)
    # a count that the first check saw truncated may regrow again
    pr.run(400)
    jr.run(400)
    warn = _warnings(capfd.readouterr().err)
    assert warn[:len(warn) // 2] == warn[len(warn) // 2:]
    assert dataclasses.asdict(pr.cfg) == dataclasses.asdict(jr.cfg)
    _check_state(convert.state_to_numpy(pr.state), jr.state)


def test_skin_escalation_matches_jax(gas, tmp_path, monkeypatch, capfd):
    """A skin of 0.02 A goes stale every step: the first stat row warns,
    the second grows nb_skin 1.5x and K by the reach-volume ratio, as
    JAX's runner does."""
    pr, jr = _runners(gas, tmp_path, monkeypatch, 400, nb_skin=0.02)
    warn = _warnings(capfd.readouterr().err)
    assert len(warn) == 4 and warn[:2] == warn[2:], warn
    assert "so far" in warn[0] and "growing nb_skin" in warn[1]
    assert pr.cfg.nb_skin == jr.cfg.nb_skin == pytest.approx(0.03)
    assert pr.cfg.n_neigh == jr.cfg.n_neigh
    assert pr._skin_grown == 1


def test_argon_gas_deck_is_case_study_1_shaped(tmp_path):
    """examples/argon_gas: written byte for byte by the writer, and both
    packages choose the same configuration for it: the two-level Verlet
    list with the row-compacted walk and the sorted build."""
    deck = os.path.join(ROOT, "examples", "argon_gas")
    systems.write_argon_gas_deck(str(tmp_path))
    for name in ("atoms.xyz", "control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / name), os.path.join(deck, name),
                           shallow=False), name
    fld = parse_field_file(os.path.join(deck, "field.txt"))
    ctl = parse_control_file(os.path.join(deck, "control.txt"),
                             charged_spec=fld.charged_spec)
    atoms = parse_atoms_file(os.path.join(deck, "atoms.xyz"))
    args = (ctl, fld, atoms.box, atoms.n_atoms)
    cfg = build_sim_config(*args, pos=atoms.pos)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_build_sim_config(*args, pos=atoms.pos))
    assert cfg.n_at == 40000 and abs(cfg.box[0] - 1141.4) < 0.05
    assert (cfg.pair_engine, cfg.nb_rebuild, cfg.nb_outer, cfg.n_neigh,
            cfg.n_neigh2, cfg.nb_skin2, cfg.nb_rowcap, cfg.nb_orowcap) == (
        "neighbor", 57, 24, 4, 24, 36.0, 1536, 0)
    g = cfg.nb_grid
    assert (g.dims, g.cap, len(g.stencil)) == ((28, 28, 28), 12, 27)
    assert step_mod.ops_nbr.sorted_build_ok(cfg)


def test_ring_cadence_matches_jax_ring(tmp_path, monkeypatch):
    """The two-level cadence of JAX's stat ring (``refine_blocks``): a
    600-atom gas at 1e-3 atoms/A^3 with the RDF to 30 A every 50 steps
    and stat every 200 (Q 8, R 57), on which JAX's runner takes the ring
    with refine_blocks and without its RDF list (k_cap 0: neither
    rdf_from_outer nor rdf_covers_outer).  400 f64 steps of each runner:
    the port's stat.dat and rdf.dat rows and final positions within rtol
    1e-8 of the ring's, and its counts one full rebuild per stat period
    and one inner refine per RDF block."""
    monkeypatch.delenv("AZTOTMD_NO_RING", raising=False)
    deck = str(tmp_path / "gas600")
    systems.write_argon_gas_deck(deck, n_atoms=600, density=1e-3, steps=400)
    ctl = os.path.join(deck, "control.txt")
    with open(ctl) as f:
        text = f.read()
    with open(ctl, "w") as f:
        f.write(text.replace("rdf\t14.0", "rdf\t30.0"))
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    jr = JRunner(j_load_deck_dir(deck, dtype="f64"), out_j, quiet=True)
    plan = jr._ring_plan
    assert jr.ring_ok and plan["refine_blocks"] and not plan["rdf_from_outer"] \
        and not plan["rdf_covers_outer"]
    pr = MDRunner(load_deck_dir(deck, dtype="f64"), out_t, quiet=True)
    assert pr.refine_blocks and (pr.p_stat, pr.p_rdf) == (200, 50)
    step_mod.nbr_counts.update(rebuild=0, refine=0)
    pr.run(400)
    assert step_mod.nbr_counts == {"rebuild": 2, "refine": 8}
    jr.run(400)
    pr.finalize()
    jr.finalize()
    for name in ("stat.dat", "rdf.dat"):
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        # the files print six decimals: a value within rtol 1e-8 of the
        # ring's can still round to the neighbouring last digit (the
        # ring packs its row on the device)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=1e-8, atol=1e-12)
    assert int(pr.state.nbr_viol) == int(jr.state.nbr_viol) == 0
