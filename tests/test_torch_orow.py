"""The outer-row-compacted refine against the JAX package, on a dilute
argon deck (``systems.write_dilute_argon_deck`` of a 3,000-atom argon gas:
1.0e-6 atoms/A^3, where few rows have an outer neighbor and the
configuration sets ``nb_orowcap``; 150 of its atoms moved into dimers so
that the inner lists and forces are not empty): ``compact_orows``, the refine with
``orow``, the step's rebuild and refine in f64 over several rebuild
intervals, the runner's ``orow_over`` regrow, and a JAX state and
checkpoint of the deck crossing into the port.  Integer lists, row ids,
counts and monitors exactly equal; positions and velocities within
1e-8 A (f64)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops import neighbors as j_nbr
from aztotmd_tpu.runtime.checkpoint import save_checkpoint as j_save
from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.runtime.step import make_multi_step as j_make_multi_step
from aztotmd_tpu.runtime.step import \
    rebuild_neighbors_state as j_rebuild_state
from aztotmd_tpu.runtime.step import refine_neighbors_state as j_refine_state
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.ops import neighbors as nbr
from aztotmd_tpu_torch.runtime import step as step_mod
from aztotmd_tpu_torch.runtime.checkpoint import load_checkpoint
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

POS_ATOL = 1e-8         # A, f64
_LISTS = ("nbr_idx", "nbr2_idx", "nbrow_idx", "orow_idx", "nbr_over",
          "nbr2_over", "nbrow_over", "orow_over", "nbr_viol",
          "cell_overflow")


@pytest.fixture(scope="module")
def dilute(tmp_path_factory):
    base = tmp_path_factory.mktemp("dilute")
    src, deck = str(base / "gas"), str(base / "dilute")
    systems.write_argon_gas_deck(src, n_atoms=3000, steps=200)
    systems.write_dilute_argon_deck(deck, steps=600, src=src)
    _pair_up(deck)
    return deck


def _pair_up(deck, n_pairs=150, r=3.8):
    """Move atom k (k < n_pairs) to ``r`` A from atom n_pairs + k along a
    seeded direction: at 1.0e-6 atoms/A^3 no two atoms of the scaled gas
    lie within the inner reach (its 3 A minimum separation becomes 9 A),
    so without these dimers the inner lists, forces and walk are empty."""
    path = os.path.join(deck, "atoms.xyz")
    with open(path) as f:
        head = [f.readline(), f.readline()]
        rows = f.read().splitlines()
    box = float(head[1].split()[1])
    rng = np.random.default_rng(8)
    for k in range(n_pairs):
        other = np.array([float(v) for v in rows[n_pairs + k].split()[1:]])
        u = rng.normal(size=3)
        p = (other + r * u / np.linalg.norm(u)) % box
        rows[k] = f"Ar\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}"
    with open(path, "w") as f:
        f.write("".join(head) + "\n".join(rows) + "\n")


_CACHE = {}


def _outer(deck):
    """(cfg, moved f64 positions, the JAX outer list at the build
    positions) of the deck: the atoms moved by up to 0.4 A after the
    build, as between two rebuilds."""
    if deck not in _CACHE:
        p = load_deck_dir(deck, dtype="f64")
        cfg = p["cfg"]
        pos = p["state"].pos.numpy()
        idx2 = j_nbr.build_outer_neighbors(cfg, jnp.asarray(pos))[0]
        rng = np.random.default_rng(21)
        moved = (pos + rng.uniform(-0.4, 0.4, pos.shape)) % np.asarray(
            cfg.box)
        _CACHE[deck] = cfg, moved, idx2
    return _CACHE[deck]


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def test_dilute_deck_takes_the_orow_refine(dilute):
    """Both packages configure the deck alike: the two-level list, the
    row-compacted walk and an outer-row capacity below N."""
    j = j_load_deck_dir(dilute, dtype="f64")
    p = load_deck_dir(dilute, dtype="f64")
    cfg = p["cfg"]
    assert dataclasses.asdict(j["cfg"]) == dataclasses.asdict(cfg)
    assert cfg.pair_engine == "neighbor" and cfg.nb_outer > 1
    assert 0 < cfg.nb_rowcap <= cfg.nb_orowcap < cfg.n_at
    assert tuple(p["state"].orow_idx.shape) == (cfg.nb_orowcap,)


@pytest.mark.parametrize("where", ["below", "above", "n_at"])
def test_compact_orows_matches_jax(dilute, where):
    """The outer-occupied rows ascending with sentinel padding and the
    true count, with o_cap below the occupied count (the highest ids
    dropped), above it, and equal to N."""
    cfg, _, idx2 = _outer(dilute)
    N = cfg.n_at
    n_occ = int(np.any(np.asarray(idx2) != N, axis=1).sum())
    assert 0 < n_occ < N - 200
    o_cap = {"below": n_occ - 100, "above": n_occ + 100, "n_at": N}[where]
    got = nbr.compact_orows(torch.as_tensor(np.array(idx2)), o_cap, N)
    ref = j_nbr.compact_orows(idx2, o_cap, N)
    _eq(got[0], ref[0], "orow")
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (o_cap,)
    assert int(got[1]) == int(ref[1]) == n_occ
    pad = got[0].numpy() == N
    assert pad.sum() == max(o_cap - n_occ, 0)


def test_compact_orows_refuses_o_cap_past_n(dilute):
    """o_cap > N: JAX's top_k refuses it, and so does the port."""
    cfg, _, idx2 = _outer(dilute)
    N = cfg.n_at
    with pytest.raises(ValueError):
        j_nbr.compact_orows(idx2, N + 1, N)
    with pytest.raises(ValueError, match="o_cap"):
        nbr.compact_orows(torch.as_tensor(np.array(idx2)), N + 1, N)


@pytest.mark.parametrize("o_cap", ["config", "occupied", "n_at"])
def test_orow_refine_matches_jax_and_all_rows(dilute, o_cap):
    """refine_neighbors_rows(orow=) after the atoms moved: exactly JAX's
    (idx, nbrow, n_real_max, n_rows) and exactly the port's refine over
    all rows, with the row capacity from the config and a small one that
    truncates."""
    cfg, moved, idx2 = _outer(dilute)
    N = cfg.n_at
    n_occ = int(np.any(np.asarray(idx2) != N, axis=1).sum())
    cap = {"config": cfg.nb_orowcap, "occupied": n_occ, "n_at": N}[o_cap]
    t2, tp, jp = (torch.as_tensor(np.array(idx2)), torch.as_tensor(moved),
                  jnp.asarray(moved))
    orow_t = nbr.compact_orows(t2, cap, N)[0]
    orow_j = j_nbr.compact_orows(idx2, cap, N)[0]
    n_rows = None
    for r_cap in (cfg.nb_rowcap, 32):
        rcfg = dataclasses.replace(cfg, nb_rowcap=r_cap, nb_orowcap=cap)
        got = nbr.refine_neighbors_rows(rcfg, tp, t2, r_cap, orow=orow_t)
        ref = j_nbr.refine_neighbors_rows(rcfg, jp, idx2, r_cap,
                                          orow=orow_j)
        rows = nbr.refine_neighbors_rows(rcfg, tp, t2, r_cap)
        for a, b, c, nm in zip(got, ref, rows,
                               ("idx", "nbrow", "nmax", "n_rows")):
            _eq(a, b, nm)
            _eq(a, c, nm + " (all rows)")
        n_rows = int(got[3]) if n_rows is None else n_rows
    assert 32 < n_rows <= cfg.nb_rowcap      # the small cap truncates


def test_orow_refine_refuses_r_cap_past_o_cap(dilute):
    """r_cap above the outer-row slots: JAX's top_k refuses it, and so
    does the port."""
    cfg, moved, idx2 = _outer(dilute)
    t2 = torch.as_tensor(np.array(idx2))
    orow = nbr.compact_orows(t2, 64, cfg.n_at)[0]
    with pytest.raises(ValueError):
        j_nbr.refine_neighbors_rows(cfg, jnp.asarray(moved), idx2, 128,
                                    orow=jnp.asarray(orow.numpy()))
    with pytest.raises(ValueError, match="r_cap"):
        nbr.refine_neighbors_rows(cfg, torch.as_tensor(moved), t2, 128,
                                  orow=orow)


def _both(deck, **cfg_kw):
    """Both packages' f64 systems with ``cfg_kw`` replaced in the config
    (list capacities untouched)."""
    j = j_load_deck_dir(deck, dtype="f64")
    p = load_deck_dir(deck, dtype="f64")
    assert dataclasses.asdict(j["cfg"]) == dataclasses.asdict(p["cfg"])
    if cfg_kw:
        j["cfg"] = p["cfg"] = dataclasses.replace(p["cfg"], **cfg_kw)
    return j, p


def _check_state(got, js, names=_LISTS):
    for name in ("pos", "vel"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)),
                                   rtol=0, atol=POS_ATOL, err_msg=name)
    for name in names:
        _eq(got[name], getattr(js, name), name)
    for k in ("kin", "vdw", "pot", "tot"):
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=1e-8, abs=1e-12), k


def test_dilute_steps_match_jax(dilute):
    """R = 10, Q = 3: 70 steps are two superblocks of a full rebuild and
    two orow refines, and a last full rebuild (3 rebuilds, 4 refines):
    lists, outer-occupied rows and monitors exactly JAX's, positions
    within 1e-8 A."""
    j, p = _both(dilute, nb_rebuild=10, nb_outer=3)
    cfg = p["cfg"]
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], 70)
    step_mod.nbr_counts.update(rebuild=0, refine=0)
    st = step_mod.make_multi_step(cfg, p["aux"])(p["state"], p["ff"], 70)
    assert step_mod.nbr_counts == {"rebuild": 3, "refine": 4}
    got = convert.state_to_numpy(st)
    _check_state(got, js)
    assert int(got["step"]) == 70 and int(got["nbr_viol"]) == 0
    n_orow = int(got["orow_over"])
    assert 0 < n_orow <= cfg.nb_orowcap
    assert (got["orow_idx"] < cfg.n_at).sum() == n_orow
    # the same run without the outer-row compaction: the same lists
    plain = step_mod.make_multi_step(
        dataclasses.replace(cfg, nb_orowcap=0), p["aux"])(
            p["state"], p["ff"], 70)
    other = convert.state_to_numpy(plain)
    for name in ("nbr_idx", "nbrow_idx", "nbr_over", "nbrow_over"):
        _eq(got[name], other[name], name + " (no orow)")
    np.testing.assert_array_equal(got["pos"], other["pos"])


def _warnings(text):
    return [ln for ln in text.splitlines() if ln.startswith("WARNING")]


def test_orow_regrow_matches_jax(dilute, tmp_path, monkeypatch, capfd):
    """An outer-row capacity below the occupied count (but at the row
    capacity), the same in both packages' runners (JAX's host chunk
    loop): at the first stat row both warn with the same text and regrow
    to the same capacity, with a full rebuild; after 400 more steps the
    states, lists and monitors are JAX's."""
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    p0 = load_deck_dir(dilute, dtype="f64")
    small = p0["cfg"].nb_rowcap
    j, p = _both(dilute, nb_rebuild=40, nb_orowcap=small)
    N = p["cfg"].n_at
    pad = np.full((small,), N, np.int32)
    j["state"] = j["state"].replace(orow_idx=jax.numpy.asarray(pad))
    p["state"] = p["state"].replace(orow_idx=torch.as_tensor(pad))
    pr = MDRunner(p, str(tmp_path / "torch"), quiet=True)
    jr = JRunner(j, str(tmp_path / "jax"), quiet=True)
    assert not pr.refine_blocks
    pr.run(200)
    jr.run(200)
    warn = _warnings(capfd.readouterr().err)
    n = len(warn) // 2
    assert n == 1 and warn[:n] == warn[n:], warn
    assert "outer-occupied row count" in warn[0] \
        and f"capacity {small};" in warn[0]
    assert dataclasses.asdict(pr.cfg) == dataclasses.asdict(jr.cfg)
    assert pr.cfg.nb_orowcap > small
    assert tuple(pr.state.orow_idx.shape) == (pr.cfg.nb_orowcap,)
    pr.run(600)
    jr.run(600)
    assert _warnings(capfd.readouterr().err) == []
    assert int(pr.state.orow_over) <= pr.cfg.nb_orowcap
    _check_state(convert.state_to_numpy(pr.state), jr.state)


def test_jax_state_and_checkpoint_cross_with_orow(dilute, tmp_path):
    """A JAX state of the deck after a full rebuild crosses into the port
    with the same outer-occupied rows; a JAX checkpoint of it resumes in
    the port, whose next refine (over those rows) equals JAX's."""
    j, p = _both(dilute)
    js = j_rebuild_state(j["cfg"], j["state"])
    st = convert.state_from_numpy(js)
    _eq(st.orow_idx, js.orow_idx, "orow_idx")
    assert int(st.orow_over) == int(js.orow_over) > 0
    path = str(tmp_path / "checkpoint.npz")
    rng = np.random.default_rng(5)
    moved = (np.asarray(js.pos) + rng.uniform(-0.3, 0.3, js.pos.shape)) \
        % np.asarray(j["cfg"].box)
    js = js.replace(pos=jnp.asarray(moved))
    j_save(path, js, {"step": int(js.step)})
    resumed = load_checkpoint(path, p["state"])
    _eq(resumed.orow_idx, js.orow_idx, "orow_idx after resume")
    got = convert.state_to_numpy(step_mod.refine_neighbors_state(
        p["cfg"], resumed))
    ref = j_refine_state(j["cfg"], js)
    for name in ("nbr_idx", "nbrow_idx", "nbr_over", "nbrow_over"):
        _eq(got[name], getattr(ref, name), name)
