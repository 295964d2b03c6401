"""Whole MD steps of the port against the JAX package: a ~300-atom
clustered Surkov deck from the slice deck's writer (radiative thermostat,
equilibration rescale at step 0), Nose-Hoover clusters on the sparse
engine, and the reactive examples (bond formation, electron jumps).  The
thermostat noise is a pure function of (seed, step, atom id) and the
jump draws are JAX's threefry, so the trajectories match step for
step."""

import os

import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.runtime.step import make_multi_step as j_make_multi_step
from aztotmd_tpu_torch import convert
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_multi_step
from aztotmd_tpu_torch.systems import write_surkov_cluster_deck

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them (these
# systems are a few hundred atoms).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENG = ("kin", "vdw", "temp", "pot", "tot")


@pytest.fixture(scope="module")
def small_deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("surkov300"))
    write_surkov_cluster_deck(d, n_atoms=300, box=20.0, steps=100,
                              n_equil=20)
    return d


def _run_both(deck, dtype, n):
    j = j_load_deck_dir(deck, dtype=dtype, seed=9)
    assert j["cfg"].pair_engine == "pallas"
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], n)
    p = load_deck_dir(deck, dtype=dtype, seed=9)
    ps = make_multi_step(p["cfg"], p["aux"])(p["state"], p["ff"], n)
    return convert.state_to_numpy(ps), js


def _check(got, js, pos_atol, eng_rel):
    assert int(got["step"]) == int(js.step)
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=pos_atol)
    for k in _ENG:
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=eng_rel), k
    np.testing.assert_array_equal(got["rng"], np.asarray(js.rng))
    np.testing.assert_array_equal(got["cross_pos"], np.asarray(js.cross_pos))
    np.testing.assert_array_equal(got["cross_neg"], np.asarray(js.cross_neg))


def test_20_steps_f64_match_jax(small_deck):
    """f64: both packages route the pallas engine to their cell-block
    engine; the same operations in f64."""
    got, js = _run_both(small_deck, "f64", 20)
    _check(got, js, pos_atol=1e-8, eng_rel=1e-8)
    # radii and internal energies: equal to f64 round-off of the forces
    np.testing.assert_allclose(got["radii"], np.asarray(js.radii),
                               rtol=1e-12)
    np.testing.assert_allclose(got["engs"], np.asarray(js.engs),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], np.asarray(js.vel), rtol=0,
                               atol=1e-8)
    assert float(got["pressure"]) == pytest.approx(float(js.pressure),
                                                   rel=1e-8)


def test_5_steps_f32_match_jax_interpret_kernel(small_deck):
    """f32: the JAX step runs the Pallas all-pairs kernel in interpret
    mode, the port its plain version (the kernel's CPU route)."""
    got, js = _run_both(small_deck, "f32", 5)
    _check(got, js, pos_atol=1e-5, eng_rel=1e-4)


def test_slice_deck_shape_stays_finite_300_steps(small_deck):
    """300 steps of the slice deck's shape (same writer, density and
    potential, cut to 300 atoms) stay finite with no runaway
    temperature."""
    p = load_deck_dir(small_deck, dtype="f32", seed=4)
    cfg = p["cfg"]
    st = make_multi_step(cfg, p["aux"])(p["state"], p["ff"], 300)
    assert bool(torch.isfinite(st.pos).all())
    assert bool(torch.isfinite(st.vel).all())
    from aztotmd_tpu import units
    t_kin = 2.0 * float(st.energies.kin) / (units.KB * cfg.deg_free)
    assert 0.0 < t_kin < 3.0 * cfg.temp


@pytest.fixture(scope="module")
def nose_deck(tmp_path_factory):
    """Three 128-atom Ar LJ clusters in a 50 A box, Nose-Hoover 90 K (the
    nanoclusters deck's writer, cut in size)."""
    from aztotmd_tpu_torch.systems import write_nanoclusters_deck
    d = str(tmp_path_factory.mktemp("nose_clusters"))
    write_nanoclusters_deck(d, n_clusters=3, per=128, box=50.0,
                            min_sep=25.0, steps=40)
    return d


def test_nose_apply_matches_jax_f64(nose_deck):
    """One Nose-Hoover pass on numpy-seeded inputs, rel 1e-12 (the same
    f64 operations in the same order)."""
    from aztotmd_tpu.ops.thermostat import nose_apply as j_nose_apply
    from aztotmd_tpu_torch.ops.thermostat import nose_apply
    cfg = load_deck_dir(nose_deck, dtype="f64")["cfg"]
    assert cfg.rqmass > 0.0
    rng = np.random.default_rng(8)
    vel = rng.normal(0.0, 3.0, (cfg.n_at, 3))
    for kin, chit, consint in ((0.7 * cfg.te_kin, 0.02, -1e-3),
                               (1.6 * cfg.te_kin, -0.05, 4e-3)):
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)
        got = nose_apply(cfg, torch.as_tensor(vel), f64(kin), f64(chit),
                         f64(consint))
        ref = j_nose_apply(cfg, vel, np.float64(kin), np.float64(chit),
                           np.float64(consint))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=0)


def test_20_nose_steps_sparse_engine_f64_match_jax(nose_deck):
    """20 f64 steps with the engine forced to "sparse" in both packages
    (auto picks it only above 4,096 atoms): the f64 route of both is the
    cell-block engine.  The same f64 physics: positions atol 1e-8 A,
    energies and the Nose-Hoover chit/consint rel 1e-8; the monitor is
    cell occupancy on both sides."""
    j = j_load_deck_dir(nose_deck, dtype="f64", pair_engine="sparse")
    p = load_deck_dir(nose_deck, dtype="f64", pair_engine="sparse")
    assert p["cfg"].pair_engine == j["cfg"].pair_engine == "sparse"
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], 20)
    got = convert.state_to_numpy(
        make_multi_step(p["cfg"], p["aux"])(p["state"], p["ff"], 20))
    assert int(got["step"]) == 20
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=1e-8)
    for k in ("kin", "vdw", "pot", "tot"):
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=1e-8), k
    for k in ("chit", "consint"):
        assert float(got[k]) != 0.0
        assert float(got[k]) == pytest.approx(float(getattr(js, k)),
                                              rel=1e-8), k
    # in f64 the monitor is the fullest cell's occupancy, as in JAX
    assert 0 < int(got["cell_overflow"]) == int(js.cell_overflow) \
        <= p["cfg"].grid.cap


_TOPOLOGY = ("types", "bond_at1", "bond_at2", "bond_type", "bond_start",
             "n_bond", "n_jump", "jump_pos", "jump_neg", "rng", "parents",
             "nbonds", "bt_count", "bt_r_count", "bt_lt_count", "touched",
             "spec_number")


def _reactive_run(deck, dtype, n):
    j = j_load_deck_dir(deck, dtype=dtype)
    p = load_deck_dir(deck, dtype=dtype)
    assert p["cfg"].pair_engine == j["cfg"].pair_engine == "pallas"
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], n)
    got = convert.state_to_numpy(
        make_multi_step(p["cfg"], p["aux"])(p["state"], p["ff"], n))
    for name in _TOPOLOGY:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)),
                                      err_msg=name)
    return got, js


@pytest.mark.parametrize("name", ["reactive_polymer", "ejump_redox"])
def test_20_reactive_steps_f64_match_jax(name):
    """The example decks at full size: 20 f64 steps against JAX, whose f64
    route is its XLA cell-block engine.  Bonds form on reactive_polymer
    and electrons jump on ejump_redox from the first steps; topology and
    RNG words exact, positions atol 1e-8 A, energies rel 1e-8."""
    got, js = _reactive_run(f"{ROOT}/examples/{name}", "f64", 20)
    assert int(got["n_bond"]) > 0 if name == "reactive_polymer" \
        else int(got["n_jump"]) > 0
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=1e-8)
    for k in ("kin", "vdw", "coul1", "bond", "pot", "tot"):
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=1e-8, abs=1e-12), k
    np.testing.assert_allclose(got["bt_r_mean"], np.asarray(js.bt_r_mean),
                               rtol=1e-8)


@pytest.mark.parametrize("name", ["reactive_polymer", "ejump_redox"])
def test_5_reactive_steps_f32_match_jax_interpret_kernel(name):
    """5 f32 steps against JAX's interpret K1 with its fused bind/jump
    candidates: topology exact, positions atol 1e-5 A."""
    got, js = _reactive_run(f"{ROOT}/examples/{name}", "f32", 5)
    assert int(got["n_bond"]) > 0 if name == "reactive_polymer" \
        else int(got["n_jump"]) > 0
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=1e-5)


# --- the cell-block engines and Ewald ---

@pytest.fixture(scope="module")
def argon_deck_d012(tmp_path_factory):
    """1,728 Ar atoms from the liquid_argon deck's writer, at 0.012
    atoms/A^3 with a 4 A cutoff: the smallest shape that keeps the
    cell-block cost (13^3 cells of a few slots) under the padded N^2, so
    that "block" stays "block" and "pallas" takes the stacked pass."""
    from aztotmd_tpu_torch.systems import write_liquid_argon_deck
    d = str(tmp_path_factory.mktemp("argon1728"))
    write_liquid_argon_deck(d, n_side=12, density=0.012, rcut=4.0, steps=40)
    return d


def _engine_run(deck, dtype, n, engine):
    j = j_load_deck_dir(deck, dtype=dtype, pair_engine=engine)
    p = load_deck_dir(deck, dtype=dtype, pair_engine=engine)
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], n)
    got = convert.state_to_numpy(
        make_multi_step(p["cfg"], p["aux"])(p["state"], p["ff"], n))
    assert int(got["step"]) == n
    assert int(got["cell_overflow"]) == int(js.cell_overflow)
    return got, js, p["cfg"]


_TERMS = ("kin", "vdw", "coul1", "coul2", "coul3", "pot", "tot")


def _check_terms(got, js, pos_atol, rel):
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=pos_atol)
    for k in _TERMS:
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=rel, abs=1e-12), k
    for k in ("chit", "consint"):
        assert float(got[k]) == pytest.approx(float(getattr(js, k)),
                                              rel=max(rel, 1e-8)), k


@pytest.mark.parametrize("engine", ["block", "pallas"])
def test_10_argon_steps_f64_match_jax(argon_deck_d012, engine):
    """10 f64 Nose-Hoover steps of the small liquid-argon deck on the
    block engine and on the pallas engine, whose f64 route is the block
    engine too: positions atol 1e-8 A, every energy term rel 1e-9."""
    got, js, cfg = _engine_run(argon_deck_d012, "f64", 10, engine)
    assert cfg.pair_engine == engine
    _check_terms(got, js, 1e-8, 1e-9)
    assert int(got["cell_overflow"]) > 0


@pytest.mark.parametrize("engine", ["block", "pallas"])
def test_10_argon_steps_f32_match_jax(argon_deck_d012, engine):
    """f32: on "pallas" JAX runs its stacked Pallas kernel in interpret
    mode and the port the stacked pass's plain version; rel 1e-4."""
    from aztotmd_tpu_torch.ops.allpairs import pallas_branch
    got, js, cfg = _engine_run(argon_deck_d012, "f32", 10, engine)
    assert cfg.pair_engine == engine
    if engine == "pallas":
        assert pallas_branch(cfg, torch.float32) == "stacked"
    _check_terms(got, js, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype,pos_atol,rel", [("f64", 1e-8, 1e-9),
                                                ("f32", 1e-4, 1e-4)])
def test_10_molten_salt_steps_match_jax(dtype, pos_atol, rel):
    """examples/molten_salt at full size (1,728 ions, Tosi-Fumi, Ewald
    with 1,195 k-vectors, Nose-Hoover with the equilibration rescale at
    step 0): K1's route plus the reciprocal sum."""
    deck = f"{ROOT}/examples/molten_salt"
    got, js, cfg = _engine_run(deck, dtype, 10, "auto")
    assert cfg.pair_engine == "pallas" and cfg.n_equil == 1000
    _check_terms(got, js, pos_atol, rel)
    assert abs(float(got["energies"]["coul2"])) > 1e-3
    assert float(got["energies"]["coul3"]) == pytest.approx(
        cfg.eng_ewald_const, rel=1e-6)
