"""The "gather" engine (``ops/pairs.py::pair_forces``: every atom's
stencil-cell candidates as an (N, S * cap) matrix) against the JAX
package's, on the CPU, on numpy-seeded systems (``systems.clustered_specs``,
``liquid_argon_specs``, ``reactive_specs``).  It is the same operations
on both sides: f64 forces atol 1e-10 * max|F| and energies rel 1e-12;
f32 forces atol 3e-5 * max|F| and energies rel 1e-4 (sums taken in
another order); ``max_occ`` and the bind/jump candidate ids exact, their
r2 to rounding.  Then 20 steps of a deck with ``pair_engine="gather"``
through ``load_deck_dir`` and ``make_multi_step`` against JAX's (f64
positions within 1e-8 A; f32 within 1e-4 A, energies rel 1e-4), and 20
through the runner."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.core.ffield import build_forcefield as j_build_forcefield
from aztotmd_tpu.ops import pairs as j_pairs
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.runtime.step import make_multi_step as j_make_multi_step
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.ops import pairs
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import PAIR_ENGINES, make_multi_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(specs, dtype, parents=None, cap=None):
    """(JAX cfg, ff, arrays) and (port cfg, ff, tensors) of one spec on
    the gather engine; ``cap`` cuts the cell capacity in both."""
    ctl, f, box, pos, types, rad = specs
    npdt = np.float64 if dtype == "f64" else np.float32
    jcfg = j_build_sim_config(ctl, f, (box, box, box), len(pos),
                              dtype=dtype, pos=pos, pair_engine="gather")
    jff = j_build_forcefield(f, ctl.t_step, eps=ctl.elec.eps, dtype=npdt)
    cfg, ff, tp, tt, tr = systems.pair_system(specs, dtype,
                                              pair_engine="gather")
    assert cfg.pair_engine == "gather"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if cap is not None:
        cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid,
                                                                cap=cap))
        jcfg = dataclasses.replace(jcfg, grid=dataclasses.replace(
            jcfg.grid, cap=cap))
    jargs = (jnp.asarray(np.asarray(pos, npdt)), jnp.asarray(types),
             jnp.asarray(np.asarray(rad, npdt)) if rad is not None else None,
             jnp.asarray(parents) if parents is not None else None)
    targs = (tp, tt, tr,
             torch.as_tensor(parents) if parents is not None else None)
    return (jcfg, jff, jargs), (cfg, ff, targs)


def _check_forces(jr, pr, dtype):
    jf = np.asarray(jr.frc)
    scale = float(np.abs(jf).max()) or 1.0
    atol, rel = (1e-10, 1e-12) if dtype == "f64" else (3e-5, 1e-4)
    assert pr.frc.dtype == (torch.float64 if dtype == "f64"
                            else torch.float32)
    np.testing.assert_allclose(pr.frc.numpy(), jf, rtol=0, atol=atol * scale)
    for k in ("eng_vdw", "eng_coul"):
        assert float(getattr(pr, k)) == pytest.approx(
            float(getattr(jr, k)), rel=rel,
            abs=1e-6 if dtype == "f32" else 1e-14), k
    assert int(pr.max_occ) == int(jr.max_occ)


def _check_cands(jr, pr, n, dtype):
    for name in ("bind", "jump"):
        ji = np.asarray(getattr(jr, name + "_idx"))
        np.testing.assert_array_equal(getattr(pr, name + "_idx").numpy(), ji,
                                      err_msg=name)
        jr2 = np.asarray(getattr(jr, name + "_r2"))
        pr2 = getattr(pr, name + "_r2").numpy()
        fin = ji < n
        np.testing.assert_array_equal(np.isfinite(pr2), fin)
        np.testing.assert_allclose(pr2[fin], jr2[fin], atol=0,
                                   rtol=1e-12 if dtype == "f64" else 2.4e-7)


def test_gather_is_a_step_engine():
    """The step routes "gather" to ``ops.pairs.pair_forces``, as JAX's
    routes every engine it does not name."""
    assert PAIR_ENGINES["gather"] is pairs.pair_forces


_CASES = [(1, 0, False), (1, 0, True), (2, 1, False), (3, 2, True),
          (3, 3, True)]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("nsp,elec,radii", _CASES)
def test_gather_matches_jax(dtype, nsp, elec, radii):
    """1-3 species, none/direct/Ewald-real/Fennel Coulomb, radii."""
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.clustered_specs(nsp=nsp, elec=elec, radii=radii), dtype)
    jr = jax.jit(lambda p, t: j_pairs.pair_forces(
        jcfg, jff, p, t, radii=jargs[2]))(*jargs[:2])
    pr = pairs.pair_forces(cfg, ff, *targs[:3])
    _check_forces(jr, pr, dtype)
    assert abs(float(pr.eng_vdw)) > 1e-3
    if elec:
        assert abs(float(pr.eng_coul)) > 1e-3
    assert (pr.bind_idx == cfg.n_at).all() and (pr.jump_idx == cfg.n_at).all()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_gather_max_occ_and_overflow_match_jax(dtype):
    """The uniform argon fluid, and the same with the cell capacity below
    the fullest cell: ``max_occ`` is the fullest cell's occupancy in both,
    and the atoms the table drops are the same ones."""
    specs = systems.liquid_argon_specs(n_atoms=500, density=0.021,
                                       rcut=8.5, seed=3)
    full = _both(specs, dtype)
    occ = None
    for cap in (None, full[1][0].grid.cap // 3):
        (jcfg, jff, jargs), (cfg, ff, targs) = _both(specs, dtype, cap=cap)
        jr = j_pairs.pair_forces(jcfg, jff, *jargs[:2])
        pr = pairs.pair_forces(cfg, ff, *targs[:2])
        _check_forces(jr, pr, dtype)
        occ = int(pr.max_occ) if occ is None else occ
        assert int(pr.max_occ) == occ > cfg.grid.cap // 3
        if cap is not None:
            assert occ > cap


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("want", ["both", "bind", "jump"])
def test_gather_candidates_match_jax(dtype, want):
    """Bind and jump candidates on the three-species reactive system with
    random parents: ids exact, r2 to rounding."""
    n = 400
    rng = np.random.default_rng(12)
    par = np.where(rng.uniform(size=n) < 0.4, rng.integers(0, n, n),
                   -1).astype(np.int32)
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.reactive_specs(n, seed=5), dtype, parents=par)
    kw = dict(want_bind=want != "jump", want_jump=want != "bind")
    jr = jax.jit(lambda p, t, pa: j_pairs.pair_forces(
        jcfg, jff, p, t, parents=pa, **kw))(jargs[0], jargs[1], jargs[3])
    pr = pairs.pair_forces(cfg, ff, targs[0], targs[1], None, targs[3], **kw)
    _check_forces(jr, pr, dtype)
    _check_cands(jr, pr, n, dtype)
    if want != "jump":
        assert 0 < int((pr.bind_idx < n).sum()) < n
    if want != "bind":
        assert 0 < int((pr.jump_idx < n).sum()) < n


@pytest.fixture(scope="module")
def argon(tmp_path_factory):
    """1,728 Ar atoms of the liquid_argon deck's writer at 0.012
    atoms/A^3 with a 4 A cutoff (Nose-Hoover)."""
    d = str(tmp_path_factory.mktemp("argon_gather"))
    systems.write_liquid_argon_deck(d, n_side=12, density=0.012, rcut=4.0,
                                    steps=40)
    return d


def _gather_run(deck, dtype, n):
    j = j_load_deck_dir(deck, dtype=dtype, pair_engine="gather")
    p = load_deck_dir(deck, dtype=dtype, pair_engine="gather")
    assert p["cfg"].pair_engine == j["cfg"].pair_engine == "gather"
    js = j_make_multi_step(j["cfg"], j["aux"])(j["state"], j["ff"], n)
    got = convert.state_to_numpy(
        make_multi_step(p["cfg"], p["aux"])(p["state"], p["ff"], n))
    assert int(got["step"]) == n
    assert int(got["cell_overflow"]) == int(js.cell_overflow) > 0
    return got, js


@pytest.mark.parametrize("dtype,pos_atol,rel", [("f64", 1e-8, 1e-9),
                                                ("f32", 1e-4, 1e-4)])
def test_20_gather_steps_match_jax(argon, dtype, pos_atol, rel):
    got, js = _gather_run(argon, dtype, 20)
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=pos_atol)
    for k in ("kin", "vdw", "pot", "tot"):
        assert float(got["energies"][k]) == pytest.approx(
            float(getattr(js.energies, k)), rel=rel, abs=1e-12), k


def test_20_reactive_gather_steps_match_jax():
    """examples/reactive_polymer on "gather": bonds form from the
    engine's bind candidates; 20 f64 steps with the topology exact."""
    got, js = _gather_run(os.path.join(ROOT, "examples", "reactive_polymer"),
                          "f64", 20)
    for name in ("n_bond", "bond_at1", "bond_at2", "parents", "types"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert int(got["n_bond"]) > 0
    np.testing.assert_allclose(got["pos"], np.asarray(js.pos), rtol=0,
                               atol=1e-8)


def test_gather_runs_through_the_runner(argon, tmp_path):
    """``run`` of the deck on "gather" in the port's runner: 20 steps,
    finite stat rows, the cell monitor within its capacity."""
    r = MDRunner(load_deck_dir(argon, pair_engine="gather", device="cpu"),
                 out_dir=str(tmp_path), quiet=True)
    r.run(20)
    r.finalize()
    assert r.cfg.pair_engine == "gather" and int(r.state.step) == 20
    assert bool(torch.isfinite(r.state.pos).all())
    assert 0 < int(r.state.cell_overflow) <= r.cfg.grid.cap
