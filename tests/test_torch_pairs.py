"""The dense pair pass: the port's plain version against the JAX package.

f32: against the Pallas all-pairs kernel in interpret mode, with the
tolerance of tests/test_pallas.py (forces atol 3e-5 * max|F|, energies
rel 1e-4: f32 sums taken in another order).  f64: against the XLA
oracle ``all_pairs_forces`` at rtol 1e-10 (forces also atol 1e-10 *
max|F|, since a component that cancels to ~0 has no relative scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.core.ffield import build_forcefield as j_build_forcefield
from aztotmd_tpu.ops import pairs as j_pairs
from aztotmd_tpu.ops.pallas_pair import pair_forces_allpairs as j_allpairs
from aztotmd_tpu.ops.pallas_pair import pair_forces_pallas as j_pallas
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.ops import allpairs, pairs
from aztotmd_tpu_torch.ops.allpairs import (pair_forces_allpairs,
                                            pair_forces_allpairs_plain)

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them (these
# systems are a few hundred atoms).
torch.set_num_threads(1)


def _both(specs, dtype):
    """(JAX cfg, ff, arrays) and (port cfg, ff, tensors) from one spec."""
    ctl, f, box, pos, types, rad = specs
    npdt = np.float64 if dtype == "f64" else np.float32
    jcfg = j_build_sim_config(ctl, f, (box, box, box), len(pos),
                              dtype=dtype, pos=pos, pair_engine="pallas")
    jff = j_build_forcefield(f, ctl.t_step, dtype=npdt)
    jargs = (jnp.asarray(np.asarray(pos, npdt)), jnp.asarray(types),
             jnp.asarray(np.asarray(rad, npdt)) if rad is not None else None)
    cfg, ff, *targs = systems.pair_system(specs, dtype)
    return (jcfg, jff, jargs), (cfg, ff, targs)


def _check_f32(jr, pr):
    jf = np.asarray(jr.frc)
    scale = float(np.abs(jf).max()) or 1.0
    np.testing.assert_allclose(pr.frc.numpy(), jf, rtol=0, atol=3e-5 * scale)
    assert float(pr.eng_vdw) == pytest.approx(float(jr.eng_vdw), rel=1e-4,
                                              abs=1e-6)
    assert float(pr.eng_coul) == pytest.approx(float(jr.eng_coul), rel=1e-4,
                                               abs=1e-6)


def _jax_kernel(jcfg, jff, jargs, **kw):
    pos, types, rad = jargs
    return jax.jit(lambda p, t: j_allpairs(jcfg, jff, p, t, radii=rad,
                                           interpret=True, **kw))(pos, types)


@pytest.mark.parametrize("nsp,elec,radii", [(1, 0, False), (1, 0, True),
                                            (2, 1, False), (3, 2, True),
                                            (3, 3, True)])
def test_plain_f32_matches_jax_kernel(nsp, elec, radii):
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.clustered_specs(nsp=nsp, elec=elec, radii=radii), "f32")
    jr = _jax_kernel(jcfg, jff, jargs)
    before = allpairs.launches
    pr = pair_forces_allpairs(cfg, ff, *targs)     # CPU tensor -> plain
    assert allpairs.launches == before
    _check_f32(jr, pr)
    if elec:
        assert abs(float(pr.eng_coul)) > 1e-3


@pytest.mark.parametrize("fam", sorted(systems.FAMILY_PARAMS))
def test_plain_f32_every_vdw_family(fam):
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.family_specs(fam), "f32")
    jr = _jax_kernel(jcfg, jff, jargs)
    pr = pair_forces_allpairs_plain(cfg, ff, *targs)
    _check_f32(jr, pr)
    assert abs(float(pr.eng_vdw)) > 1e-3


def test_plain_f32_multitile_and_row_blocks():
    """N over several kernel tiles, and the plain version's row blocking
    (rows not dividing N) against one block."""
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.clustered_specs(n_atoms=600, radii=True), "f32")
    jr = _jax_kernel(jcfg, jff, jargs, tile=256)
    pr = pair_forces_allpairs_plain(cfg, ff, *targs, rows=77)
    _check_f32(jr, pr)
    one = pair_forces_allpairs_plain(cfg, ff, *targs, rows=600)
    np.testing.assert_array_equal(pr.frc.numpy(), one.frc.numpy())


@pytest.mark.parametrize("nsp,elec,radii", [(1, 0, True), (2, 1, False),
                                            (3, 2, True), (3, 3, True)])
def test_plain_f64_matches_xla_oracle(nsp, elec, radii):
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.clustered_specs(nsp=nsp, elec=elec, radii=radii), "f64")
    jr = j_pairs.all_pairs_forces(jcfg, jff, *jargs)
    pr = pair_forces_allpairs_plain(cfg, ff, *targs)
    jf = np.asarray(jr.frc)
    scale = float(np.abs(jf).max())
    np.testing.assert_allclose(pr.frc.numpy(), jf, rtol=1e-10,
                               atol=1e-10 * scale)
    assert float(pr.eng_vdw) == pytest.approx(float(jr.eng_vdw), rel=1e-10)
    assert float(pr.eng_coul) == pytest.approx(float(jr.eng_coul), rel=1e-10,
                                               abs=1e-12)
    # the port's own oracle agrees too
    orc = pairs.all_pairs_forces(cfg, ff, *targs)
    np.testing.assert_allclose(orc.frc.numpy(), jf, rtol=1e-10,
                               atol=1e-10 * scale)


def test_dense_engine_choice_raises_for_cell_block_decks():
    """A deck whose modeled cell-block cost is below the dense N^2 cost
    leaves the dense kernel and no longer raises: on the same grid (the
    capacity cut to the fullest cell's 8 atoms) both dispatchers take the
    stacked cell-block pass, with JAX's forces and energies at the f32
    tolerance and its ``max_occ``."""
    import dataclasses
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.family_specs("lnjs"), "f32")
    assert allpairs.pallas_branch(cfg, torch.float32) == "allpairs"
    cheap = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid,
                                                              cap=8))
    jcheap = dataclasses.replace(jcfg, grid=dataclasses.replace(jcfg.grid,
                                                                cap=8))
    assert allpairs.block_cost(cheap) < allpairs.allpairs_cost(cheap)
    assert allpairs.pallas_branch(cheap, torch.float32) == "stacked"
    jr = jax.jit(lambda p, t: j_pallas(jcheap, jff, p, t,
                                       interpret=True))(*jargs[:2])
    pr = allpairs.pair_forces_pallas(cheap, ff, *targs)
    _check_f32(jr, pr)
    assert abs(float(pr.eng_vdw)) > 1e-3
    assert int(pr.max_occ) == int(jr.max_occ) == 8


@pytest.mark.parametrize("n,want", [(300, "both"), (300, "bind"),
                                    (257, "jump")])
def test_plain_candidates_match_jax_kernel(n, want):
    """K1-cand: the plain dense pass with bind/jump candidates (and
    parents) against JAX's interpret kernel on the three-species system
    with direct Coulomb, N ragged against the 128/256 tiles: candidate
    ids exact, r2 rel 2.4e-7, forces and energies as above."""
    from test_torch_sparse import _reactive_both, check_candidates
    (jcfg, jff, (jp, jt, jpar)), (cfg, ff, (tp, tt, tpar)) = _reactive_both(
        n, "pallas", seed=n)
    kw = dict(want_bind=want != "jump", want_jump=want != "bind")
    jr = jax.jit(lambda p, t, pa: j_allpairs(
        jcfg, jff, p, t, parents=pa, interpret=True, **kw))(jp, jt, jpar)
    pr = pair_forces_allpairs(cfg, ff, tp, tt, None, tpar, **kw)
    if want == "both":
        check_candidates(jr, pr, n)
    for name in ("bind_idx", "jump_idx"):
        np.testing.assert_array_equal(getattr(pr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    # the row chunking does not change the choice
    again = pair_forces_allpairs_plain(cfg, ff, tp, tt, None, tpar, rows=61,
                                       **kw)
    for name in ("bind_idx", "jump_idx", "bind_r2", "jump_r2"):
        assert torch.equal(getattr(again, name), getattr(pr, name)), name


@pytest.mark.parametrize("engine", ["pallas", "sparse"])
def test_candidate_ties_follow_the_tpu_kernel(engine):
    """Exact r2 ties: 300 atoms on the sites of an exact 2 A lattice, so
    each row sees several partners at the same r2 (4 and 8 A^2).  The TPU
    kernels keep the first j tile they meet, then the lowest species,
    then the lowest id; the plain passes give the same ids."""
    from test_torch_sparse import _reactive_both
    ctl, f, _, _, types, _ = systems.reactive_specs(300, seed=11)
    rng = np.random.default_rng(11)
    g = np.arange(9) * 2.0 + 1.0
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = sites[np.sort(rng.permutation(len(sites))[:300])]
    (jcfg, jff, (jp, jt, jpar)), (cfg, ff, (tp, tt, tpar)) = _reactive_both(
        300, engine, specs=(ctl, f, 18.0, pos, types, None))
    kw = dict(want_bind=True, want_jump=True)
    if engine == "pallas":
        jr = jax.jit(lambda p, t, pa: j_allpairs(
            jcfg, jff, p, t, parents=pa, interpret=True, **kw))(jp, jt, jpar)
        pr = pair_forces_allpairs(cfg, ff, tp, tt, None, tpar, **kw)
    else:
        from aztotmd_tpu.ops.pallas_sparse import pair_forces_sparse as js
        from aztotmd_tpu_torch.ops.sparse import pair_forces_sparse
        jr = jax.jit(lambda p, t, pa: js(
            jcfg, jff, p, t, parents=pa, interpret=True, tile=128, **kw))(
            jp, jt, jpar)
        pr = pair_forces_sparse(cfg, ff, tp, tt, None, tpar, tile=128, **kw)
    r2 = pr.bind_r2.numpy()
    assert np.sum(r2 == 4.0) > 20          # many rows choose among ties
    for name in ("bind_idx", "jump_idx", "bind_r2", "jump_r2"):
        np.testing.assert_array_equal(getattr(pr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    from aztotmd_tpu_torch.ops.pairs import keyed_row_min
    m, k = keyed_row_min(torch.tensor([[4.0, 1.0, 1.0, 2.0]]),
                         torch.tensor([[True, True, True, False]]),
                         torch.tensor([[9, 7, 5, 1]]))
    assert float(m) == 1.0 and int(k) == 5


def test_standalone_candidates_match_jax():
    """``bind_jump_candidates`` (the cell-list selection without the
    force work) against JAX's on the three-species system in f64, with
    parents: ids exact, r2 rel 1e-12; and the same ids as the dense
    pass's candidates."""
    from aztotmd_tpu_torch.ops.pairs import bind_jump_candidates
    n = 400
    specs = systems.reactive_specs(n, seed=5)
    ctl, f, box, pos, types, _ = specs
    jcfg = j_build_sim_config(ctl, f, (box,) * 3, n, dtype="f64", pos=pos,
                              pair_engine="pallas")
    jff = j_build_forcefield(f, ctl.t_step, eps=ctl.elec.eps,
                             dtype=np.float64)
    cfg, ff, tp, tt, _ = systems.pair_system(specs, "f64")
    rng = np.random.default_rng(6)
    par = np.where(rng.uniform(size=n) < 0.4, rng.integers(0, n, n),
                   -1).astype(np.int32)
    jr = j_pairs.bind_jump_candidates(jcfg, jff, jnp.asarray(pos),
                                      jnp.asarray(types), jnp.asarray(par))
    pr = pairs.bind_jump_candidates(cfg, ff, tp, tt, torch.as_tensor(par))
    for a, b in zip(pr, jr):
        b = np.asarray(b)
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a.numpy(), b)
            assert 0 < int(np.sum(b < n))
        else:
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a.numpy()), fin)
            np.testing.assert_allclose(a.numpy()[fin], b[fin], rtol=1e-12)
    dense = pair_forces_allpairs_plain(cfg, ff, tp, tt, None,
                                       torch.as_tensor(par), want_bind=True,
                                       want_jump=True)
    assert torch.equal(dense.bind_idx, pr[0])
    assert torch.equal(dense.jump_idx, pr[2])
