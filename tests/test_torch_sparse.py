"""The Morton block-sparse pair pass: the port's plain version (the CPU
route of ``pair_forces_sparse``) against the JAX package.

Inputs are the multi-cluster systems of ``systems.multi_cluster_specs``
(~1,500 atoms in five 12 A clusters, one wrapping the box corner), drawn
from numpy seeds.  JAX runs its Pallas kernel in interpret mode with
tile=128, as tests/test_sparse.py does.

Tolerances: Morton codes, the sort and the worklist are integers and
must be equal exactly (they decide which atoms share a tile and so the
overflow monitor ``max_occ``).  f32 forces atol 3e-5 * max|F| and
energies rel 1e-4: f32 sums taken in another order on the two sides
(tests/test_pallas.py).  f64 against JAX's f64 route (its XLA cell-block
engine) rtol 1e-9 with atol 1e-9 * max|F|: the same physics summed in
another order, and a force component that cancels to ~0 has no relative
scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.core.ffield import build_forcefield as j_build_forcefield
from aztotmd_tpu.ops import pallas_sparse as j_sparse
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.ops import sparse

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

TILE = 128


def _both(specs, dtype="f32"):
    """(JAX cfg, ff, arrays) and (port cfg, ff, tensors) of one spec, the
    engine forced to "sparse"."""
    ctl, f, box, pos, types, rad = specs
    npdt = np.float64 if dtype == "f64" else np.float32
    jcfg = j_build_sim_config(ctl, f, (box, box, box), len(pos),
                              dtype=dtype, pos=pos, pair_engine="sparse")
    jff = j_build_forcefield(f, ctl.t_step, dtype=npdt)
    jargs = (jnp.asarray(np.asarray(pos, npdt)), jnp.asarray(types),
             jnp.asarray(np.asarray(rad, npdt)) if rad is not None else None)
    cfg, ff, *targs = systems.pair_system(specs, dtype, pair_engine="sparse")
    return (jcfg, jff, jargs), (cfg, ff, targs)


def _jax_kernel(jcfg, jff, jargs, **kw):
    pos, types, rad = jargs
    return jax.jit(lambda p, t: j_sparse.pair_forces_sparse(
        jcfg, jff, p, t, radii=rad, interpret=True, tile=TILE, **kw))(
        pos, types)


def _check_f32(jr, pr):
    jf = np.asarray(jr.frc)
    scale = float(np.abs(jf).max()) or 1.0
    np.testing.assert_allclose(pr.frc.numpy(), jf, rtol=0, atol=3e-5 * scale)
    assert float(pr.eng_vdw) == pytest.approx(float(jr.eng_vdw), rel=1e-4,
                                              abs=1e-6)
    assert float(pr.eng_coul) == pytest.approx(float(jr.eng_coul), rel=1e-4,
                                               abs=1e-6)
    assert int(pr.max_occ) == int(jr.max_occ)


@pytest.fixture(scope="module")
def lj_pair():
    return _both(systems.multi_cluster_specs(n_atoms=1500, nsp=1, elec=0))


def test_morton_codes_and_sort_equal(lj_pair):
    (jcfg, _, jargs), (cfg, _, targs) = lj_pair
    jc = np.asarray(j_sparse.morton_codes(jcfg.box, jcfg.r_max, jargs[0]))
    pc = sparse.morton_codes(cfg.box, cfg.r_max, targs[0])
    assert pc.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), jc)
    # many atoms share a code: the sort must keep JAX's (stable) tie order
    assert len(np.unique(jc)) < len(jc)
    S = sparse.sort_tiles(cfg, *targs, tile=TILE)
    np.testing.assert_array_equal(S.perm.numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(jc))))


@pytest.mark.parametrize("cut", [1, 3], ids=["full", "truncated"])
def test_tile_worklist_equal(lj_pair, cut):
    """it, jt, first, vp and n_need from the same sorted tiles, with the
    full capacity and with a third of it (the port keeps CSR rows instead
    of JAX's ``first`` flags; they follow from ``it``)."""
    (jcfg, _, _), (cfg, _, targs) = lj_pair
    S = sparse.sort_tiles(cfg, *targs, tile=TILE)
    cap = S.pair_cap // cut
    valid = (S.gid >= 0).to(torch.int32)
    it, jt, vp, n_need = sparse._tile_worklist(
        cfg.box, cfg.r2_max, S.x, S.y, S.z, valid, S.n_t, S.T, cap)
    first = torch.cat([torch.ones(1, dtype=torch.int32),
                       (it[1:] != it[:-1]).to(torch.int32)])
    got = (it, jt, first, vp, n_need)
    ref = j_sparse._tile_worklist(
        jcfg.box, jcfg.r2_max, *(jnp.asarray(a.numpy())
                                 for a in (S.x, S.y, S.z, valid)),
        S.n_t, S.T, cap)
    for name, a, b in zip(("it", "jt", "first", "vp", "n_need"), got, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got[4]) > cap or cut == 1
    # CSR rows: the valid entries of i tile t are row_ptr[t]..row_ptr[t+1]
    if cut == 1:
        rp = S.row_ptr.numpy()
        it = S.it.numpy()[:int(S.n_need)]
        np.testing.assert_array_equal(np.diff(rp),
                                      np.bincount(it, minlength=S.n_t))


@pytest.mark.parametrize("nsp,elec,radii", [(1, 0, False), (2, 1, False),
                                            (3, 2, True), (3, 3, True)])
def test_plain_f32_matches_jax_kernel(nsp, elec, radii):
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.multi_cluster_specs(n_atoms=1500, nsp=nsp, elec=elec,
                                    radii=radii))
    jr = _jax_kernel(jcfg, jff, jargs)
    before = sparse.launches
    pr = sparse.pair_forces_sparse(cfg, ff, *targs, tile=TILE)  # CPU: plain
    assert sparse.launches == before
    _check_f32(jr, pr)
    if elec:
        assert abs(float(pr.eng_coul)) > 1e-3


def test_truncated_worklist(lj_pair):
    """A capacity below need: max_occ still reports the need, tiles no
    entry visits get exactly zero force, and the truncated forces match
    JAX's truncated kernel."""
    (jcfg, jff, jargs), (cfg, ff, targs) = lj_pair
    full = sparse.pair_forces_sparse_plain(cfg, ff, *targs, tile=TILE)
    need = int(full.max_occ)
    cap = need // 2
    cut = sparse.pair_forces_sparse_plain(cfg, ff, *targs, tile=TILE,
                                          pair_cap=cap)
    assert int(cut.max_occ) == need
    S = sparse.sort_tiles(cfg, *targs, tile=TILE, pair_cap=cap)
    unvisited = np.diff(S.row_ptr.numpy()) == 0
    assert unvisited.any()
    slot_tile = np.repeat(np.arange(S.n_t), S.T)[:cfg.n_at]
    atoms = S.perm.numpy()[unvisited[slot_tile]]
    assert np.all(cut.frc.numpy()[atoms] == 0.0)
    assert not np.allclose(cut.frc.numpy(), full.frc.numpy())
    _check_f32(_jax_kernel(jcfg, jff, jargs, pair_cap=cap), cut)


def test_plain_f64_matches_jax_f64_route():
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.multi_cluster_specs(n_atoms=400, n_clusters=3, box=60.0,
                                    nsp=2, elec=3, radii=True), "f64")
    jr = jax.jit(lambda p, t: j_sparse.pair_forces_sparse(
        jcfg, jff, p, t, radii=jargs[2]))(*jargs[:2])
    pr = sparse.pair_forces_sparse(cfg, ff, *targs)
    assert pr.frc.dtype == torch.float64
    jf = np.asarray(jr.frc)
    scale = float(np.abs(jf).max())
    np.testing.assert_allclose(pr.frc.numpy(), jf, rtol=1e-9,
                               atol=1e-9 * scale)
    assert float(pr.eng_vdw) == pytest.approx(float(jr.eng_vdw), rel=1e-9)
    assert float(pr.eng_coul) == pytest.approx(float(jr.eng_coul), rel=1e-9)


def _reactive_both(n_atoms, engine, seed=3, specs=None):
    """(JAX cfg, ff, arrays) and (port cfg, ff, tensors) of the
    three-species bind/jump system (or ``specs``), with random parents
    (40% of atoms)."""
    specs = specs or systems.reactive_specs(n_atoms, seed=seed)
    ctl, f, box, pos, types, _ = specs
    jcfg = j_build_sim_config(ctl, f, (box, box, box), n_atoms, dtype="f32",
                              pos=pos, pair_engine=engine)
    jff = j_build_forcefield(f, ctl.t_step, eps=ctl.elec.eps,
                             dtype=np.float32)
    cfg, ff, tp, tt, _ = systems.pair_system(specs, pair_engine=engine)
    rng = np.random.default_rng(seed + 1)
    par = np.where(rng.uniform(size=n_atoms) < 0.4,
                   rng.integers(0, n_atoms, n_atoms), -1).astype(np.int32)
    return ((jcfg, jff, (jnp.asarray(np.float32(pos)), jnp.asarray(types),
                         jnp.asarray(par))),
            (cfg, ff, (tp, tt, torch.as_tensor(par))))


def check_candidates(jr, pr, n):
    """Candidate ids exact (and present), r2 rel 2.4e-7 (two f32 ulps:
    the r2 sums are taken with other roundings), forces and energies as
    ``_check_f32``."""
    for name in ("bind", "jump"):
        ji = np.asarray(getattr(jr, name + "_idx"))
        np.testing.assert_array_equal(getattr(pr, name + "_idx").numpy(), ji)
        assert 0 < int(np.sum(ji < n)) < n, name
        jr2 = np.asarray(getattr(jr, name + "_r2"))
        pr2 = getattr(pr, name + "_r2").numpy()
        np.testing.assert_array_equal(np.isfinite(pr2), ji < n)
        fin = ji < n
        np.testing.assert_allclose(pr2[fin], jr2[fin], rtol=2.4e-7, atol=0)
    jf = np.asarray(jr.frc)
    np.testing.assert_allclose(pr.frc.numpy(), jf, rtol=0,
                               atol=3e-5 * float(np.abs(jf).max()))
    for k in ("eng_vdw", "eng_coul"):
        assert float(getattr(pr, k)) == pytest.approx(
            float(getattr(jr, k)), rel=1e-4), k


@pytest.mark.parametrize("want", ["jump", "both"])
def test_plain_candidates_match_jax_kernel(want):
    """K4-cand: the plain sparse pass with bind/jump candidates against
    JAX's interpret kernel on a 1,200-atom system (T=128): candidate ids
    exact, max_occ exact."""
    n = 1200
    (jcfg, jff, (jp, jt, jpar)), (cfg, ff, (tp, tt, tpar)) = _reactive_both(
        n, "sparse")
    kw = dict(want_bind=want != "jump", want_jump=want != "bind")
    jr = jax.jit(lambda p, t, pa: j_sparse.pair_forces_sparse(
        jcfg, jff, p, t, parents=pa, interpret=True, tile=TILE, **kw))(
        jp, jt, jpar)
    pr = sparse.pair_forces_sparse(cfg, ff, tp, tt, None, tpar, tile=TILE,
                                   **kw)
    assert int(pr.max_occ) == int(jr.max_occ)
    if want == "both":
        check_candidates(jr, pr, n)
    for name in ("bind_idx", "jump_idx"):
        np.testing.assert_array_equal(getattr(pr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
