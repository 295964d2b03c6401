"""The cell-block engine, the ``pallas`` dispatcher and the stacked
cell-block pass: the port against the JAX package, on the CPU.

Inputs come from numpy seeds (``systems.liquid_argon_specs``,
``clustered_specs``, ``reactive_specs``, the example decks).  The binning
is integers and must be equal exactly: it decides which atoms a full cell
drops and the monitor ``max_occ``.  ``pair_forces_block`` is the same
operations on both sides: f64 forces atol 1e-10 * max|F|, energies rel
1e-12; f32 forces atol 3e-5 * max|F|, energies rel 1e-4 (sums taken in
another order); bind/jump candidate ids exact.  The stacked pass's plain
version is held against JAX's Pallas kernel in interpret mode with the
tolerance of tests/test_pallas.py (3e-5 * max|F|, rel 1e-4: the kernel
walks the Newton half stencil, the port the full one), ``max_occ`` exact.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.core.ffield import build_forcefield as j_build_forcefield
from aztotmd_tpu.ops import cellblock as j_cellblock
from aztotmd_tpu.ops import pallas_pair as j_pallas
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.ops import allpairs, cellblock
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(specs, dtype="f32", engine="block", parents=None):
    """(JAX cfg, ff, arrays) and (port cfg, ff, tensors) of one spec; the
    arrays are (pos, types, radii-or-None, parents-or-None)."""
    ctl, f, box, pos, types, rad = specs
    npdt = np.float64 if dtype == "f64" else np.float32
    jcfg = j_build_sim_config(ctl, f, (box, box, box), len(pos),
                              dtype=dtype, pos=pos, pair_engine=engine)
    jff = j_build_forcefield(f, ctl.t_step, eps=ctl.elec.eps, dtype=npdt)
    jargs = (jnp.asarray(np.asarray(pos, npdt)), jnp.asarray(types),
             jnp.asarray(np.asarray(rad, npdt)) if rad is not None else None,
             jnp.asarray(parents) if parents is not None else None)
    cfg, ff, tp, tt, tr = systems.pair_system(specs, dtype,
                                              pair_engine=engine)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
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
            float(getattr(jr, k)), rel=rel, abs=1e-6 if dtype == "f32"
            else 1e-14), k
    assert int(pr.max_occ) == int(jr.max_occ)


# --------------------------------------------------------------------------
# bin_atoms


def _crowded(cfg_pair, cap):
    """Both configs with the cell capacity cut to ``cap``."""
    (jcfg, jff, jargs), (cfg, ff, targs) = cfg_pair
    g = dataclasses.replace(cfg.grid, cap=cap)
    jg = dataclasses.replace(jcfg.grid, cap=cap)
    return ((dataclasses.replace(jcfg, grid=jg), jff, jargs),
            (dataclasses.replace(cfg, grid=g), ff, targs))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("cap", [None, 3], ids=["fits", "overflows"])
def test_bin_atoms_equals_jax(dtype, cap):
    """Slots, slot_of_atom, aid, valid, max_occ and an extra column, with
    the grid's own capacity and with one below the fullest cell, so that
    atoms are dropped; an atom a hair below 0 lands in a valid cell."""
    ctl, f, box, pos, types, _ = systems.clustered_specs(n_atoms=400)
    pos = pos.copy()
    pos[7] = (-1e-9, 5.0, box - 1e-9)
    pair = _both((ctl, f, box, pos, types, None), dtype)
    if cap is not None:
        pair = _crowded(pair, cap)
    (jcfg, _, (jp, jt, _, _)), (cfg, _, (tp, tt, _, _)) = pair
    jb = j_cellblock.bin_atoms(jcfg, jp, extra=[("types", jt, 0)])
    tb = cellblock.bin_atoms(cfg, tp, extra=[("types", tt, 0)])
    occ = int(jb["max_occ"])
    assert int(tb["max_occ"]) == occ
    assert (occ > cfg.grid.cap) == (cap is not None)
    # the port's table is cell-major (slot = cid * cap + rank), JAX's the
    # transpose (rank * n_cell + cid): same ranks, same drops
    c, n_cell = cfg.grid.cap, cfg.grid.n_cell
    for name in ("aid", "valid", "types", "x", "y", "z"):
        np.testing.assert_array_equal(
            tb[name].numpy(),
            np.asarray(jb[name]).reshape(c, n_cell).T.reshape(-1),
            err_msg=name)
    jsoa = np.asarray(jb["slot_of_atom"])
    want = np.where(jsoa == c * n_cell, c * n_cell,
                    (jsoa % n_cell) * c + jsoa // n_cell)
    np.testing.assert_array_equal(tb["slot_of_atom"].numpy(), want)
    dropped = tb["slot_of_atom"].numpy() == n_cell * c
    assert dropped.any() == (cap is not None)


def test_roll3_equals_jax():
    """The roll of the cell-major table against JAX's roll of its
    transposed one."""
    dims = (3, 4, 5)
    a = np.arange(2 * 60, dtype=np.int32)              # (cap=2, n_cell=60)
    at = torch.as_tensor(a.reshape(2, 60).T.reshape(-1).copy())
    for off in ((0, 0, 0), (1, 0, -1), (-1, 1, 1), (2, -3, 1)):
        np.testing.assert_array_equal(
            cellblock._roll3(at, off, dims).numpy(),
            np.asarray(j_cellblock._roll3(jnp.asarray(a), off, dims)
                       ).reshape(2, 60).T.reshape(-1))


# --------------------------------------------------------------------------
# pair_forces_block


_BLOCK_CASES = [(1, 0, False), (1, 0, True), (2, 1, False), (3, 2, True),
                (3, 3, True)]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("nsp,elec,radii", _BLOCK_CASES)
def test_block_matches_jax(dtype, nsp, elec, radii):
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.clustered_specs(nsp=nsp, elec=elec, radii=radii), dtype)
    jr = jax.jit(lambda p, t: j_cellblock.pair_forces_block(
        jcfg, jff, p, t, radii=jargs[2]))(*jargs[:2])
    pr = cellblock.pair_forces_block(cfg, ff, *targs[:3])
    _check_forces(jr, pr, dtype)
    assert abs(float(pr.eng_vdw)) > 1e-3
    if elec:
        assert abs(float(pr.eng_coul)) > 1e-3


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_block_uniform_fluid_and_overflow(dtype):
    """The uniform argon fluid (a 3-cell-wide grid with the full 27-cell
    stencil), and the same with a capacity below the fullest cell: the
    dropped atoms get exactly zero force on both sides."""
    pair = _both(systems.liquid_argon_specs(n_atoms=500, density=0.021,
                                            rcut=8.5, seed=3), dtype)
    for cut in (False, True):
        if cut:
            pair = _crowded(pair, int(pair[1][0].grid.cap) // 3)
        (jcfg, jff, jargs), (cfg, ff, targs) = pair
        jr = j_cellblock.pair_forces_block(jcfg, jff, *jargs[:2])
        pr = cellblock.pair_forces_block(cfg, ff, *targs[:2])
        _check_forces(jr, pr, dtype)
        gone = np.all(np.asarray(jr.frc) == 0.0, axis=1)
        assert gone.any() == cut
        np.testing.assert_array_equal(
            np.all(pr.frc.numpy() == 0.0, axis=1), gone)


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


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("want", ["both", "bind", "jump"])
def test_block_candidates_match_jax(dtype, want):
    """Bind and jump candidates of the block engine on the three-species
    system with random parents: ids exact (first j slot of a cell on a
    tie, stencil order with a strict <), r2 to rounding."""
    n = 400
    rng = np.random.default_rng(12)
    par = np.where(rng.uniform(size=n) < 0.4, rng.integers(0, n, n),
                   -1).astype(np.int32)
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.reactive_specs(n, seed=5), dtype, parents=par)
    kw = dict(want_bind=want != "jump", want_jump=want != "bind")
    jr = jax.jit(lambda p, t, pa: j_cellblock.pair_forces_block(
        jcfg, jff, p, t, parents=pa, **kw))(jargs[0], jargs[1], jargs[3])
    pr = cellblock.pair_forces_block(cfg, ff, targs[0], targs[1], None,
                                     targs[3], **kw)
    _check_forces(jr, pr, dtype)
    _check_cands(jr, pr, n, dtype)
    if want != "jump":
        assert 0 < int((pr.bind_idx < n).sum()) < n
    if want != "bind":
        assert 0 < int((pr.jump_idx < n).sum()) < n


def test_block_candidates_on_reactive_polymer_tiled_2x(tmp_path):
    """reactive_polymer tiled 2x2x2 (4,096 atoms) auto-selects the block
    engine in both packages; its bind candidates with the parents of a
    state that has bonds equal JAX's."""
    systems.tile_deck(os.path.join(ROOT, "examples", "reactive_polymer"),
                      str(tmp_path), 2)
    j = j_load_deck_dir(str(tmp_path))
    p = load_deck_dir(str(tmp_path))
    assert p["cfg"].pair_engine == j["cfg"].pair_engine == "block"
    assert dataclasses.asdict(p["cfg"]) == dataclasses.asdict(j["cfg"])
    n = p["cfg"].n_at
    rng = np.random.default_rng(2)
    par = np.where(rng.uniform(size=n) < 0.3, rng.integers(0, n, n),
                   -1).astype(np.int32)
    js, ps = j["state"], p["state"]
    jr = jax.jit(lambda pos, t, pa: j_cellblock.pair_forces_block(
        j["cfg"], j["ff"], pos, t, parents=pa, want_bind=True))(
        js.pos, js.types, jnp.asarray(par))
    pr = cellblock.pair_forces_block(p["cfg"], p["ff"], ps.pos, ps.types,
                                     None, torch.as_tensor(par),
                                     want_bind=True)
    _check_forces(jr, pr, "f32")
    _check_cands(jr, pr, n, "f32")
    assert int((pr.bind_idx < n).sum()) > 0


# --------------------------------------------------------------------------
# the dispatcher


def _stacked_cfg(dtype="f32", **kw):
    """The system of tests/test_pallas.py's stacked-kernel test: 2,048 Ar
    atoms at 0.012 atoms/A^3 with the engine set to "pallas"."""
    return _both(systems.liquid_argon_specs(**kw), dtype, engine="pallas")


def test_dispatcher_takes_jax_branches(monkeypatch):
    """Each case of the JAX dispatcher's order of tests: f64 -> block;
    dense cheaper -> K1; candidates, a 2-cell-wide grid or a wide stencil
    -> block; else the stacked pass.  The port's choice is read off
    ``pallas_branch`` and off the pass it calls."""
    _, (cfg, ff, targs) = _stacked_cfg()
    g = cfg.grid
    assert allpairs.block_cost(cfg) < allpairs.allpairs_cost(cfg)
    assert min(g.dims) >= 3 and cellblock.stacked_ok(g)
    f32, f64 = torch.float32, torch.float64
    assert allpairs.pallas_branch(cfg, f32) == "stacked"
    assert allpairs.pallas_branch(cfg, f64) == "block"
    assert allpairs.pallas_branch(cfg, f32, want_bind=True) == "block"
    assert allpairs.pallas_branch(cfg, f32, want_jump=True) == "block"
    two = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, dims=(2,) + g.dims[1:]))
    assert allpairs.pallas_branch(two, f32) == "block"
    wide = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, stencil=g.stencil + ((2, 0, 0),)))
    assert allpairs.pallas_branch(wide, f32) == "block"
    # dense cheaper: f64 still goes to the block engine first
    dense_cfg = systems.pair_system(systems.clustered_specs(), "f32")[0]
    assert allpairs.allpairs_cost(dense_cfg) < allpairs.block_cost(dense_cfg)
    assert allpairs.pallas_branch(dense_cfg, f32, want_bind=True) \
        == "allpairs"
    assert allpairs.pallas_branch(dense_cfg, f64) == "block"

    called = []
    for mod, name in ((allpairs, "pair_forces_allpairs"),
                      (cellblock, "pair_forces_stacked"),
                      (cellblock, "pair_forces_block")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            called.append(_n))
    allpairs.pair_forces_pallas(cfg, ff, *targs[:2])
    allpairs.pair_forces_pallas(cfg, ff, targs[0].double(), targs[1])
    allpairs.pair_forces_pallas(cfg, ff, *targs[:2], want_jump=True)
    allpairs.pair_forces_pallas(two, ff, *targs[:2])
    allpairs.pair_forces_pallas(dense_cfg, ff, *targs[:2])
    assert called == ["pair_forces_stacked", "pair_forces_block",
                      "pair_forces_block", "pair_forces_block",
                      "pair_forces_allpairs"]


def test_torch_engine_reason_names_each_route():
    """The line a run on the card prints when its pair pass is the torch
    cell-block engine: a reason for the block engine, f64, candidates and
    a grid outside the stacked pass; None where a kernel runs."""
    from aztotmd_tpu_torch.runtime.step import torch_engine_reason
    _, (cfg, _, _) = _stacked_cfg()
    g = cfg.grid
    f32, f64 = torch.float32, torch.float64
    assert torch_engine_reason(cfg, f32) is None                  # K3
    assert "f64" in torch_engine_reason(cfg, f64)
    assert "candidates" in torch_engine_reason(
        dataclasses.replace(cfg, ejtype=1), f32)
    two = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, dims=(2,) + g.dims[1:]))
    assert "grid (2, " in torch_engine_reason(two, f32)
    assert '"block"' in torch_engine_reason(
        dataclasses.replace(cfg, pair_engine="block"), f32)
    sparse_cfg = dataclasses.replace(cfg, pair_engine="sparse")
    assert torch_engine_reason(sparse_cfg, f32) is None           # K4
    assert "f64" in torch_engine_reason(sparse_cfg, f64)
    dense_cfg = systems.pair_system(systems.clustered_specs(), "f32")[0]
    assert torch_engine_reason(dense_cfg, f32) is None            # K1


def test_dispatcher_matches_jax_dispatcher_f64():
    """f64 through both dispatchers (each takes its block engine)."""
    (jcfg, jff, jargs), (cfg, ff, targs) = _stacked_cfg("f64", n_atoms=600)
    jr = j_pallas.pair_forces_pallas(jcfg, jff, *jargs[:2])
    pr = allpairs.pair_forces_pallas(cfg, ff, *targs[:2])
    _check_forces(jr, pr, "f64")
    assert int(pr.max_occ) > 0


# --------------------------------------------------------------------------
# the stacked pass


def test_half_and_full_stencil_order():
    """The half stencil is JAX's (own cell, then the lexicographically
    positive offsets in sorted order); the full stencil adds their
    negatives and is the grid's stencil as a set."""
    _, (cfg, _, _) = _stacked_cfg()
    g = cfg.grid
    half = cellblock.half_stencil(g)
    assert half == [(0, 0, 0)] + sorted(o for o in g.stencil
                                        if o > (0, 0, 0))
    assert len(half) == 14
    full = cellblock.full_stencil(g)
    assert full[0] == (0, 0, 0) and len(full) == 27
    assert set(full) == set(g.stencil)


@pytest.mark.parametrize("case", [
    dict(), dict(nsp=2, elec=3), dict(nsp=3, elec=2, radii=True)],
    ids=["argon", "nsp2-fennel", "nsp3-ewald-radii"])
def test_stacked_plain_matches_jax_interpret_kernel(case):
    """``pair_forces_stacked`` on CPU tensors (its plain version) against
    JAX's ``pair_forces_pallas(..., interpret=True)``, which takes the
    stacked branch on this system."""
    (jcfg, jff, jargs), (cfg, ff, targs) = _stacked_cfg(**case)
    assert allpairs.pallas_branch(cfg, torch.float32) == "stacked"
    jr = jax.jit(lambda p, t: j_pallas.pair_forces_pallas(
        jcfg, jff, p, t, radii=jargs[2], interpret=True))(*jargs[:2])
    before = cellblock.launches
    pr = allpairs.pair_forces_pallas(cfg, ff, *targs[:3])
    assert cellblock.launches == before          # CPU tensor: plain version
    _check_forces(jr, pr, "f32")
    assert abs(float(pr.eng_vdw)) > 1e-3
    if case.get("elec"):
        assert abs(float(pr.eng_coul)) > 1e-3
    # and against the port's block engine, as tests/test_pallas.py does
    orc = cellblock.pair_forces_block(cfg, ff, *targs[:3])
    scale = float(orc.frc.abs().max())
    np.testing.assert_allclose(pr.frc.numpy(), orc.frc.numpy(), rtol=0,
                               atol=3e-5 * scale)


def test_stacked_plain_overflow_drops_the_same_atoms():
    """A capacity below the fullest cell: ``max_occ`` is the occupancy and
    the dropped atoms get zero force, as in JAX's kernel."""
    pair = _crowded(_stacked_cfg(), 2)
    (jcfg, jff, jargs), (cfg, ff, targs) = pair
    assert allpairs.pallas_branch(cfg, torch.float32) == "stacked"
    jr = jax.jit(lambda p, t: j_pallas.pair_forces_pallas(
        jcfg, jff, p, t, interpret=True))(*jargs[:2])
    pr = cellblock.pair_forces_stacked_plain(cfg, ff, *targs[:2])
    _check_forces(jr, pr, "f32")
    assert int(pr.max_occ) > 2
    gone = np.all(np.asarray(jr.frc) == 0.0, axis=1)
    assert gone.any()
    np.testing.assert_array_equal(np.all(pr.frc.numpy() == 0.0, axis=1), gone)


def test_stacked_refuses_grids_it_cannot_shift():
    _, (cfg, ff, targs) = _stacked_cfg(n_atoms=600)
    g = cfg.grid
    two = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, dims=(2,) + g.dims[1:]))
    with pytest.raises(ValueError, match="3 cells a side"):
        cellblock.pair_forces_stacked(two, ff, *targs[:2])


# --------------------------------------------------------------------------
# f64 max_occ of the pallas and sparse engines


@pytest.mark.parametrize("engine", ["pallas", "sparse"])
def test_f64_max_occ_is_cell_occupancy_as_in_jax(engine):
    """In f64 both engines run the cell-block engine, in both packages:
    ``max_occ`` is the fullest cell's occupancy, not 0 (dense pass) or
    the worklist length (sparse pass)."""
    from aztotmd_tpu.ops.pallas_sparse import pair_forces_sparse as j_sparse
    from aztotmd_tpu_torch.ops.sparse import pair_forces_sparse, tile_shape
    (jcfg, jff, jargs), (cfg, ff, targs) = _both(
        systems.multi_cluster_specs(n_atoms=400, n_clusters=3, box=60.0,
                                    nsp=2, elec=3, radii=True), "f64",
        engine=engine)
    jfn, pfn = ((j_pallas.pair_forces_pallas, allpairs.pair_forces_pallas)
                if engine == "pallas" else (j_sparse, pair_forces_sparse))
    jr = jfn(jcfg, jff, *jargs[:2], radii=jargs[2])
    pr = pfn(cfg, ff, *targs[:3])
    _check_forces(jr, pr, "f64")
    occ = int(np.bincount(np.asarray(j_cellblock.bin_atoms(
        jcfg, jargs[0])["slot_of_atom"]) % cfg.grid.n_cell).max())
    assert int(pr.max_occ) == int(jr.max_occ) == occ
    if engine == "sparse":
        f32 = pair_forces_sparse(cfg, ff, targs[0].float(), targs[1],
                                 targs[2].float())
        assert int(f32.max_occ) != occ          # f32: the worklist length
        assert int(f32.max_occ) <= tile_shape(cfg)[1] ** 2


# --------------------------------------------------------------------------
# the deck


def test_liquid_argon_deck_loads_alike_and_is_pinned_to_its_writer(tmp_path):
    """examples/liquid_argon: written byte for byte by the port's writer;
    both packages pick "block" through "auto" with the same grid
    (13, 13, 13), cap and stencil, and with the engine set to "pallas"
    the dispatcher takes the stacked pass."""
    import filecmp
    deck = os.path.join(ROOT, "examples", "liquid_argon")
    systems.write_liquid_argon_deck(str(tmp_path))
    for name in ("atoms.xyz", "control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / name), os.path.join(deck, name),
                           shallow=False), name
    jcfg = j_load_deck_dir(deck)["cfg"]
    cfg = load_deck_dir(deck)["cfg"]
    assert cfg.pair_engine == jcfg.pair_engine == "block"
    assert cfg.n_at == 32768 and cfg.grid.dims == (13, 13, 13)
    assert (cfg.grid.cap, len(cfg.grid.stencil)) == (46, 27)
    assert cfg.grid == dataclasses.replace(
        cfg.grid, **dataclasses.asdict(jcfg.grid))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert allpairs.block_cost(cfg) == 125519004
    pcfg = load_deck_dir(deck, pair_engine="pallas")["cfg"]
    assert pcfg.pair_engine == "pallas" and pcfg.grid == cfg.grid
    assert allpairs.pallas_branch(pcfg, torch.float32) == "stacked"
