"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The kernels have no CPU mode, so these tests need a CUDA device
and skip without one.  They import no jax: run them on the GPU machine
with ``python -m pytest tests/test_torch_kernels.py -q``.

Tolerance: forces atol 3e-5 * max|F|, energies rel 1e-4 (f32 sums in
another order on both sides, as tests/test_pallas.py states).
"""

import os

import numpy as np
import pytest
import torch

from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.__main__ import main as cli
from aztotmd_tpu_torch.ops import allpairs, cellblock, sparse
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_DECK = os.path.join(ROOT, "examples", "surkov_cluster")
NANO_DECK = os.path.join(ROOT, "examples", "nanoclusters")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _compare(cfg, ff, pos, types, radii):
    before = allpairs.launches
    k = allpairs.pair_forces_allpairs(cfg, ff, pos, types, radii)
    assert allpairs.launches == before + 1
    p = allpairs.pair_forces_allpairs_plain(cfg, ff, pos, types, radii)
    torch.cuda.synchronize()
    kf, pf = k.frc.cpu().numpy(), p.frc.cpu().numpy()
    scale = float(np.abs(pf).max()) or 1.0
    np.testing.assert_allclose(kf, pf, rtol=0, atol=3e-5 * scale)
    for a, b in ((k.eng_vdw, p.eng_vdw), (k.eng_coul, p.eng_coul)):
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-6)


_CASES = [dict(nsp=1, elec=0, radii=True), dict(nsp=2, elec=1, radii=False),
          dict(nsp=3, elec=1, radii=True), dict(nsp=3, elec=2, radii=True),
          dict(nsp=3, elec=3, radii=True), dict(n_atoms=600, radii=True),
          dict(n_atoms=1, radii=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_kernel_matches_plain_clustered(cuda, case):
    _compare(*systems.pair_system(systems.clustered_specs(**case),
                                  device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fam", sorted(systems.FAMILY_PARAMS))
def test_kernel_matches_plain_every_family(cuda, fam):
    _compare(*systems.pair_system(systems.family_specs(fam), device=cuda))


@pytest.mark.cuda
def test_kernel_matches_plain_slice_deck(cuda):
    d = load_deck_dir(SLICE_DECK, device=cuda)
    st = d["state"]
    _compare(d["cfg"], d["ff"], st.pos, st.types, st.radii)


@pytest.mark.cuda
def test_kernel_refuses_f64_and_bad_inputs(cuda):
    cfg, ff, pos, types, rad = systems.pair_system(
        systems.clustered_specs(radii=True), device=cuda)
    with pytest.raises(TypeError):
        allpairs.pair_forces_allpairs(cfg, ff, pos.double(), types,
                                      rad.double())
    with pytest.raises(TypeError):
        allpairs.pair_forces_allpairs(cfg, ff, pos, types.long(), rad)
    with pytest.raises(ValueError):
        allpairs.pair_forces_allpairs(cfg, ff, pos.t().contiguous().t(),
                                      types, rad)


@pytest.mark.cuda
def test_f64_step_on_the_card_raises(cuda, tmp_path):
    """f64 has no kernel: each kernel wrapper raises on an f64 CUDA tensor
    rather than running its plain version there, and launches nothing."""
    deck = str(tmp_path / "deck")
    systems.write_surkov_cluster_deck(deck, n_atoms=300, box=20.0,
                                      steps=10, n_equil=5)
    d = load_deck_dir(deck, dtype="f64", device=cuda)
    st = d["state"]
    before = (allpairs.launches, cellblock.launches, sparse.launches)
    with pytest.raises(TypeError, match="f32 only"):
        allpairs.pair_forces_allpairs(d["cfg"], d["ff"], st.pos, st.types,
                                      st.radii)
    with pytest.raises(TypeError, match="f32 only"):
        cellblock._stacked_cuda(d["cfg"], d["ff"], st.pos, st.types,
                                st.radii)
    assert (allpairs.launches, cellblock.launches, sparse.launches) == before


@pytest.mark.cuda
def test_f64_run_on_the_card_takes_the_block_engine_and_says_so(
        cuda, tmp_path, capsys):
    """An f64 step on the card runs the cell-block engine (torch ops), as
    the JAX package routes f64; the runner says so once on stderr, and an
    f32 run of the same deck (K1) does not."""
    deck = str(tmp_path / "deck")
    systems.write_surkov_cluster_deck(deck, n_atoms=300, box=20.0,
                                      steps=10, n_equil=5)
    d = load_deck_dir(deck, dtype="f64", device=cuda)
    before = (allpairs.launches, cellblock.launches)
    out = make_step(d["cfg"], d["aux"])(d["state"], d["ff"])
    assert out.pos.dtype == torch.float64 and int(out.cell_overflow) > 0
    r = cli(["run", deck, "--dtype", "f64", "--steps", "2", "--quiet",
             "-o", str(tmp_path / "out")])
    assert int(r.state.step) == 2
    assert (allpairs.launches, cellblock.launches) == before
    err = capsys.readouterr().err
    assert err.count("NOTE: the pair pass runs the torch cell-block") == 1
    assert "f64 takes the cell-block engine" in err
    cli(["run", deck, "--steps", "2", "--quiet", "-o",
         str(tmp_path / "out32")])
    assert allpairs.launches == before[0] + 2
    assert "NOTE" not in capsys.readouterr().err


# --- the Morton block-sparse kernel (csrc/sparse.cu) ---

def _compare_sparse(cfg, ff, pos, types, radii, **kw):
    """Kernel against plain on the card; max_occ must be equal exactly."""
    before = sparse.launches
    k = sparse.pair_forces_sparse(cfg, ff, pos, types, radii, **kw)
    assert sparse.launches == before + 1
    p = sparse.pair_forces_sparse_plain(cfg, ff, pos, types, radii, **kw)
    torch.cuda.synchronize()
    kf, pf = k.frc.cpu().numpy(), p.frc.cpu().numpy()
    scale = float(np.abs(pf).max()) or 1.0
    np.testing.assert_allclose(kf, pf, rtol=0, atol=3e-5 * scale)
    for a, b in ((k.eng_vdw, p.eng_vdw), (k.eng_coul, p.eng_coul)):
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-6)
    assert int(k.max_occ) == int(p.max_occ)
    return k, p


_SPARSE_CASES = [dict(nsp=1, elec=0), dict(nsp=2, elec=1),
                 dict(nsp=3, elec=2, radii=True),
                 dict(nsp=3, elec=3, radii=True),
                 dict(n_atoms=1501, nsp=2, elec=1, radii=True),
                 dict(n_atoms=100, n_clusters=2, nsp=1, elec=0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SPARSE_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_sparse_kernel_matches_plain_multi_cluster(cuda, case):
    _compare_sparse(*systems.pair_system(
        systems.multi_cluster_specs(**case), device=cuda,
        pair_engine="sparse"))


@pytest.mark.cuda
def test_sparse_kernel_matches_plain_nanoclusters(cuda):
    d = load_deck_dir(NANO_DECK, device=cuda)
    assert d["cfg"].pair_engine == "sparse"
    st = d["state"]
    _compare_sparse(d["cfg"], d["ff"], st.pos, st.types, None)


@pytest.mark.cuda
def test_sparse_kernel_truncated_worklist(cuda):
    """Below need: max_occ still the need, unvisited tiles exactly 0."""
    args = systems.pair_system(systems.multi_cluster_specs(), device=cuda,
                               pair_engine="sparse")
    need = int(sparse.pair_forces_sparse(*args).max_occ)
    k, _ = _compare_sparse(*args, pair_cap=need // 2)
    assert int(k.max_occ) == need
    S = sparse.sort_tiles(args[0], *args[2:], pair_cap=need // 2)
    empty = (S.row_ptr[1:] == S.row_ptr[:-1]).cpu().numpy()
    assert empty.any()
    slot_tile = np.repeat(np.arange(S.n_t), S.T)[:args[0].n_at]
    atoms = S.perm.cpu().numpy()[empty[slot_tile]]
    assert np.all(k.frc.cpu().numpy()[atoms] == 0.0)


@pytest.mark.cuda
def test_sparse_kernel_refuses_f64(cuda):
    cfg, ff, pos, types, rad = systems.pair_system(
        systems.multi_cluster_specs(radii=True), device=cuda,
        pair_engine="sparse")
    before = sparse.launches
    with pytest.raises(TypeError, match="f32 only"):
        sparse._sparse_cuda(cfg, ff, pos.double(), types, rad.double(),
                            None, False, False, None, None)
    # the engine itself sends f64 to the cell-block engine: max_occ is the
    # fullest cell's occupancy and nothing is launched
    pr = sparse.pair_forces_sparse(cfg, ff, pos.double(), types,
                                   rad.double())
    assert pr.frc.dtype == torch.float64
    assert int(pr.max_occ) == int(cellblock.bin_atoms(
        cfg, pos.double())["max_occ"])
    assert sparse.launches == before


# --- the candidate passes (K1-cand, K4-cand) ---

def _compare_cand(kernel, plain, cfg, ff, pos, types, parents, **kw):
    """Kernel against plain with candidates: ids equal, r2 bitwise equal,
    forces and energies as above, max_occ equal."""
    mod = allpairs if kernel is allpairs.pair_forces_allpairs else sparse
    before = (mod.launches, mod.cand_launches)
    k = kernel(cfg, ff, pos, types, None, parents, **kw)
    assert (mod.launches, mod.cand_launches) == (before[0], before[1] + 1)
    p = plain(cfg, ff, pos, types, None, parents, **kw)
    torch.cuda.synchronize()
    for name in ("bind_idx", "bind_r2", "jump_idx", "jump_r2"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    kf, pf = k.frc.cpu().numpy(), p.frc.cpu().numpy()
    np.testing.assert_allclose(kf, pf, rtol=0,
                               atol=3e-5 * (float(np.abs(pf).max()) or 1.0))
    for a, b in ((k.eng_vdw, p.eng_vdw), (k.eng_coul, p.eng_coul)):
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-6)
    assert int(k.max_occ) == int(p.max_occ)
    return k


def _reactive(cuda, n, engine):
    cfg, ff, pos, types, _ = systems.pair_system(
        systems.reactive_specs(n), device=cuda, pair_engine=engine)
    rng = np.random.default_rng(n)
    par = np.where(rng.uniform(size=n) < 0.4, rng.integers(0, n, n), -1)
    return cfg, ff, pos, types, torch.as_tensor(par, dtype=torch.int32,
                                                device=cuda)


_WANTS = [dict(want_bind=True, want_jump=True), dict(want_bind=True),
          dict(want_jump=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 1000])
@pytest.mark.parametrize("kw", _WANTS, ids=["both", "bind", "jump"])
def test_cand_kernel_matches_plain(cuda, n, kw):
    k = _compare_cand(allpairs.pair_forces_allpairs,
                      allpairs.pair_forces_allpairs_plain,
                      *_reactive(cuda, n, "pallas"), **kw)
    if kw.get("want_bind"):
        assert bool((k.bind_idx < n).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1500, 3000])
@pytest.mark.parametrize("kw", _WANTS, ids=["both", "bind", "jump"])
def test_sparse_cand_kernel_matches_plain(cuda, n, kw):
    _compare_cand(sparse.pair_forces_sparse, sparse.pair_forces_sparse_plain,
                  *_reactive(cuda, n, "sparse"), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["reactive_polymer", "ejump_redox"])
def test_cand_kernels_match_plain_on_example_decks(cuda, name, tmp_path):
    d = load_deck_dir(os.path.join(ROOT, "examples", name), device=cuda)
    cfg, st = d["cfg"], d["state"]
    kw = dict(want_bind=cfg.use_bnd == 2, want_jump=bool(cfg.ejtype))
    _compare_cand(allpairs.pair_forces_allpairs,
                  allpairs.pair_forces_allpairs_plain, cfg, d["ff"], st.pos,
                  st.types, st.parents, **kw)
    systems.tile_deck(os.path.join(ROOT, "examples", name), str(tmp_path), 2)
    d = load_deck_dir(str(tmp_path), device=cuda, pair_engine="sparse")
    st = d["state"]
    _compare_cand(sparse.pair_forces_sparse, sparse.pair_forces_sparse_plain,
                  d["cfg"], d["ff"], st.pos, st.types, st.parents, **kw)


# --- K1 and K4 at the shapes that cut their work: the j range's 32-atom
# chunks and splits (K1), the tile width, its 32-slot sub-tiles and the
# truncated worklist (K4), and every <BIND, JUMP, PAR> instantiation ---

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1728, 4000])
def test_kernel_matches_plain_at_every_size(cuda, n):
    _compare(*systems.pair_system(systems.clustered_specs(
        n_atoms=n, nsp=2, elec=1, radii=True), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 64, 256])
def test_sparse_kernel_matches_plain_every_tile(cuda, tile):
    """Full and truncated worklists (rows cut off write zeros)."""
    args = systems.pair_system(
        systems.multi_cluster_specs(nsp=3, elec=3, radii=True), device=cuda,
        pair_engine="sparse")
    k, _ = _compare_sparse(*args, tile=tile)
    need = int(k.max_occ)
    k, _ = _compare_sparse(*args, tile=tile, pair_cap=need // 2)
    assert int(k.max_occ) == need
    S = sparse.sort_tiles(args[0], *args[2:], tile=tile, pair_cap=need // 2)
    empty = (S.row_ptr[1:] == S.row_ptr[:-1]).cpu().numpy()
    assert empty.any()
    slot_tile = np.repeat(np.arange(S.n_t), S.T)[:args[0].n_at]
    atoms = S.perm.cpu().numpy()[empty[slot_tile]]
    assert np.all(k.frc.cpu().numpy()[atoms] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 64, 256])
def test_sparse_kernel_cull_is_subtile_keep(cuda, tile):
    """The sub-tile pairs the kernel's warps keep, as the kernel records
    them, are exactly ``sparse.subtile_keep``'s, with a full and with a
    truncated worklist."""
    cfg, ff, pos, types, radii = systems.pair_system(
        systems.multi_cluster_specs(nsp=3, elec=3, radii=True), device=cuda,
        pair_engine="sparse")
    tabs = allpairs.kernel_tables(cfg, ff, cuda)
    need = int(sparse.pair_forces_sparse(cfg, ff, pos, types, radii,
                                         tile=tile).max_occ)
    for cap in (None, need // 2):
        S = sparse.sort_tiles(cfg, pos, types, radii, tile=tile,
                              pair_cap=cap)
        keep = sparse.subtile_keep(cfg, S)
        assert keep.any()
        assert torch.equal(sparse.kernel_keep(cfg, *tabs, S), keep)


_INSTANCES = [(True, True, True), (True, True, False), (True, False, True),
              (True, False, False), (False, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pallas", "sparse"])
@pytest.mark.parametrize("bind,jump,par", _INSTANCES,
                         ids=["bind-jump-par", "bind-jump", "bind-par",
                              "bind", "jump"])
def test_every_cand_instantiation_with_ties(cuda, engine, bind, jump, par):
    """An unjittered 2 A lattice: every distance is exact in f32, so bind
    and jump candidates tie in r2 and the key decides."""
    n = 1000
    cfg, ff, pos, types, _ = systems.pair_system(
        systems.reactive_specs(n, spacing=2.0, jitter=0.0), device=cuda,
        pair_engine=engine)
    rng = np.random.default_rng(5)
    parents = (torch.as_tensor(np.where(rng.uniform(size=n) < 0.4,
                                        rng.integers(0, n, n), -1),
                               dtype=torch.int32, device=cuda)
               if par else None)
    fns = ((allpairs.pair_forces_allpairs,
            allpairs.pair_forces_allpairs_plain) if engine == "pallas" else
           (sparse.pair_forces_sparse, sparse.pair_forces_sparse_plain))
    k = _compare_cand(*fns, cfg, ff, pos, types, parents, want_bind=bind,
                      want_jump=jump)
    r2 = k.bind_r2[k.bind_idx < n] if bind else k.jump_r2[k.jump_idx < n]
    assert r2.numel() and set(r2.unique().tolist()) <= {4.0, 8.0}


# --- the stacked cell-block kernel (csrc/cellblock.cu) ---

def _compare_stacked(cfg, ff, pos, types, radii):
    """K3 against its plain version; max_occ equal, dropped atoms zero."""
    before = cellblock.launches
    k = cellblock.pair_forces_stacked(cfg, ff, pos, types, radii)
    assert cellblock.launches == before + 1
    p = cellblock.pair_forces_stacked_plain(cfg, ff, pos, types, radii)
    torch.cuda.synchronize()
    kf, pf = k.frc.cpu().numpy(), p.frc.cpu().numpy()
    scale = float(np.abs(pf).max()) or 1.0
    np.testing.assert_allclose(kf, pf, rtol=0, atol=3e-5 * scale)
    for a, b in ((k.eng_vdw, p.eng_vdw), (k.eng_coul, p.eng_coul)):
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-6)
    assert int(k.max_occ) == int(p.max_occ)
    np.testing.assert_array_equal(np.all(kf == 0.0, axis=1),
                                  np.all(pf == 0.0, axis=1))
    return k


_STACKED_CASES = [dict(), dict(nsp=2, elec=1), dict(nsp=2, elec=3),
                  dict(nsp=3, elec=2, radii=True), dict(nsp=1, radii=True),
                  dict(n_atoms=5000, density=0.021, rcut=8.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _STACKED_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()) or "argon")
def test_stacked_kernel_matches_plain(cuda, case):
    cfg, ff, pos, types, rad = systems.pair_system(
        systems.liquid_argon_specs(**case), device=cuda)
    assert allpairs.pallas_branch(cfg, torch.float32) == "stacked"
    _compare_stacked(cfg, ff, pos, types, rad)
    # through the dispatcher too
    before = cellblock.launches
    allpairs.pair_forces_pallas(cfg, ff, pos, types, rad)
    assert cellblock.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 2, 150])
def test_stacked_kernel_any_capacity(cuda, cap):
    """A capacity below the fullest cell (atoms dropped, zero force on
    both sides) and one far above it (dynamic shared memory over 48 KB)."""
    import dataclasses
    cfg, ff, pos, types, _ = systems.pair_system(
        systems.liquid_argon_specs(), device=cuda)
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid,
                                                            cap=cap))
    k = _compare_stacked(cfg, ff, pos, types, None)
    assert (int(k.max_occ) > cap) == (cap < 3)


@pytest.mark.cuda
def test_stacked_kernel_refuses_f64_and_oversized_cap(cuda):
    import dataclasses
    cfg, ff, pos, types, _ = systems.pair_system(
        systems.liquid_argon_specs(), device=cuda)
    before = cellblock.launches
    with pytest.raises(TypeError, match="f32 only"):
        cellblock.pair_forces_stacked(cfg, ff, pos.double(), types)
    big = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid,
                                                            cap=500))
    with pytest.raises(ValueError, match="cannot hold cap=500"):
        cellblock.pair_forces_stacked(big, ff, pos, types)
    assert cellblock.launches == before


@pytest.mark.cuda
def test_stacked_kernel_matches_plain_liquid_argon_deck(cuda):
    d = load_deck_dir(os.path.join(ROOT, "examples", "liquid_argon"),
                      device=cuda, pair_engine="pallas")
    st = d["state"]
    _compare_stacked(d["cfg"], d["ff"], st.pos, st.types, None)


# --- K2, the rectangular pass of the slab-decomposed step ---

def _compare_rect(cfg, ff, args, kw):
    before = allpairs.rect_launches
    kf, kev, kec = allpairs.pair_forces_allpairs_rect(cfg, ff, *args, **kw)
    assert allpairs.rect_launches == before + 1
    pf, pev, pec = allpairs.pair_forces_allpairs_rect_plain(cfg, ff, *args,
                                                            **kw)
    torch.cuda.synchronize()
    kf, pf = kf.cpu().numpy(), pf.cpu().numpy()
    scale = float(np.abs(pf).max()) or 1.0
    np.testing.assert_allclose(kf, pf, rtol=0, atol=3e-5 * scale)
    assert not kf[~args[2].cpu().numpy()].any()     # empty i slots
    for a, b in ((kev, pev), (kec, pec)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)


_RECT_CASES = [dict(nsp=1, elec=0), dict(nsp=2, elec=1),
               dict(nsp=3, elec=2), dict(nsp=3, elec=3, radii=True),
               dict(nsp=2, elec=3, radii=True, n_atoms=1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _RECT_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("n_i,n_slab", [(200, 1), (150, 3)])
def test_rect_kernel_matches_plain(cuda, case, n_i, n_slab):
    """Ni not a multiple of the tile, Nj > Ni, a fifth of the slots empty,
    one or three slabs in one launch."""
    specs = systems.clustered_specs(**dict(dict(n_atoms=300), **case))
    _compare_rect(*systems.rect_system(specs, n_i, n_slab=n_slab,
                                       device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("deck,n_dev", [(SLICE_DECK, 2), (NANO_DECK, 4)])
def test_rect_kernel_matches_plain_on_mesh_decks(cuda, deck, n_dev):
    """The mesh decks' slab states: surkov_cluster over 2 slabs (2 x
    3,208 x 6,416) and nanoclusters over 4 (4 x 5,024 x 15,072)."""
    from aztotmd_tpu_torch.parallel import LocalRing, slab
    d = load_deck_dir(deck, device=cuda)
    cfg = slab.prepare_slab_cfg(d["cfg"], n_dev)
    comm = LocalRing(n_dev, cuda)
    st = slab.make_slab_state(cfg, d["state"], comm)
    a = slab.dense_pass_inputs(cfg, comm, {k: getattr(st, k) for k in
                                           slab.PER_SLOT}, st.gid >= 0)
    _compare_rect(cfg, d["ff"], a[:6], dict(radii_i=a[6], radii_j=a[7]))


@pytest.mark.cuda
def test_mesh_run_launches_k2_every_step(cuda, tmp_path):
    """`run --mesh 2` on the slice deck: one K2 launch a step, no K1."""
    k1, k2 = allpairs.launches, allpairs.rect_launches
    r = cli(["run", SLICE_DECK, "--mesh", "2", "--steps", "20", "-o",
             str(tmp_path), "--quiet"])
    assert allpairs.rect_launches - k2 == 20 and allpairs.launches == k1
    assert int(r.state.mig_lost) == 0
