"""How the port's K2 and K3 kernels cut their work, pinned on the CPU.

- ``allpairs.rect_split`` sizes K2's grid from the device's SM count: a j
  tile for each thread group of a block, but no more splits than give
  RECT_BLOCKS_PER_SM (split, slab, i tile) blocks an SM.
- ``allpairs.rect_subtile_keep`` is K2's warp sub-tile cull in torch (the
  kernel's own record is held equal to it on the card,
  ``tests/test_torch_kernels.py`` and ``chip_smoke.py``).  Every ordered
  pair of filled slots in range, by a brute-force f64 distance and by the
  f32 r2 the plain pass computes, lies in a kept (i sub-tile, j sub-tile)
  pair: on ``systems.rect_system`` slabs whose empty slots sit at the
  origin, on a cluster wrapped across the periodic faces, and on the real
  slab layouts of examples/nanoclusters over 4 slabs and
  examples/surkov_cluster over 2 (one halo copy, left == right), whose
  keep shares are pinned (``-s`` prints them).
- ``cellblock.stacked_plan`` sizes K3's runs of cells by the grid's mean
  occupancy and its shared memory by ``cap``.
"""

import os

import numpy as np
import pytest
import torch

from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.ops import allpairs, cellblock
from aztotmd_tpu_torch.parallel import LocalRing, slab
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB = allpairs.CULL_SUB


# --- rect_split ---

@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("sm", [1, 66, 114, 132])
@pytest.mark.parametrize("L,ni,nj", [(1, 200, 300), (2, 3208, 6416),
                                     (4, 5024, 15072), (3, 150, 300),
                                     (1, 1, 1)])
def test_rect_split_fills_the_card(L, ni, nj, sm, groups):
    s = allpairs.rect_split(L, ni, nj, 128, groups, sm)
    per_group = -(-(-(-nj // 128)) // groups)      # a j tile a group
    n_blk = L * -(-ni // 128)
    cap = allpairs.RECT_BLOCKS_PER_SM * sm
    assert 1 <= s <= per_group
    assert s == per_group or n_blk * s >= cap
    assert s == 1 or n_blk * (s - 1) < cap


def test_rect_split_at_the_mesh_decks_shapes():
    """The H100's 132 SMs and K2's two thread groups a block:
    surkov_cluster over 2 slabs (2 x 26 i tiles, 51 j tiles) takes a j
    tile a group, nanoclusters over 4 (4 x 40 i tiles, 118 j tiles) stops
    at 32 blocks an SM; a card with fewer SMs gets fewer splits."""
    assert allpairs.rect_split(2, 3208, 6416, 128, 2, 132) == 26
    assert allpairs.rect_split(4, 5024, 15072, 128, 2, 132) == 27
    assert allpairs.rect_split(4, 5024, 15072, 128, 2, 114) == 23
    assert allpairs.rect_split(1, 100, 100, 128, 2, 132) == 1


# --- the warp sub-tile cull of K2 ---

def _pairs_in_range(cfg, pos_i, valid_i, pos_j, valid_j, rows=1024):
    """(slab, i slot, j slot) of every ordered pair of filled slots, not
    the same slot, in range by f64 distance or by the f32 r2 the plain
    pass computes."""
    out = []
    box64 = torch.tensor(cfg.box, dtype=torch.float64)
    box32 = torch.tensor(cfg.box, dtype=torch.float32)
    ibox32 = torch.tensor([1.0 / b for b in cfg.box], dtype=torch.float32)
    for s in range(pos_i.shape[0]):
        ii = torch.nonzero(valid_i[s]).flatten()
        jj = torch.nonzero(valid_j[s]).flatten()
        pj = pos_j[s, jj]
        for i0 in range(0, len(ii), rows):
            ib = ii[i0:i0 + rows]
            d = pos_i[s, ib, None, :] - pj[None, :, :]
            d = d - box32 * torch.round(d * ibox32)
            r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]
            d64 = pos_i[s, ib, None, :].double() - pj[None, :, :].double()
            d64 = d64 - box64 * torch.round(d64 / box64)
            inr = (r2 <= cfg.r2_max) | ((d64 * d64).sum(-1) <= cfg.r2_max)
            inr &= ib[:, None] != jj[None, :]
            a, b = torch.nonzero(inr, as_tuple=True)
            out.append(torch.stack([torch.full_like(a, s), ib[a], jj[b]]))
    return torch.cat(out, 1) if out else torch.zeros((3, 0), dtype=torch.long)


def _keep_case(cfg, pos_i, valid_i, pos_j, valid_j):
    """Every pair in range lies in a kept sub-tile pair; returns (kept
    sub-tile pairs, kept filled slot pairs, all filled slot pairs, pairs
    in range)."""
    keep = allpairs.rect_subtile_keep(cfg, pos_i, valid_i, pos_j, valid_j)
    L, ni, nj = pos_i.shape[0], pos_i.shape[1], pos_j.shape[1]
    assert keep.shape == (L, -(-ni // SUB), -(-nj // SUB))
    s, i, j = _pairs_in_range(cfg, pos_i, valid_i, pos_j, valid_j)
    assert s.numel() > 0
    assert bool(keep[s, i // SUB, j // SUB].all())

    kept = allpairs.rect_kept_slot_pairs(keep, valid_i, valid_j)
    filled = int((valid_i.sum(1) * valid_j.sum(1)).sum())
    # no empty sub-tile is ever kept
    sub_i = torch.nn.functional.pad(valid_i, (0, -ni % SUB)).reshape(
        L, -1, SUB).any(-1)
    sub_j = torch.nn.functional.pad(valid_j, (0, -nj % SUB)).reshape(
        L, -1, SUB).any(-1)
    assert not bool(keep[~sub_i].any()) and not bool(
        keep.transpose(1, 2)[~sub_j].any())
    print(f"L={L} Ni={ni} Nj={nj}: {s.numel()} ordered pairs in range, "
          f"kept {int(keep.sum())} sub-tile pairs, {kept} of {filled} "
          f"filled slot pairs ({kept / filled:.4f})")
    return int(keep.sum()), kept, filled, s.numel()


_RECT_CASES = [dict(nsp=1, elec=0), dict(nsp=2, elec=1),
               dict(nsp=3, elec=3, radii=True)]


@pytest.mark.parametrize("case", _RECT_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("n_i,n_slab", [(200, 1), (150, 3)])
def test_rect_keep_every_pair_empty_slots_at_origin(case, n_i, n_slab):
    """A fifth of the slots empty, at the origin: the origin is no filled
    slot's box corner, so boxes taken over empty slots too would be wider
    but still sound; boxes over filled slots only must keep every pair."""
    cfg, _, args, _ = systems.rect_system(
        systems.clustered_specs(n_atoms=300, **case), n_i, n_slab=n_slab)
    pos_i, _, valid_i, pos_j, _, valid_j = args
    assert bool((pos_j[~valid_j] == 0).all()) and bool((~valid_j).any())
    subs, kept, filled, _ = _keep_case(cfg, pos_i, valid_i, pos_j, valid_j)
    assert kept <= filled


def test_rect_keep_stale_positions_do_not_widen_boxes():
    """Empty slots holding a departed atom's stale position far away (as
    after a migration) change nothing: the mask equals the one with the
    empty slots at the origin."""
    cfg, _, args, _ = systems.rect_system(
        systems.multi_cluster_specs(n_atoms=1200, n_clusters=4), 500)
    pos_i, _, valid_i, pos_j, _, valid_j = args
    a = allpairs.rect_subtile_keep(cfg, pos_i, valid_i, pos_j, valid_j)
    rng = np.random.default_rng(9)
    stale = torch.as_tensor(rng.uniform(0.0, cfg.box[0], pos_j.shape),
                            dtype=torch.float32)
    pj = torch.where(valid_j[..., None], pos_j, stale)
    b = allpairs.rect_subtile_keep(cfg, pj[:, :500], valid_i, pj, valid_j)
    assert torch.equal(a, b)
    _keep_case(cfg, pj[:, :500], valid_i, pj, valid_j)


@pytest.mark.parametrize("n_slab", [1, 2])
def test_rect_keep_every_pair_across_every_face(n_slab):
    """multi_cluster_specs puts cluster 0 on the box corner, wrapped
    across all three faces: its sub-tiles' boxes span the box and the
    min-image gap must still keep their pairs."""
    cfg, _, args, _ = systems.rect_system(
        systems.multi_cluster_specs(n_atoms=1500, n_clusters=5, nsp=2),
        600, n_slab=n_slab)
    pos_i, _, valid_i, pos_j, _, valid_j = args
    first = pos_j[0, :300][valid_j[0, :300]]
    assert bool(((first < 6.5) | (first > cfg.box[0] - 6.5)).all())
    assert bool((first.min(0).values < 1.0).all()
                and (first.max(0).values > cfg.box[0] - 1.0).all())
    subs, kept, filled, _ = _keep_case(cfg, pos_i, valid_i, pos_j, valid_j)
    assert kept < filled


def _mesh_inputs(deck, n_dev):
    d = load_deck_dir(os.path.join(ROOT, "examples", deck))
    cfg = slab.prepare_slab_cfg(d["cfg"], n_dev)
    comm = LocalRing(n_dev, torch.device("cpu"))
    st = slab.make_slab_state(cfg, d["state"], comm)
    a = slab.dense_pass_inputs(cfg, comm, {k: getattr(st, k) for k in
                                           slab.PER_SLOT}, st.gid >= 0)
    return cfg, a


@pytest.mark.parametrize("deck,n_dev,pinned", [
    ("surkov_cluster", 2, (5724, 5816402, 16000000)),
    ("nanoclusters", 4, (25767, 26167554, 108461100))])
def test_rect_keep_every_pair_on_the_mesh_decks(deck, n_dev, pinned):
    """The slab layouts the mesh runs hand K2: surkov_cluster over 2 slabs
    (2 x 3,208 x 6,416; one halo copy) keeps 36.4% of its filled slot
    pairs, nanoclusters over 4 (4 x 5,024 x 15,072) 24.1%."""
    cfg, a = _mesh_inputs(deck, n_dev)
    pos_i, _, valid_i, pos_j, _, valid_j = a[:6]
    assert pos_j.shape[1] == (2 if n_dev == 2 else 3) * pos_i.shape[1]
    subs, kept, filled, _ = _keep_case(cfg, pos_i, valid_i, pos_j, valid_j)
    assert (subs, kept, filled) == pinned


def test_rect_kernel_keep_is_subtile_keep_on_the_cpu():
    cfg, ff, args, kw = systems.rect_system(
        systems.clustered_specs(n_atoms=300, nsp=2, elec=1), 200)
    assert torch.equal(
        allpairs.rect_kernel_keep(cfg, ff, *args, **kw),
        allpairs.rect_subtile_keep(cfg, args[0], args[2], args[3], args[5]))


# --- K3's runs of cells ---

@pytest.mark.parametrize("cap,dims,n_at,nz", [
    (46, (13, 13, 13), 32768, 4),    # liquid_argon: ~15 atoms a cell
    (150, (13, 13, 13), 32768, 4),   # a generous cap, same run
    (10, (4, 4, 10), 160, 8),        # one atom a cell: the longest run
    (10, (5, 5, 3), 75, 3),          # the grid's side bounds the run
    (46, (8, 8, 8), 20000, 1),       # ~39 atoms a cell: one a block
    (46, (8, 8, 8), 8000, 4)])       # ~16 atoms a cell
def test_stacked_plan(cap, dims, n_at, nz):
    got, smem = cellblock.stacked_plan(cap, dims, n_at, nsp=2)
    assert got == nz
    assert smem == cellblock.stacked_smem(2, cap, nz)
    assert smem == 9 * (nz + 2) * cap * 20 + 4 * 9 * 4


def test_stacked_plan_shrinks_the_run_to_fit_shared_memory():
    """cap 400 at one atom a cell: 8 cells a block would stage 9 x 10
    cells of 400 slots (720 KB); the run shrinks to what fits, and a cap
    whose single-cell stencil does not fit is refused."""
    nz, smem = cellblock.stacked_plan(400, (10, 10, 10), 1000, 1)
    assert nz == 1 and smem <= cellblock._MAX_SMEM
    assert cellblock.stacked_smem(1, 400, 2) > cellblock._MAX_SMEM
    with pytest.raises(ValueError, match="cannot hold cap=500"):
        cellblock.stacked_plan(500, (10, 10, 10), 1000, 1)
