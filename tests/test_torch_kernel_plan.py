"""How the port's K1 and K4 kernels cut their work, pinned on the CPU.

- ``allpairs.allpairs_split`` and ``sparse.sparse_split`` size the grids
  from the device's SM count: at least BLOCKS_PER_SM blocks an SM wherever
  the work has that many units (K1: j ranges of J_UNIT atoms; K4: worklist
  entries of a row, at most n_t), never more splits than units, one for
  tiny N.
- ``sparse.subtile_keep`` is the warp sub-tile cull of ``csrc/sparse.cu``
  in torch.  On examples/nanoclusters, examples/reactive_polymer tiled
  3x3x3 and a small LJ deck with atoms straddling every face of the box,
  every ordered pair in range lies in a kept (i sub-tile, j sub-tile)
  pair, and the plain sparse pass restricted to the kept sub-tiles equals
  the unrestricted one exactly (forces, energies, max_occ, candidate ids
  and r2): the cull only drops pairs out of range.
"""

import os

import numpy as np
import pytest
import torch

from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.ops import allpairs, sparse
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = [352, 512, 1728, 4000, 12000]
SMS = [1, 114, 132]


def _n_t(n):
    """Tiles of the sparse pass at N atoms (``sparse.tile_shape``'s rule
    with the decks' 256-slot tiles)."""
    T = min(256, -(-n // 128) * 128)
    return -(-n // T)


@pytest.mark.parametrize("sm", SMS)
@pytest.mark.parametrize("n", NS)
def test_allpairs_split_fills_the_card(n, sm):
    tile = 128
    s = allpairs.allpairs_split(n, tile, sm)
    units = -(-n // allpairs.J_UNIT)
    blocks = -(-n // tile) * s
    assert 1 <= s <= units
    assert blocks >= allpairs.BLOCKS_PER_SM * sm or s == units
    assert -(-n // s) <= 4096


@pytest.mark.parametrize("sm", SMS)
@pytest.mark.parametrize("n", NS)
def test_sparse_split_fills_the_card(n, sm):
    n_t = _n_t(n)
    s = sparse.sparse_split(n_t, sm)
    assert 1 <= s <= n_t
    assert n_t * s >= allpairs.BLOCKS_PER_SM * sm or s == n_t


@pytest.mark.parametrize("n", [0, 1, 31, 32])
def test_splits_are_one_for_tiny_n(n):
    for sm in SMS:
        assert allpairs.allpairs_split(n, 128, sm) == 1
        assert sparse.sparse_split(_n_t(max(n, 1)), sm) == 1


def test_splits_at_the_decks_shapes():
    """The H100's 132 SMs: K1 on surkov_cluster, molten_salt,
    reactive_polymer, ejump_redox; K4 on nanoclusters (47 tiles); a split
    never stages more than the kernel's 4,096 j atoms."""
    assert [allpairs.allpairs_split(n, 128, 132)
            for n in (4000, 1728, 512, 352)] == [33, 54, 16, 11]
    assert sparse.sparse_split(47, 132) == 23
    assert allpairs.allpairs_split(100_000, 128, 132) == 25
    assert allpairs.allpairs_split(100_000, 128, 132, max_range=1000) == 100


def _cull_case(cfg, ff, pos, types, radii, tile=None, **kw):
    """Coverage of the cull and equality of the restricted plain pass on
    one system; returns (kept, visited) slot pairs."""
    S = sparse.sort_tiles(cfg, pos, types, radii, tile)
    assert int(S.n_need) <= S.pair_cap
    keep = sparse.subtile_keep(cfg, S)
    T, n_t, sub = S.T, S.n_t, sparse.CULL_SUB
    n_sub = keep.shape[1]
    kept_map = torch.zeros((n_t, n_t, n_sub, n_sub), dtype=torch.bool)
    v = S.vp > 0
    kept_map[S.it[v].long(), S.jt[v].long()] = keep[v]
    # every ordered pair in range, as the plain pass rounds its r2
    slot = torch.empty(cfg.n_at, dtype=torch.long)
    slot[S.perm] = torch.arange(cfg.n_at)
    box = torch.tensor(cfg.box, dtype=pos.dtype)
    ibox = torch.tensor([1.0 / b for b in cfg.box], dtype=pos.dtype)
    n_in = 0
    for i0 in range(0, cfg.n_at, 512):
        d = pos[i0:i0 + 512, None, :] - pos[None, :, :]
        d = d - box * torch.round(d * ibox)
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2])
        ii, jj = torch.nonzero(r2 <= cfg.r2_max, as_tuple=True)
        si, sj = slot[ii + i0], slot[jj]
        n_in += int((ii + i0 != jj).sum())
        assert bool(kept_map[si // T, sj // T, (si % T) // sub,
                             (sj % T) // sub].all())
    kept = int(keep.sum()) * sub * sub
    visited = int(S.n_need) * T * T
    print(f"N={cfg.n_at} T={T}: {n_in} ordered pairs in range, kept "
          f"{kept} of {visited} visited slot pairs ({kept / visited:.3f})")
    a = sparse.pair_forces_sparse_plain(cfg, ff, pos, types, radii,
                                        tile=tile, **kw)
    b = sparse.pair_forces_sparse_plain(cfg, ff, pos, types, radii,
                                        tile=tile, cull=True, **kw)
    for name in ("frc", "eng_vdw", "eng_coul", "max_occ", "bind_idx",
                 "bind_r2", "jump_idx", "jump_r2"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    return kept, visited


def test_cull_keeps_every_pair_nanoclusters():
    d = load_deck_dir(os.path.join(ROOT, "examples", "nanoclusters"))
    st = d["state"]
    kept, visited = _cull_case(d["cfg"], d["ff"], st.pos, st.types, None)
    assert kept < visited // 2


def test_cull_keeps_every_pair_reactive_polymer_x3(tmp_path):
    systems.tile_deck(os.path.join(ROOT, "examples", "reactive_polymer"),
                      str(tmp_path), 3)
    d = load_deck_dir(str(tmp_path), pair_engine="sparse")
    st = d["state"]
    n = d["cfg"].n_at
    rng = np.random.default_rng(11)
    par = torch.as_tensor(np.where(rng.uniform(size=n) < 0.4,
                                   rng.integers(0, n, n), -1),
                          dtype=torch.int32)
    _cull_case(d["cfg"], d["ff"], st.pos, st.types, None, parents=par,
               want_bind=True, want_jump=True)


@pytest.mark.parametrize("tile", [32, 64, 256])
def test_cull_keeps_every_pair_across_every_face(tmp_path, tile):
    """The 9^3 LJ lattice shifted by half a spacing: a plane of atoms sits
    on each face, half of it wrapped to the far side, so sub-tiles
    straddle the faces and their boxes span the box."""
    systems.write_lj_deck(str(tmp_path), n_side=9, box=40.0)
    d = load_deck_dir(str(tmp_path), pair_engine="sparse")
    cfg, st = d["cfg"], d["state"]
    pos = torch.remainder(st.pos - 40.0 / 18, 40.0)
    lo, hi = pos.min(0).values, pos.max(0).values
    assert bool((lo < 0.3).all() and (hi > 39.7).all())
    _cull_case(cfg, d["ff"], pos, st.types, None, tile=tile)
