"""Morton block-sparse pair pass: the hand-written CUDA kernel and its plain
PyTorch version (port of ``aztotmd_tpu/ops/pallas_sparse.py``:
``pair_forces_sparse`` with ``morton_codes``, ``_tile_worklist`` and
``_sparse_kernel``, its fused bind/jump candidates included).

Atoms are sorted by the Morton code of their fine-grid cell, cut into
tiles of T slots, and a tile pair interacts when the periodic min-image
gap between the two tiles' bounding boxes is within the cutoff (a lower
bound on every cross-tile distance, so no pair in range is dropped).  The
i-major worklist of interacting ordered tile pairs is truncated at
``pair_cap`` entries; ``max_occ`` carries the length it needed
(``n_need``), which the runner compares with ``cfg.sparse_pair_cap`` to
regrow the capacity.

Kernel: ``csrc/sparse.cu``, CUDA C++ for sm_90a, bound through a plain C
interface and ``ctypes``.  It replaces the TPU kernel
``aztotmd_tpu/ops/pallas_sparse.py::_sparse_kernel``.  On the H100 it is
bound by FP32 issue (and the MUFU rsqrt), not by memory.  Its warps skip
the 32-slot sub-tiles of a worklist entry whose boxes lie out of range
(``subtile_keep`` is that cull in torch, for tests), and the rows are
split for eight blocks an SM (``sparse_split``); see the note at the top
of the source.  The worklist, its CSR row offsets and the sort are built
here in torch without a host synchronisation.

Bind/jump candidates are the dense pass's (``ops/allpairs.py``) over the
worklist, with the parents carried in the sorted table.  The TPU kernel
visits a row's entries in worklist order, ascending j tile, and breaks
ties inside a tile by species, then global id; the minima carry that
order as the key ``(jt * nsp + species) * N + id`` and are un-sorted to
atom order.

Routing: f64 goes to the cell-block engine (``ops/cellblock.py``) on
either device, as in the JAX package (``pallas_sparse.py:252``), so in f64
``max_occ`` is cell occupancy.  An f32 CPU tensor goes to the plain
version; an f32 CUDA tensor launches the kernel or raises.  The kernel is
f32 only.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import _morton_dims, _part1by2, _round_up
from . import cuda_build
from .allpairs import (_CAND_C, BLOCKS_PER_SM, CandArgs, cand_args,
                       check_tensor, f32, kernel_consts, kernel_tables,
                       pair_terms, plain_candidates, plain_tables,
                       sm_count, split_candidates)
from .cellblock import pair_forces_block
from .pairs import PairResult, pair_result

# launches of csrc/sparse.cu made by pair_forces_sparse, without
# candidates (K4) and with them (K4-cand); plain ints that tools checking
# the main path reset and read
launches = 0
cand_launches = 0

_MAX_TILE = 256          # one thread per i slot (MAX_T in csrc/sparse.cu)
CULL_SUB = 32            # slots of a warp's sub-tile (SUB in csrc/sparse.cu)
CULL_SLACK = 2.0 ** -18  # cull margin over the longest box side (CULL_SLACK)


def sparse_split(n_t: int, sm_count: int) -> int:
    """Splits of each worklist row: enough (i tile, split) blocks for
    BLOCKS_PER_SM an SM, never more than a row can hold (n_t entries)."""
    return max(1, min(n_t, -(-BLOCKS_PER_SM * sm_count // max(n_t, 1))))


def morton_codes(box, r_max, pos):
    """int32 Morton code per atom from the (wrapped) positions."""
    dims = _morton_dims(box, r_max)
    code = None
    for k in range(3):
        b = float(box[k])
        # true division by the box, as jnp does (a CUDA tensor divided by
        # a Python scalar is multiplied by its reciprocal instead)
        bt = torch.full((), b, dtype=pos.dtype, device=pos.device)
        w = pos[:, k] - b * torch.floor(pos[:, k] / bt)
        c = torch.clamp((w * (dims[k] / b)).to(torch.int32), 0, dims[k] - 1)
        s = _part1by2(c) << k
        code = s if code is None else code | s
    return code


def _tile_worklist(box, r2_max, xs, ys, zs, valid, n_t, T, pair_cap):
    """AABB-interacting ordered tile pairs, compacted i-major.

    Returns (it, jt, vp) int32 (pair_cap,) tensors and the int32 count
    of interacting pairs ``n_need``.  Entries past pair_cap are dropped;
    unused entries point at the (n_t-1, n_t-1) pair with vp 0.  The
    compaction is a cumsum rank and a fixed-size scatter, so it does not
    wait for the device (``jnp.nonzero(size=...)`` in JAX).  JAX's
    ``first`` flags (a new i tile starts) have no use here: the kernel
    walks CSR rows (``sort_tiles``)."""
    dt = xs.dtype
    dev = xs.device
    vt = valid.reshape(n_t, T) > 0
    tile_valid = torch.any(vt, dim=1)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)

    def aabb(a):
        at = a.reshape(n_t, T)
        lo = torch.amin(torch.where(vt, at, inf), dim=1)
        hi = torch.amax(torch.where(vt, at, -inf), dim=1)
        return (lo + hi) * 0.5, (hi - lo) * 0.5

    # scalars in the working precision, 1/b divided in it, as JAX does
    npdt = np.float64 if dt == torch.float64 else np.float32
    gap2 = torch.zeros((n_t, n_t), dtype=dt, device=dev)
    for k, a in enumerate((xs, ys, zs)):
        c, h = aabb(a)
        d = c[:, None] - c[None, :]
        b = npdt(box[k])
        d = d - float(b) * torch.round(d * float(npdt(1.0) / b))
        g = torch.clamp(torch.abs(d) - h[:, None] - h[None, :], min=0.0)
        gap2 = gap2 + g * g
    mask = ((gap2 <= float(npdt(r2_max))) & tile_valid[:, None]
            & tile_valid[None, :]).reshape(-1)

    n_need = torch.sum(mask, dtype=torch.int32)
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    dest = torch.where(mask & (rank < pair_cap), rank, pair_cap)
    buf = torch.full((pair_cap + 1,), -1, dtype=torch.int32, device=dev)
    buf.scatter_(0, dest.long(),
                 torch.arange(n_t * n_t, dtype=torch.int32, device=dev))
    flat = buf[:pair_cap]
    vp = (flat >= 0).to(torch.int32)
    safe = torch.where(vp > 0, flat, n_t * n_t - 1)
    it = torch.div(safe, n_t, rounding_mode="floor")
    jt = safe - it * n_t
    return it, jt, vp, n_need


@dataclass
class SortedTiles:
    """Morton-sorted atoms in n_t tiles of T slots and their worklist."""
    T: int
    n_t: int
    pair_cap: int
    perm: torch.Tensor        # (N,) sorted slot -> atom
    x: torch.Tensor           # (n_t*T,) sorted positions, 0 on padding
    y: torch.Tensor
    z: torch.Tensor
    gid: torch.Tensor         # (n_t*T,) int32 atom id, -1 on padding
    types: torch.Tensor       # (n_t*T,) int32
    radii: torch.Tensor       # (n_t*T,) 1 on padding and without radii
    parents: torch.Tensor | None   # (n_t*T,) int32, -1 on padding
    it: torch.Tensor          # (pair_cap,) int32 worklist
    jt: torch.Tensor
    vp: torch.Tensor
    n_need: torch.Tensor      # int32 worklist length needed
    row_ptr: torch.Tensor     # (n_t+1,) int32 CSR offsets of i tiles


def tile_shape(cfg, tile=None, pair_cap=None):
    """(T, n_t, pair_cap) of the pass, as ``pair_forces_sparse`` sizes
    them: the configured capacity holds for ``cfg.sparse_tile`` only."""
    N = cfg.n_at
    T = int(tile if tile is not None else (cfg.sparse_tile or 256))
    T = min(T, _round_up(N, 128))
    n_t = _round_up(N, T) // T
    if pair_cap is None:
        pair_cap = (int(cfg.sparse_pair_cap)
                    if T == int(cfg.sparse_tile) else 0) or n_t * n_t
    return T, n_t, max(n_t, min(int(pair_cap), n_t * n_t))


def sort_tiles(cfg, pos, types, radii=None, tile=None, pair_cap=None,
               parents=None) -> SortedTiles:
    """Sort, pad and tile the atoms (and ``parents``, when given) and
    build the worklist and its CSR row offsets (no host
    synchronisation)."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    T, n_t, pair_cap = tile_shape(cfg, tile, pair_cap)
    padn = n_t * T - N
    # jnp.argsort is stable: many atoms share a code, and another tie
    # order changes the tiles, their boxes and so the integer n_need
    perm = torch.argsort(morton_codes(cfg.box, cfg.r_max, pos), stable=True)

    def padded(a, fill):
        return torch.cat([a[perm], torch.full((padn,), fill, dtype=a.dtype,
                                              device=dev)])

    srt = pos[perm]
    x, y, z = (torch.cat([srt[:, k], torch.zeros(padn, dtype=dt, device=dev)])
               for k in range(3))
    gid = padded(torch.arange(N, dtype=torch.int32, device=dev), -1)
    ts = padded(types.to(torch.int32), 0)
    # radius 1.0 on padding keeps the Surkov 1/(k1*ra + k2*rb) term finite
    ra = (padded(radii.to(dt), 1.0) if cfg.use_radii and radii is not None
          else torch.ones(n_t * T, dtype=dt, device=dev))
    par = padded(parents.to(torch.int32), -1) if parents is not None else None
    it, jt, vp, n_need = _tile_worklist(
        cfg.box, cfg.r2_max, x, y, z, (gid >= 0).to(torch.int32), n_t, T,
        pair_cap)
    counts = torch.zeros(n_t, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, it.long(), vp)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    return SortedTiles(T, n_t, pair_cap, perm, x, y, z, gid, ts, ra, par,
                       it, jt, vp, n_need, row_ptr)


def _result(S: SortedTiles, frc_s, ev, ec, ff=None, types=None, bind=None,
            jump=None) -> PairResult:
    """Un-sort the (n_t*T, 3) slot forces and the (min r2, key) slot
    minima of the candidates back to atom order."""
    N = S.perm.shape[0]
    frc = torch.zeros((N, 3), dtype=frc_s.dtype, device=frc_s.device)
    frc.index_copy_(0, S.perm, frc_s[:N])

    def unsort(mk):
        out = []
        for a in mk:
            o = torch.empty(N, dtype=a.dtype, device=a.device)
            o[S.perm] = a[:N]
            out.append(o)
        return tuple(out)

    if bind is not None:
        bind = unsort(bind)
    if jump is not None:
        jump = (unsort(jump[0]), unsort(jump[1]))
    return pair_result(frc, ev, ec, S.n_need, ff, types, bind, jump)


def _slot_minima(parts, S: SortedTiles, dt):
    """Merge per-entry (P, T) row minima of the worklist chunks into the
    (n_t*T,) slot minima on (r2, key)."""
    m = torch.cat([p[0] for p in parts]).reshape(-1)
    k = torch.cat([p[1] for p in parts]).reshape(-1)
    dev = m.device
    slot = (S.it.long()[:, None] * S.T
            + torch.arange(S.T, device=dev)[None, :]).reshape(-1)
    n = S.n_t * S.T
    best = torch.full((n,), float("inf"), dtype=dt, device=dev)
    best = best.scatter_reduce(0, slot, m, "amin")
    big = torch.iinfo(torch.int64).max
    kk = torch.where(torch.isfinite(m) & (m == best[slot]), k, big)
    bk = torch.full((n,), big, dtype=torch.int64, device=dev)
    return best, bk.scatter_reduce(0, slot, kk, "amin")


# --------------------------------------------------------------------------
# the kernel's warp sub-tile cull, in torch (for tests and chip_smoke.py)


def subtile_boxes(S: SortedTiles):
    """Boxes of each tile's CULL_SUB-slot sub-tiles over their filled
    slots, as ``csrc/sparse.cu`` computes them in f32: centres and
    half-widths (3, n_t, n_sub) each, and (n_t, n_sub) whether a sub-tile
    holds a filled slot (centres and half-widths 0 where not)."""
    T, n_t = S.T, S.n_t
    n_sub = -(-T // CULL_SUB)
    pad = n_sub * CULL_SUB - T

    def sub(a, fill):
        a = torch.nn.functional.pad(a.reshape(n_t, T), (0, pad), value=fill)
        return a.reshape(n_t, n_sub, CULL_SUB)

    filled = sub(S.gid, -1) >= 0
    nonempty = filled.any(-1)
    cs, hs = [], []
    for a in (S.x, S.y, S.z):
        a = sub(a, 0.0)
        lo = torch.where(filled, a, float("inf")).amin(-1)
        hi = torch.where(filled, a, float("-inf")).amax(-1)
        cs.append(torch.where(nonempty, (lo + hi) * 0.5, 0.0))
        hs.append(torch.where(nonempty, (hi - lo) * 0.5, 0.0))
    return torch.stack(cs), torch.stack(hs), nonempty


def subtile_keep(cfg, S: SortedTiles):
    """(pair_cap, n_sub, n_sub) bool: the (i sub-tile, j sub-tile) pairs
    of each worklist entry that the kernel's warps keep.  Kept: both hold
    a filled slot and the periodic min-image gap of their boxes
    (``_tile_worklist``'s formula, f32, each operation rounded on its own)
    is within the cutoff plus CULL_SLACK of the longest box side.  The
    gap bounds every pair's distance from below, so every pair in range
    lies in a kept sub-tile pair."""
    c, h, nonempty = subtile_boxes(S)
    dt, dev = c.dtype, c.device
    t = lambda v: torch.tensor(v, dtype=dt, device=dev)
    it, jt = S.it.long(), S.jt.long()
    gap2 = torch.zeros((S.pair_cap,) + c.shape[2:] * 2, dtype=dt,
                       device=dev)
    for k in range(3):
        b, ib = t(f32(cfg.box[k])), t(f32(1.0 / cfg.box[k]))
        d = c[k][it][:, :, None] - c[k][jt][:, None, :]
        d = d - b * torch.round(d * ib)
        g = torch.clamp(torch.abs(d) - h[k][it][:, :, None]
                        - h[k][jt][:, None, :], min=0.0)
        gap2 = gap2 + g * g
    rc = (torch.sqrt(t(f32(cfg.r2_max)))
          + t(f32(CULL_SLACK)) * t(max(f32(b) for b in cfg.box)))
    return ((gap2 <= rc * rc) & nonempty[it][:, :, None]
            & nonempty[jt][:, None, :] & (S.vp > 0)[:, None, None])


def kernel_keep(cfg, prm, kinds, S: SortedTiles):
    """``subtile_keep``'s mask as the kernel's warps took it: one K4
    launch on ``S`` that records, per worklist entry, bit 8 * w + s when
    the i sub-tile w kept the j sub-tile s.  On the CPU, ``subtile_keep``
    itself."""
    if S.x.device.type == "cpu":
        return subtile_keep(cfg, S)
    word = torch.zeros(S.pair_cap, dtype=torch.int64, device=S.x.device)
    launch(cfg, prm, kinds, S, kept=word)
    s = torch.arange(-(-S.T // CULL_SUB), device=word.device)
    return ((word[:, None, None] >> (8 * s[:, None] + s[None, :])) & 1) > 0


# --------------------------------------------------------------------------
# plain PyTorch version


def pair_forces_sparse_plain(cfg, ff, pos, types, radii=None, parents=None,
                             want_bind=False, want_jump=False, tile=None,
                             pair_cap=None, cull=False) -> PairResult:
    """What the kernel computes, in plain PyTorch: the worklist's entries
    in chunks of P, gathered into (P, T, T) tile pairs (~1M slot pairs)
    and added into the i tiles with ``index_add_`` (f32 or f64, see
    ``allpairs.pair_terms``).  Tiles no entry visits stay exactly zero.
    With ``cull`` (tests only) the slot pairs outside the sub-tile pairs
    that ``subtile_keep`` keeps are masked out too, as the kernel's warps
    skip them; the result must not change."""
    use_par = bool(want_bind and parents is not None)
    S = sort_tiles(cfg, pos, types, radii, tile, pair_cap,
                   parents if use_par else None)
    keep = subtile_keep(cfg, S) if cull else None
    dt = pos.dtype
    dev = pos.device
    T, n_t = S.T, S.n_t
    use_radii = bool(cfg.use_radii and radii is not None)
    tabs = plain_tables(cfg, ff, dt)
    box = torch.tensor(cfg.box, dtype=dt, device=dev)
    ibox = torch.tensor([1.0 / b for b in cfg.box], dtype=dt, device=dev)
    cols = [a.reshape(n_t, T) for a in (S.x, S.y, S.z, S.gid, S.types,
                                        S.radii)]
    if use_par:
        cols.append(S.parents.reshape(n_t, T))
    acc = torch.zeros((5, n_t, T), dtype=dt, device=dev)   # fx fy fz ev ec
    binds, jumps = [], []
    P = max(1, (1 << 20) // (T * T))
    for c0 in range(0, S.pair_cap, P):
        it = S.it[c0:c0 + P].long()
        jt = S.jt[c0:c0 + P].long()
        ci = [c[it][:, :, None] for c in cols]
        cj = [c[jt][:, None, :] for c in cols]
        d = []
        for k in range(3):
            dk = ci[k] - cj[k]
            d.append(dk - box[k] * torch.round(dk * ibox[k]))
        dx, dy, dz = d
        r2 = dx * dx + dy * dy + dz * dz
        gi, gj = ci[3], cj[3]
        vm = ((S.vp[c0:c0 + P] > 0)[:, None, None] & (gi >= 0) & (gj >= 0)
              & (gi != gj))
        if keep is not None:
            km = keep[c0:c0 + P].repeat_interleave(CULL_SUB, 1)
            vm = vm & km.repeat_interleave(CULL_SUB, 2)[:, :T, :T]
        inr = vm & (r2 <= cfg.r2_max)
        fsum, ev, ec = pair_terms(cfg, tabs, r2, inr, ci[4], cj[4],
                                  ci[5] if use_radii else None,
                                  cj[5] if use_radii else None)
        rows = torch.stack([torch.sum(fsum * dx, -1), torch.sum(fsum * dy, -1),
                            torch.sum(fsum * dz, -1), ev, ec])
        acc.index_add_(1, it, rows)
        if want_bind or want_jump:
            key = ((jt[:, None, None] * cfg.n_spec + cj[4].long())
                   * cfg.n_at + gj.long())
            b, j = plain_candidates(
                cfg, ff, r2, inr, ci[4], cj[4], gi, gj, key,
                ci[6] if use_par else None, cj[6] if use_par else None,
                want_bind, want_jump)
            binds.append(b)
            jumps.append(j)
    bind = _slot_minima(binds, S, dt) if want_bind else None
    jump = ((_slot_minima([j[0] for j in jumps], S, dt),
             _slot_minima([j[1] for j in jumps], S, dt))
            if want_jump else None)
    return _result(S, acc[:3].reshape(3, n_t * T).T, acc[3].sum(),
                   acc[4].sum(), ff, types, bind, jump)


# --------------------------------------------------------------------------
# the kernel


def pair_forces_sparse(cfg, ff, pos, types, radii=None, parents=None,
                       want_bind=False, want_jump=False, tile=None,
                       pair_cap=None) -> PairResult:
    """Morton block-sparse pair pass: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, the cell-block engine for f64.
    In f32 ``max_occ`` carries the worklist length needed; above the
    capacity the forces of this call are truncated and the runner
    regrows."""
    if pos.dtype == torch.float64:
        return pair_forces_block(cfg, ff, pos, types, radii, parents,
                                 want_bind, want_jump)
    if pos.device.type == "cpu":
        return pair_forces_sparse_plain(cfg, ff, pos, types, radii, parents,
                                        want_bind, want_jump, tile, pair_cap)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    return _sparse_cuda(cfg, ff, pos, types, radii, parents, want_bind,
                        want_jump, tile, pair_cap)


def _lib():
    lib = cuda_build.load("sparse")
    fn = lib.aztotmd_sparse_f32
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 10 + [I] * 6 + [F] * 12 + [P] * 4)
        fn.restype = ctypes.c_int
        cf = lib.aztotmd_sparse_cand_f32
        cf.argtypes = ([P] * 10 + [I] * 6 + [F] * 12 + [P] * 3 + _CAND_C
                       + [P])
        cf.restype = ctypes.c_int
        kf = lib.aztotmd_sparse_kept_f32
        kf.argtypes = [P] * 10 + [I] * 6 + [F] * 12 + [P] * 5
        kf.restype = ctypes.c_int
    return lib


def _sparse_cuda(cfg, ff, pos, types, radii, parents, want_bind, want_jump,
                 tile, pair_cap) -> PairResult:
    N = cfg.n_at
    dev = pos.device
    if pos.dtype != torch.float32:
        raise TypeError("the sparse CUDA kernel is f32 only; got "
                        f"{pos.dtype} (pair_forces_sparse sends f64 to the "
                        "cell-block engine)")
    if cfg.n_spec > 32:
        raise ValueError(f"the sparse kernel takes at most 32 species "
                         f"(shared-memory table), got {cfg.n_spec}")
    check_tensor("pos", pos, torch.float32, (N, 3), dev)
    check_tensor("types", types, torch.int32, (N,), dev)
    if cfg.use_radii and radii is not None:
        check_tensor("radii", radii, torch.float32, (N,), dev)
    c = cand_args(cfg, ff, parents, want_bind, want_jump, dev)
    S = sort_tiles(cfg, pos, types, radii, tile, pair_cap,
                   c.parents if c is not None else None)
    if c is not None:
        c = dataclasses.replace(c, parents=S.parents)
    frc_p, ev_p, ec_p, cr2, ckey = launch(
        cfg, *kernel_tables(cfg, ff, dev, want_bind), S, c)
    return _result(S, frc_p.sum(0), ev_p.sum(), ec_p.sum(), ff, types,
                   *split_candidates(c, cr2, ckey))


def launch(cfg, prm, kinds, S: SortedTiles, cand: CandArgs | None = None,
           kept=None):
    """Launch csrc/sparse.cu on sorted f32 tiles and return its
    (n_split, n_t*T, 3) force and (n_split, n_t*T) energy partial rows,
    and with ``cand`` (parents sorted as the tiles) its (3, n_split,
    n_t*T) r2 and key partial minima (else None).  Counts the launch as
    K4 or, with ``cand``, K4-cand.  The kernel copies the sorted columns
    in 16-byte chunks, so they must be 16-byte aligned (``sort_tiles``'s
    are).  ``kept`` (K4 only), a zeroed (pair_cap,) int64 tensor, takes
    the kernel's record of its cull (see ``kernel_keep``)."""
    global launches, cand_launches
    dev = S.x.device
    n_t, T = S.n_t, S.T
    if T > _MAX_TILE:
        raise ValueError(f"the sparse kernel takes tiles of at most "
                         f"{_MAX_TILE} slots, got {T}")
    cols = [S.x, S.y, S.z, S.gid, S.types, S.radii]
    if cand is not None and cand.parents is not None:
        cols.append(cand.parents)
    if any(a.data_ptr() % 16 for a in cols):
        raise ValueError("the sparse kernel needs 16-byte aligned columns")
    lib = _lib()
    n_split = sparse_split(n_t, sm_count(dev))
    frc_p = torch.empty((n_split, n_t * T, 3), dtype=torch.float32,
                        device=dev)
    ev_p = torch.empty((n_split, n_t * T), dtype=torch.float32, device=dev)
    ec_p = torch.empty((n_split, n_t * T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = [S.x.data_ptr(), S.y.data_ptr(), S.z.data_ptr(),
              S.gid.data_ptr(), S.types.data_ptr(), S.radii.data_ptr(),
              S.row_ptr.data_ptr(), S.jt.data_ptr(), prm.data_ptr(),
              kinds.data_ptr(), cfg.n_spec, n_t, T, n_split,
              int(cfg.use_radii), int(cfg.elec_type), *kernel_consts(cfg),
              frc_p.data_ptr(), ev_p.data_ptr(), ec_p.data_ptr()]
    cr2 = ckey = None
    if kept is not None:
        if cand is not None:
            raise ValueError("the cull record is taken from K4 only")
        check_tensor("kept", kept, torch.int64, (S.pair_cap,), dev)
        err = lib.aztotmd_sparse_kept_f32(*common, kept.data_ptr(), stream)
    elif cand is None:
        err = lib.aztotmd_sparse_f32(*common, stream)
    else:
        cr2 = torch.empty((3, n_split, n_t * T), dtype=torch.float32,
                          device=dev)
        ckey = torch.empty((3, n_split, n_t * T), dtype=torch.int64,
                           device=dev)
        err = lib.aztotmd_sparse_cand_f32(
            *common, cand.donacc.data_ptr(),
            cand.parents.data_ptr() if cand.parents is not None else None,
            *cand.c_args(cfg, cfg.n_at), cr2.data_ptr(), ckey.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"sparse kernel launch failed: CUDA error {err}")
    if cand is None:
        launches += 1
    else:
        cand_launches += 1
    return frc_p, ev_p, ec_p, cr2, ckey
