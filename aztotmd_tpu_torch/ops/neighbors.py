"""Verlet neighbor list with skin (port of ``aztotmd_tpu/ops/neighbors.py``).

Candidates within ``r_max + nb_skin`` are collected from the stencil
cells of ``cfg.nb_grid`` into a fixed-shape (N, K) list of atom ids
(sentinel N); between rebuilds the pair pass walks only that list.  The
two-level form keeps an outer (N, K2) list at ``r_max + nb_skin2`` and
refines the inner list from it.  The row-compacted walk visits only the
rows that have a neighbor.

Every selection is ordered as the JAX package orders it: its ``top_k``
and ``lax.sort`` are a stable ascending sort here (``top_k`` of -x keeps
the lower column first among equal values, as a stable sort of x does),
on keys cast to f32 as JAX casts them, so an f64 run also orders by f32
r2 with ties broken by column.  On dilute decks (``nb_orowcap`` > 0) the
row refine sweeps only the rows that had an outer neighbor at the last
full rebuild (``compact_orows``).  No function synchronises with the
host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.control import ELEC_NONE
from . import cell_list as cl
from .elec import coul_eval
from .pairs import (MX_FRC, PairResult, _jump_candidates, _row_argmin,
                    min_image)
from .vdw import vdw_eval


def sorted_build_ok(cfg) -> bool:
    """True when ``build_neighbors`` takes the fused sorted pipeline (its
    lists nearest-first at the build positions, ``build_neighbors_keys``
    available)."""
    if cfg.nb_grid is None:
        return False
    M = len(cfg.nb_grid.stencil) * cfg.nb_grid.cap
    return M <= 1024 and cfg.n_at < (1 << 24)   # f32 ids must be exact


def _sel_first(key, k: int):
    """Columns of the k smallest ``key`` entries per row, ties by column
    (``lax.top_k(-key, k)``'s order)."""
    return torch.sort(key, dim=1, stable=True).indices[:, :k]


def _pad_cols(a, k: int, fill):
    """``a`` (R, c) padded to k columns with ``fill``."""
    if a.shape[1] >= k:
        return a
    pad = torch.full((a.shape[0], k - a.shape[1]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def _r2(row_pos, cand_pos, cfg):
    delta = min_image(row_pos[:, None, :] - cand_pos, cfg)
    return torch.sum(delta * delta, dim=-1)


def _pad_row(a, fill):
    """``a`` with one more row of ``fill`` (the sentinel's row)."""
    return torch.cat([a, torch.full((1,) + a.shape[1:], fill, dtype=a.dtype,
                                    device=a.device)])


def build_neighbors_keys(cfg, pos):
    """Fused sorted candidate pass (requires ``sorted_build_ok(cfg)``):
    whole cell rows of the position table gathered, then a stable row
    sort on the masked r2 cast to f32.

    Returns (idx (N, K) nearest-first, skey (N, K) f32 sorted r2 with inf
    padding, n_real_max, max_occ)."""
    N = cfg.n_at
    K = cfg.n_neigh
    gcfg = dataclasses.replace(cfg, grid=cfg.nb_grid)
    cap = gcfg.grid.cap
    M = len(gcfg.grid.stencil) * cap
    dev = pos.device
    r_nb = cfg.r_max + cfg.nb_skin

    ptab, max_occ = cl.build_pos_table(gcfg, pos)
    ptab_rows = ptab.reshape(gcfg.grid.n_cell, cap * 4)
    ncid = cl.stencil_cell_ids(gcfg, cl.cell_coords(gcfg, pos))   # (N, S)
    g = ptab_rows[ncid.long()].reshape(N, M, 4)
    r2 = _r2(pos, g[..., :3], cfg)
    cand = g[..., 3].to(torch.int32)
    own = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    mask = (cand != N) & (cand != own) & (r2 <= r_nb * r_nb)

    key = torch.where(mask, r2, torch.full_like(r2, float("inf"))) \
        .to(torch.float32)
    skey, order = torch.sort(key, dim=1, stable=True)
    kk = min(K, M)
    skey = skey[:, :kk]
    sval = torch.gather(cand, 1, order[:, :kk])
    idx = torch.where(torch.isfinite(skey), sval, N).to(torch.int32)
    idx = _pad_cols(idx, K, N)
    skey = _pad_cols(skey, K, float("inf"))
    n_real = torch.sum(mask, dim=1)
    return idx, skey, torch.max(n_real).to(torch.int32), max_occ


def prefix_refine(idx, skey, reach, K, n_at):
    """Refine a sorted list to a smaller reach at the build positions: the
    entries within ``reach`` are the leading columns with skey <= reach^2
    (in f32).  Returns (idx (N, K), n_max), sentinel ``n_at``."""
    within = skey <= float(np.float32(reach * reach))
    k2 = min(K, idx.shape[1])
    out = torch.where(within[:, :k2], idx[:, :k2], n_at).to(torch.int32)
    out = _pad_cols(out, K, n_at)
    return out, torch.max(torch.sum(within, dim=1)).to(torch.int32)


def build_neighbors(cfg, pos):
    """(N, K) neighbor ids within r_max + nb_skin (sentinel N),
    n_real_max and max_occ.  The sorted pipeline when
    ``sorted_build_ok``; otherwise the cell-table gather with K <= 32 the
    K nearest (stable, f32 keys) and K > 32 the first K candidates in
    stencil order (a cumsum and a scatter), both monitored through
    n_real_max."""
    N = cfg.n_at
    K = cfg.n_neigh
    if sorted_build_ok(cfg):
        idx, _, nmax, max_occ = build_neighbors_keys(cfg, pos)
        return idx, nmax, max_occ

    gcfg = dataclasses.replace(cfg, grid=cfg.nb_grid)
    dev = pos.device
    r_nb = cfg.r_max + cfg.nb_skin
    table, max_occ = cl.build_cell_table(gcfg, pos)
    cand = cl.gather_candidates(gcfg, table, cl.cell_coords(gcfg, pos))
    pos_p = _pad_row(pos, 0.0)
    r2 = _r2(pos, pos_p[cand.long()], cfg)
    own = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    mask = (cand != N) & (cand != own) & (r2 <= r_nb * r_nb)

    if K <= 32:
        r2m = torch.where(mask, r2, torch.full_like(r2, float("inf")))
        sel = _sel_first(r2m.to(torch.float32), K)
        idx = torch.gather(cand, 1, sel)
        keep = torch.gather(mask, 1, sel)
        idx = torch.where(keep, idx, N).to(torch.int32)
        n_real = torch.sum(mask, dim=1)
    else:
        cnt = torch.cumsum(mask.to(torch.int32), dim=1)
        tgt = torch.where(mask & (cnt <= K), cnt - 1, K)    # K = dump slot
        out = torch.full((N, K + 1), N, dtype=torch.int32, device=dev)
        out.scatter_(1, tgt.long(), cand)
        idx = out[:, :K]
        n_real = cnt[:, -1]
    return idx, torch.max(n_real).to(torch.int32), max_occ


def pair_forces_neighbors(cfg, ff, pos, types, nbr_idx, radii=None,
                          parents=None, want_bind: bool = False,
                          want_jump: bool = False) -> PairResult:
    """Pair physics over the (N, K) neighbor list: the cell engines'
    PairResult (bind and jump radii lie within the list's reach)."""
    return _walk(cfg, ff, pos, types, nbr_idx, rows=None, radii=radii,
                 parents=parents, want_bind=want_bind, want_jump=want_jump)


def pair_forces_rows(cfg, ff, pos, types, nbrow_idx, radii=None,
                     parents=None, want_bind: bool = False,
                     want_jump: bool = False) -> PairResult:
    """The walk over the compacted rows (``compact_rows``): the same
    per-row sums as ``pair_forces_neighbors``, added back to the atoms'
    rows, whose ids are unique; padding rows go to a dump row N that is
    cut off."""
    return _walk(cfg, ff, pos, types, nbrow_idx[:, 1:],
                 rows=nbrow_idx[:, 0], radii=radii, parents=parents,
                 want_bind=want_bind, want_jump=want_jump)


def compact_rows(nbr_idx, r_cap: int, n_at: int):
    """Compact the (N, K) list to the rows with a real neighbor: (nbrow
    (r_cap, 1 + K) int32, n_rows).  Column 0 is the atom id, ascending
    (sentinel N on padding rows), columns 1..K its list; n_rows is the
    true count of occupied rows (past r_cap the highest ids are
    dropped)."""
    N = n_at
    has = torch.any(nbr_idx != N, dim=1)
    n_rows = torch.sum(has, dtype=torch.int32)
    key = torch.where(has, torch.arange(N, dtype=torch.int32,
                                        device=nbr_idx.device), N)
    rows = torch.sort(key).values[:r_cap].to(torch.int32)
    nbr_p = _pad_row(nbr_idx, N)
    nbrow = torch.cat([rows[:, None], nbr_p[rows.long()]], dim=1)
    return nbrow, n_rows


def compact_orows(idx2, o_cap: int, n_at: int):
    """Ascending ids of the rows with at least one entry in the outer
    (N, K2) list, padded with the sentinel ``n_at`` to ``o_cap`` entries
    (o_cap <= N), and the true count of such rows (past o_cap the highest
    ids are dropped: the ``orow_over`` monitor).  Computed at each full
    rebuild; a row empty here refines to an empty inner list until the
    next one."""
    N = n_at
    if o_cap > N:
        # lax.top_k refuses k past the axis too
        raise ValueError(f"compact_orows: o_cap {o_cap} exceeds the {N} "
                         "rows")
    has = torch.any(idx2 != N, dim=1)
    n_rows = torch.sum(has, dtype=torch.int32)
    key = torch.where(has, torch.arange(N, dtype=torch.int32,
                                        device=idx2.device), N)
    orow = torch.sort(key, stable=True).values[:o_cap].to(torch.int32)
    return orow, n_rows


def _walk(cfg, ff, pos, types, cand, rows=None, radii=None, parents=None,
          want_bind: bool = False, want_jump: bool = False) -> PairResult:
    """The walk: rows=None walks all N atoms (row r = atom r), otherwise
    ``rows`` (R,) maps rows to atom ids (sentinel N).  Sentinel candidate
    ids are clipped to N - 1 and masked to zero."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    nsp = cfg.n_spec

    types_p = _pad_row(types, 0)
    cand_c = torch.clamp(cand, max=N - 1).long()
    if rows is None:
        pos_i = pos
        row_types = types
    else:
        rows_l = rows.long()
        pos_i = pos[torch.clamp(rows_l, max=N - 1)]
        row_types = types_p[rows_l]
    delta = min_image(pos_i[:, None, :] - pos[cand_c], cfg)
    r2 = torch.sum(delta * delta, dim=-1)
    valid = cand != N
    mask = valid & (r2 <= cfg.r2_max)
    r2s = torch.where(mask, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    zero = torch.zeros_like(r2s)

    cand_l = cand.long()
    tj = types_p[cand_l]
    ti = row_types[:, None]

    if cfg.elec_type != ELEC_NONE:
        tp = (ti * nsp + tj).long()
        fc, ec = coul_eval(cfg, r2s, r, ff.chprod.reshape(-1)[tp])
        fc = torch.where(mask, fc, zero)
        ec = torch.where(mask, ec, zero)
    else:
        fc = ec = zero

    if cfg.vdw_families:
        if nsp == 1:
            kind = ff.vdw_kind[0, 0].expand(r2s.shape)
            vp = ff.vdw_p[0, 0].expand(r2s.shape + (5,))
            r2cut = ff.vdw_r2cut[0, 0]
        else:
            tp = (ti * nsp + tj).long()
            kind = ff.vdw_kind.reshape(-1)[tp]
            vp = ff.vdw_p.reshape(-1, 5)[tp]
            r2cut = ff.vdw_r2cut.reshape(-1)[tp]
        vmask = mask & (r2 <= r2cut)
        if cfg.use_radii and radii is not None:
            rad_p = _pad_row(radii, 1.0)
            rad_row = radii if rows is None else rad_p[rows_l]
            rad_i = rad_row[:, None].expand(r2s.shape)
            rad_j = rad_p[cand_l]
        else:
            rad_i = rad_j = None
        kind = torch.where(vmask, kind, torch.zeros_like(kind))
        fv, ev = vdw_eval(kind, vp, r2s, r, rad_i, rad_j,
                          families=cfg.vdw_families)
        fv = torch.where(vmask, fv, zero)
        ev = torch.where(vmask, ev, zero)
    else:
        fv = ev = zero

    f = torch.clamp(fc + fv, -MX_FRC, MX_FRC)
    frow = torch.sum(f[:, :, None] * delta, dim=1)
    eng_vdw = 0.5 * torch.sum(ev)
    eng_coul = 0.5 * torch.sum(ec)

    R = cand.shape[0]
    none_idx = torch.full((R,), N, dtype=torch.int32, device=dev)
    none_r2 = torch.full((R,), float("inf"), dtype=dt, device=dev)
    bind_idx, bind_r2 = none_idx, none_r2
    if want_bind:
        tpair = (ti * nsp + tj).long()
        can = ((ff.bonding_matr.reshape(-1)[tpair] != 0) & valid
               & (r2 <= ff.bind_r2.reshape(-1)[tpair]))
        if parents is not None:
            own = (torch.arange(N, dtype=torch.int32, device=dev)[:, None]
                   if rows is None else rows[:, None])
            par_p = _pad_row(parents, -1)
            par_row = parents if rows is None else par_p[rows_l]
            can = can & (par_row[:, None] != cand) & (par_p[cand_l] != own)
        bind_idx, bind_r2 = _row_argmin(cand, r2, can, N)
    jump_idx, jump_r2 = none_idx.clone(), none_r2.clone()
    if want_jump:
        jump_idx, jump_r2 = _jump_candidates(cfg, ff, row_types, tj, cand,
                                             r2, valid, sentinel=N)
        jump_r2 = jump_r2.to(dt)

    if rows is not None:
        # back to per-atom arrays: the real rows' ids are unique, the
        # padding rows all land on the dump row N
        def put(fill, val):
            buf = torch.full((N + 1,) + val.shape[1:], fill, dtype=val.dtype,
                             device=dev)
            buf[rows_l] = val
            return buf[:N]
        frc = torch.zeros((N + 1, 3), dtype=dt, device=dev) \
            .index_add_(0, rows_l, frow)[:N]
        bind_idx, bind_r2 = put(N, bind_idx), put(float("inf"), bind_r2)
        jump_idx, jump_r2 = put(N, jump_idx), put(float("inf"), jump_r2)
    else:
        frc = frow

    return PairResult(frc=frc, eng_vdw=eng_vdw, eng_coul=eng_coul,
                      max_occ=torch.zeros((), dtype=torch.int32, device=dev),
                      bind_idx=bind_idx, bind_r2=bind_r2,
                      jump_idx=jump_idx, jump_r2=jump_r2)


def _refine_select(cfg, row_pos, cand, pos_p):
    """The K nearest of each row's candidates ``cand`` within
    r_max + nb_skin: (idx (R, K), mask of the candidates in reach)."""
    N = cfg.n_at
    K = cfg.n_neigh
    r_nb = cfg.r_max + cfg.nb_skin
    r2 = _r2(row_pos, pos_p[cand.long()], cfg)
    mask = (cand != N) & (r2 <= r_nb * r_nb)
    r2m = torch.where(mask, r2, torch.full_like(r2, float("inf")))
    cols = _sel_first(r2m.to(torch.float32), min(K, cand.shape[1]))
    idx = torch.gather(cand, 1, cols)
    keep = torch.gather(mask, 1, cols)
    idx = torch.where(keep, idx, N).to(torch.int32)
    return _pad_cols(idx, K, N), mask


def refine_neighbors(cfg, pos, nbr2):
    """Inner refine: the n_neigh nearest within r_max + nb_skin from the
    outer (N, K2) list.  Returns (idx (N, K), n_real_max)."""
    idx, mask = _refine_select(cfg, pos, nbr2, _pad_row(pos, 0.0))
    return idx, torch.max(torch.sum(mask, dim=1)).to(torch.int32)


def refine_neighbors_rows(cfg, pos, nbr2, r_cap: int, orow=None):
    """Row-first inner refine for the row-compacted walk: count each
    row's outer entries in reach, take the occupied rows (ascending, at
    most r_cap), and refine only those.  ``orow`` (``compact_orows``,
    o_cap >= r_cap entries) restricts the count to the rows that had an
    outer entry at the last full rebuild; its sentinel entries N read
    the all-sentinel padding row of the outer list and count zero.  The
    lists are the same: a row with an empty outer list refines to an
    empty inner list.

    Returns (idx (N, K), nbrow (r_cap, 1 + K), n_real_max, n_rows): idx
    and nbrow equal ``refine_neighbors`` + ``compact_rows`` on every
    occupied row when n_rows <= r_cap; past r_cap both drop the highest
    ids (the nbrow_over monitor)."""
    N = cfg.n_at
    K = cfg.n_neigh
    dev = pos.device
    r_nb = cfg.r_max + cfg.nb_skin
    pos_p = _pad_row(pos, 0.0)

    if orow is None:
        row_ids = torch.arange(N, dtype=torch.int32, device=dev)
        r2 = _r2(pos, pos_p[nbr2.long()], cfg)
        cnt = nbr2
    else:
        if r_cap > orow.shape[0]:
            raise ValueError(f"refine_neighbors_rows: r_cap {r_cap} exceeds "
                             f"the {orow.shape[0]} outer-occupied row slots")
        row_ids = orow
        cnt = _pad_row(nbr2, N)[orow.long()]               # (o_cap, K2)
        r2 = _r2(pos_p[orow.long()], pos_p[cnt.long()], cfg)
    n_real = torch.sum((cnt != N) & (r2 <= r_nb * r_nb), dim=1)
    has = n_real > 0
    nmax = torch.max(n_real).to(torch.int32)
    n_rows = torch.sum(has, dtype=torch.int32)

    key = torch.where(has, row_ids, N)
    rows = torch.sort(key).values[:r_cap].to(torch.int32)
    rows_l = rows.long()
    cr = _pad_row(nbr2, N)[rows_l]                         # (r_cap, K2)
    idx_r, _ = _refine_select(cfg, pos_p[rows_l], cr, pos_p)
    nbrow = torch.cat([rows[:, None], idx_r], dim=1)

    idx = torch.full((N + 1, K), N, dtype=torch.int32, device=dev)
    idx[rows_l] = idx_r
    return idx[:N], nbrow, nmax, n_rows


def build_outer_neighbors(cfg, pos):
    """The full candidate pass at the outer reach r_max + nb_skin2 into an
    (N, n_neigh2) list: (idx2, n_real2_max, max_occ)."""
    ocfg = dataclasses.replace(cfg, n_neigh=cfg.n_neigh2,
                               nb_skin=cfg.nb_skin2)
    return build_neighbors(ocfg, pos)
