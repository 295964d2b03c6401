"""Pair-pass result, the "gather" engine, the O(N^2) oracle and the
bind/jump candidate selection (port of ``aztotmd_tpu/ops/pairs.py``:
``PairResult``, ``min_image``, ``pair_forces``, ``all_pairs_forces``,
``bind_jump_candidates``, ``bind_jump_candidates_rows``,
``_jump_candidates``, ``_row_argmin``).  The "gather" engine gathers each
atom's stencil-cell candidates into an (N, S * cap) matrix and evaluates
it with masks (torch ops on either device, as JAX's is XLA: no Pallas
kernel lies on it).  The oracle builds the full (N, N) matrices; the
engines are checked against it.  The candidate selection is the try_to_bind / try_to_jump
registration of the reference's pair kernel as row minima: a bond
candidate is the nearest atom in bonding range of a bonding species
pair that is not already the row's parent (nor has the row as its
parent); a jump candidate is a donor row's nearest acceptor or an
acceptor row's nearest donor within ``r2_elec``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..io.control import ELEC_NONE

from . import cell_list as cl
from .consts import const
from .elec import coul_eval
from .vdw import vdw_eval

MX_FRC = 1.0e4      # force auto-cap on force-over-r per pair


@dataclass
class PairResult:
    frc: torch.Tensor          # (N, 3)
    eng_vdw: torch.Tensor      # scalar
    eng_coul: torch.Tensor     # scalar
    max_occ: torch.Tensor      # cell-occupancy monitor (0 for dense passes)
    bind_idx: torch.Tensor     # nearest bonding partner per atom (N = none)
    bind_r2: torch.Tensor
    jump_idx: torch.Tensor     # nearest e-jump partner per atom (N = none)
    jump_r2: torch.Tensor


def no_candidates(n: int, dtype, device):
    """(idx, r2) sentinels of a pass without bind/jump candidates."""
    return (torch.full((n,), n, dtype=torch.int32, device=device),
            torch.full((n,), float("inf"), dtype=dtype, device=device))


def min_image(delta, cfg):
    box = const(cfg.box, delta.dtype, delta.device)
    return delta - box * torch.round(delta / box)


def pair_forces(cfg, ff, pos, types, radii=None, parents=None,
                want_bind: bool = False, want_jump: bool = False
                ) -> PairResult:
    """The "gather" engine: every atom's candidates from the stencil cells
    of ``cfg.grid`` as an (N, M) matrix, masked physics on it, forces as
    row sums (each pair seen from both sides), energies as half sums, the
    bind and jump candidates as row minima, and the fullest cell's
    occupancy as ``max_occ``."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    nsp = cfg.n_spec

    coords = cl.cell_coords(cfg, pos)
    table, max_occ = cl.build_cell_table(cfg, pos)
    cand = cl.gather_candidates(cfg, table, coords)           # (N, M)
    cl_ = cand.long()
    pos_p = torch.cat([pos, torch.zeros((1, 3), dtype=dt, device=dev)])
    types_p = torch.cat([types, torch.zeros(1, dtype=types.dtype,
                                            device=dev)])
    delta = min_image(pos[:, None, :] - pos_p[cl_], cfg)
    r2 = torch.sum(delta * delta, dim=-1)
    own = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    valid = (cand != N) & (cand != own)
    mask = valid & (r2 <= cfg.r2_max)
    r2s = torch.where(mask, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    zero = torch.zeros_like(r2s)

    tj = types_p[cl_]
    ti = types[:, None]
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
        if cfg.use_radii:
            rad_p = torch.cat([radii, torch.ones((1,), dtype=dt,
                                                 device=dev)])
            rad_i = radii[:, None].expand(r2s.shape)
            rad_j = rad_p[cl_]
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
    frc = torch.einsum("nm,nmk->nk", f, delta)

    bind_idx, bind_r2 = no_candidates(N, dt, dev)
    jump_idx, jump_r2 = bind_idx.clone(), bind_r2.clone()
    if want_bind:
        tpair = (ti * nsp + tj).long()
        can = ((ff.bonding_matr.reshape(-1)[tpair] != 0) & valid
               & (r2 <= ff.bind_r2.reshape(-1)[tpair]))
        if parents is not None:
            par_p = torch.cat([parents, torch.full((1,), -1,
                                                   dtype=parents.dtype,
                                                   device=dev)])
            can = can & (parents[:, None] != cand) & (par_p[cl_] != own)
        bind_idx, bind_r2 = _row_argmin(cand, r2, can, N)
    if want_jump:
        jump_idx, jump_r2 = _jump_candidates(cfg, ff, types, tj, cand, r2,
                                             valid)
    return PairResult(frc=frc, eng_vdw=0.5 * torch.sum(ev),
                      eng_coul=0.5 * torch.sum(ec), max_occ=max_occ,
                      bind_idx=bind_idx, bind_r2=bind_r2,
                      jump_idx=jump_idx, jump_r2=jump_r2)


def bind_jump_candidates(cfg, ff, pos, types, parents=None,
                         want_bind=True, want_jump=True):
    """Bind/jump candidates of every atom over the cell-list candidate
    matrix, without the force work: (bind_idx, bind_r2, jump_idx,
    jump_r2), sentinel id N and r2 inf."""
    N = cfg.n_at
    table, _ = cl.build_cell_table(cfg, pos)
    own = torch.arange(N, dtype=torch.int32, device=pos.device)
    return bind_jump_candidates_rows(
        cfg, ff, table, pos, types, parents, pos, own, types, parents,
        want_bind=want_bind, want_jump=want_jump)


def bind_jump_candidates_rows(cfg, ff, table, pos, types, parents,
                              row_pos, row_own, row_types, row_parents,
                              want_bind=True, want_jump=True):
    """Candidate selection for a set of rows against the cell table
    ``table`` built over the global ``pos``.  ``row_own`` is the global
    id of each row (N for a dead row)."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    nsp = cfg.n_spec
    coords = cl.cell_coords(cfg, row_pos)
    cand = cl.gather_candidates(cfg, table, coords)          # (R, M)
    cl_ = cand.long()
    pos_p = torch.cat([pos, torch.zeros((1, 3), dtype=dt, device=dev)])
    types_p = torch.cat([types, torch.zeros(1, dtype=types.dtype,
                                            device=dev)])
    delta = min_image(row_pos[:, None, :] - pos_p[cl_], cfg)
    r2 = torch.sum(delta * delta, dim=-1)
    own = row_own[:, None]
    valid = (cand != N) & (cand != own) & (own != N)
    tj = types_p[cl_]
    R = row_pos.shape[0]
    none_idx = torch.full((R,), N, dtype=torch.int32, device=dev)
    none_r2 = torch.full((R,), float("inf"), dtype=dt, device=dev)
    bind_idx, bind_r2 = none_idx, none_r2
    if want_bind:
        tpair = (row_types[:, None] * nsp + tj).long()
        can = ((ff.bonding_matr.reshape(-1)[tpair] != 0) & valid
               & (r2 <= ff.bind_r2.reshape(-1)[tpair]))
        if parents is not None:
            par_p = torch.cat([parents, torch.full((1,), -1,
                                                   dtype=parents.dtype,
                                                   device=dev)])
            can = can & (row_parents[:, None] != cand) & (par_p[cl_] != own)
        bind_idx, bind_r2 = _row_argmin(cand, r2, can, N)
    jump_idx, jump_r2 = none_idx.clone(), none_r2.clone()
    if want_jump:
        jump_idx, jump_r2 = _jump_candidates(cfg, ff, row_types, tj, cand,
                                             r2, valid, sentinel=N)
    return bind_idx, bind_r2, jump_idx, jump_r2


def jump_roles(ff, types):
    """(donor, acceptor) bool masks of species ids ``types``."""
    da = ff.spec_donacc[types.long()]
    return (da & 1) != 0, (da & 2) != 0


def _jump_candidates(cfg, ff, types, tj, cand, r2, valid, sentinel=None):
    """Per-role jump candidates: a donor row takes its nearest acceptor,
    any other row its nearest donor (both within r2_elec)."""
    N = types.shape[0] if sentinel is None else sentinel
    don_i, acc_i = jump_roles(ff, types)
    don_j, acc_j = jump_roles(ff, tj)
    rng = valid & (r2 <= cfg.r2_elec)
    idx_d, r2_d = _row_argmin(cand, r2, don_i[:, None] & acc_j & rng, N)
    idx_a, r2_a = _row_argmin(cand, r2, acc_i[:, None] & don_j & rng, N)
    return (torch.where(don_i, idx_d, idx_a),
            torch.where(don_i, r2_d, r2_a))


def _row_argmin(cand, r2, mask, sentinel):
    """Nearest masked candidate per row: (idx, r2); sentinel when none.
    Ties go to the first column, as ``jnp.argmin``."""
    r2m = torch.where(mask, r2, torch.full_like(r2, float("inf")))
    j = torch.argmin(r2m, dim=1, keepdim=True)
    best_r2 = torch.gather(r2m, 1, j)[:, 0]
    best_id = torch.where(torch.isfinite(best_r2),
                          torch.gather(cand, 1, j)[:, 0].to(torch.int32),
                          sentinel)
    return best_id.to(torch.int32), best_r2


def keyed_row_min(r2, mask, key):
    """Row minimum of ``r2`` over ``mask`` with ties broken by the least
    int64 ``key``: (min r2, its key), r2 inf and key -1 for empty rows."""
    r2m = torch.where(mask, r2, torch.full_like(r2, float("inf")))
    m = torch.amin(r2m, dim=-1)
    big = torch.iinfo(torch.int64).max
    k = torch.amin(torch.where(mask & (r2m == m[..., None]), key, big),
                   dim=-1)
    return m, torch.where(k == big, -1, k)


def candidate_ids(m, k, N: int, dtype):
    """(min r2, key) row minima whose key ends in ``* N + id`` -> (N,)
    int32 ids and r2 in ``dtype``, sentinel id N where there is none."""
    return (torch.where(torch.isfinite(m), k % N, N).to(torch.int32),
            m.to(dtype))


def pair_result(frc, ev, ec, max_occ, ff=None, types=None, bind=None,
                jump=None) -> PairResult:
    """PairResult of a pass; ``bind`` is its (min r2, key) row minima,
    ``jump`` the (donor-row, acceptor-row) pair of them, None when the
    pass did not look for them."""
    N = frc.shape[0]
    dt = frc.dtype
    bind_idx, bind_r2 = no_candidates(N, dt, frc.device)
    jump_idx, jump_r2 = bind_idx.clone(), bind_r2.clone()
    if bind is not None:
        bind_idx, bind_r2 = candidate_ids(*bind, N, dt)
    if jump is not None:
        jd_idx, jd_r2 = candidate_ids(*jump[0], N, dt)
        ja_idx, ja_r2 = candidate_ids(*jump[1], N, dt)
        don_row = jump_roles(ff, types)[0]
        jump_idx = torch.where(don_row, jd_idx, ja_idx)
        jump_r2 = torch.where(don_row, jd_r2, ja_r2)
    return PairResult(frc=frc, eng_vdw=ev, eng_coul=ec, max_occ=max_occ,
                      bind_idx=bind_idx, bind_r2=bind_r2,
                      jump_idx=jump_idx, jump_r2=jump_r2)


def all_pairs_forces(cfg, ff, pos, types, radii=None) -> PairResult:
    """Dense O(N^2) traversal with masked family evaluation — the oracle."""
    N = cfg.n_at
    dev = pos.device
    delta = min_image(pos[:, None, :] - pos[None, :, :], cfg)
    r2 = torch.sum(delta * delta, dim=-1)
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    mask = (~eye) & (r2 <= cfg.r2_max)
    one = torch.ones_like(r2)
    r2s = torch.where(mask, r2, one)
    r = torch.sqrt(r2s)
    nsp = cfg.n_spec
    tp = (types[:, None] * nsp + types[None, :]).long()
    zero = torch.zeros_like(r2)

    if cfg.elec_type != ELEC_NONE:
        fc, ec = coul_eval(cfg, r2s, r, ff.chprod.reshape(-1)[tp])
        fc = torch.where(mask, fc, zero)
        ec = torch.where(mask, ec, zero)
    else:
        fc = ec = zero

    if cfg.vdw_families:
        kind = ff.vdw_kind.reshape(-1)[tp]
        vp = ff.vdw_p.reshape(-1, 5)[tp]
        vmask = mask & (r2 <= ff.vdw_r2cut.reshape(-1)[tp])
        kind = torch.where(vmask, kind, torch.zeros_like(kind))
        if cfg.use_radii:
            rad_i = radii[:, None].expand_as(r2s)
            rad_j = radii[None, :].expand_as(r2s)
        else:
            rad_i = rad_j = None
        fv, ev = vdw_eval(kind, vp, r2s, r, rad_i, rad_j,
                          families=cfg.vdw_families)
        fv = torch.where(vmask, fv, zero)
        ev = torch.where(vmask, ev, zero)
    else:
        fv = ev = zero

    f = torch.clamp(fc + fv, -MX_FRC, MX_FRC)
    frc = torch.einsum("nm,nmk->nk", f, delta)
    idx, r2n = no_candidates(N, pos.dtype, dev)
    return PairResult(frc=frc, eng_vdw=0.5 * torch.sum(ev),
                      eng_coul=0.5 * torch.sum(ec),
                      max_occ=torch.zeros((), dtype=torch.int32, device=dev),
                      bind_idx=idx, bind_r2=r2n, jump_idx=idx.clone(),
                      jump_r2=r2n.clone())
