"""Pair-pass result and the O(N^2) oracle (port of
``aztotmd_tpu/ops/pairs.py``: ``PairResult``, ``min_image``,
``all_pairs_forces``).  The oracle builds the full (N, N) matrices; the
engines are checked against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..io.control import ELEC_NONE

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
    box = torch.as_tensor(cfg.box, dtype=delta.dtype, device=delta.device)
    return delta - box * torch.round(delta / box)


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
