"""Pair-level Coulomb terms (port of ``aztotmd_tpu/ops/elec.py::coul_eval``).

None, direct, Ewald real space and Fennel damped-shifted force.  The Ewald
reciprocal sum waits for its ROADMAP item.
"""

from __future__ import annotations

import torch

from ..io.control import (ELEC_DIRECT, ELEC_EWALD, ELEC_FENNEL,
                          ELEC_NONE)


def coul_eval(cfg, r2, r, chprod):
    """Pair Coulomb force-over-r and energy; ``chprod`` carries 1/eps.
    Returns (f, e) with F_i = f * (r_i - r_j)."""
    kqq = chprod * cfg.coul_scale
    ri = 1.0 / r
    r2i = 1.0 / r2
    if cfg.elec_type == ELEC_NONE:
        z = torch.zeros_like(r2)
        return z, z
    if cfg.elec_type == ELEC_DIRECT:
        return kqq * ri * r2i, kqq * ri
    if cfg.elec_type == ELEC_EWALD:
        ar = cfg.alpha * r
        erfcar = torch.special.erfc(ar)
        e = kqq * erfcar * ri
        f = kqq * ri * r2i * (erfcar + cfg.daipi2 * r * torch.exp(-ar * ar))
        return f, e
    if cfg.elec_type == ELEC_FENNEL:
        ar = cfg.alpha * r
        erfcar = torch.special.erfc(ar)
        e = kqq * (erfcar * ri - cfg.fennel_c1
                   + cfg.fennel_c2 * (r - cfg.r_real))
        f = kqq * ri * ((erfcar * r2i + cfg.daipi2 * torch.exp(-ar * ar) * ri)
                        - cfg.fennel_c2)
        return f, e
    raise ValueError(f"unknown elec type {cfg.elec_type}")
