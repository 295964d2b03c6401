"""Electrostatics (port of ``aztotmd_tpu/ops/elec.py``): the pair-level
Coulomb terms (none, direct, Ewald real space, Fennel damped-shifted
force) and the reciprocal-space Ewald sum.

The reciprocal sum is two dense products, ``pos @ rk.T`` for the phases
and ``coef @ rk`` for the forces, over a half-space k-vector table built
on the host in f64.  They are outside any kernel in the reference and
stay ``torch.matmul`` here; in f32 they must run in full f32 (the phases
are positions times k, tens of radians), so TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32`` is False by default).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import units
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


def make_kvectors(cfg):
    """The half-space k-vector table (host, f64): l in [0, kx), m in
    [mmin, ky), n in [nmin, kz), with mmin and nmin opening to negative
    values after the first row, under the spherical cutoff ``rkcut2``.
    Returns (rk (K, 3), weights (K,)) with weight exp(-k^2/4a^2)/k^2."""
    kx, ky, kz = cfg.kmax
    la, lb, lc = cfg.box
    c = -0.25 / (cfg.alpha * cfg.alpha)
    rks, ws = [], []
    mmin, nmin = 0, 1
    for l in range(kx):
        rkx = l * units.TWOPI / la
        for m in range(mmin, ky):
            rky = m * units.TWOPI / lb
            for n in range(nmin, kz):
                rkz = n * units.TWOPI / lc
                rk2 = rkx * rkx + rky * rky + rkz * rkz
                if rk2 < cfg.rkcut2:
                    rks.append((rkx, rky, rkz))
                    ws.append(math.exp(c * rk2) / rk2)
            nmin = 1 - kz
        mmin = 1 - ky
    return (np.asarray(rks, dtype=np.float64).reshape(-1, 3),
            np.asarray(ws, dtype=np.float64))


def ewald_recip(cfg, pos, charge, rk, w, allsum=None):
    """Reciprocal-space forces (N, 3) and energy (scalar) of charges
    ``charge`` (N,) at ``pos`` (N, 3) over the table ``rk`` (K, 3) with
    weights ``w`` (K,): E = escale * sum_k w |S(k)|^2 over the half space,
    S(k) = sum_i q_i exp(i k.r_i), and the forces from its gradient.

    ``allsum``: on a slab mesh, the function that sums a partial over the
    slabs (the JAX package's ``axis=``, a psum): S(k) is then the sum of
    every slab's partial structure factor, the energy the global one and
    the forces those of the local atoms."""
    dt = pos.dtype
    escale = cfg.ewald_scale
    fscale = 2.0 * cfg.ewald_scale
    rk = rk.to(dt)
    w = w.to(dt)
    theta = pos @ rk.T                             # (N, K) phases
    qc = charge[:, None] * torch.cos(theta)        # Re q e^{i theta}
    qs = charge[:, None] * torch.sin(theta)        # Im
    s_re = torch.sum(qc, dim=0)                    # (K,)
    s_im = torch.sum(qs, dim=0)
    if allsum is not None:
        s_re, s_im = allsum(s_re), allsum(s_im)
    eng = escale * torch.sum(w * (s_re * s_re + s_im * s_im))
    coef = fscale * w * (qs * s_re[None, :] - qc * s_im[None, :])   # (N, K)
    return coef @ rk, eng


def ewald_self_energy(charges_per_atom, cfg) -> float:
    """Constant part of the Ewald sum: -alpha/sqrt(pi) sum q_i^2
    - pi/(2 alpha^2 V) (sum q_i)^2, times Fcoul/eps (host, f64)."""
    q = np.asarray(charges_per_atom, dtype=np.float64)
    sq = q.sum()
    eng = -(q * q).sum() * cfg.alpha / units.SQRTPI
    eng += -0.5 * units.PI * sq * sq / (cfg.alpha ** 2) / cfg.volume
    return units.FCOUL_SCALE * eng / cfg.eps
