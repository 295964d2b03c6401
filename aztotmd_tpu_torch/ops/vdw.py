"""Short-range pair potential families (port of ``aztotmd_tpu/ops/vdw.py``).

The per-pair family is an integer kind; the potential is a masked sum over
the families present in the deck.  The returned ``f`` is force over
distance: F_i = f * (r_i - r_j).

  1 lnjs  U = 4e[(s/r)^12 - (s/r)^6]        p0=4e, p1=s^2, p2=24e
  2 buck  U = A exp(-r/ro) - C/r^6           p0=A, p1=ro, p2=C
  3 p746  U = A/r^7 - B/r^4 - C/r^6          p0=A, p1=B, p2=C
  4 bmhs  U = A exp[B(s-r)] - C/r^6 - D/r^8  p0=A, p1=B, p2=s, p3=C, p4=D
  5 elin  U = A exp(-r/ro) + C r             p0=A, p1=ro, p2=C
  6 einv  U = A exp(-r/ro) - C/r             p0=A, p1=ro, p2=C
  7 surk  U = ri rj (C1 ri^2 rj^2 / r^7 - C2/(ki ri + kj rj) / r^6)
          p0=C1, p1=C2, p2=ki, p3=kj; ri/rj are per-atom thermal radii
"""

from __future__ import annotations

import torch

from ..io.field import (VDW_746, VDW_BHM, VDW_BUCK, VDW_EINV,
                        VDW_ELIN, VDW_LJ, VDW_SURK)


def _safe(ro, mask):
    """1/ro with the divisor masked (absent pairs carry ro=0)."""
    return 1.0 / torch.where(mask, ro, torch.ones_like(ro))


def vdw_eval(kind, p, r2, r, rad_i=None, rad_j=None, families=()):
    """Force-over-r and energy for a batch of pairs.

    kind: (...,) int family id per pair (0 = none); p: (..., 5) parameters;
    r2, r: squared / plain distance (> 0; mask upstream); rad_i, rad_j:
    thermal radii (Surkov only); families: static tuple of ids present.
    """
    f = torch.zeros_like(r2)
    e = torch.zeros_like(r2)
    p0, p1, p2, p3, p4 = (p[..., k] for k in range(5))
    r2i = 1.0 / r2
    ri = 1.0 / r
    for fam in families:
        m = kind == fam
        if fam == VDW_LJ:
            sr2 = p1 * r2i
            sr6 = sr2 * sr2 * sr2
            ee = p0 * sr6 * (sr6 - 1.0)
            ff = p2 * r2i * sr6 * (2.0 * sr6 - 1.0)
        elif fam == VDW_BUCK:
            r4i = r2i * r2i
            ex = torch.exp(-r * _safe(p1, m))
            ee = p0 * ex - p2 * r4i * r2i
            ff = p0 * ex * ri * _safe(p1, m) - 6.0 * p2 * r4i * r4i
        elif fam == VDW_746:
            r4i = r2i * r2i
            ee = r4i * (p0 * r2i * ri - p1 - p2 * r2i)
            ff = r4i * r2i * (7.0 * p0 * r2i * ri - 4.0 * p1
                              - 6.0 * p2 * r2i)
        elif fam == VDW_BHM:
            r4i = r2i * r2i
            ex = torch.exp(p1 * (p2 - r))
            ee = p0 * ex - p3 * r4i * r2i - p4 * r4i * r4i
            ff = (p0 * p1 * ex * ri - 6.0 * p3 * r4i * r4i
                  - 8.0 * p4 * r4i * r4i * r2i)
        elif fam == VDW_ELIN:
            ex = torch.exp(-r * _safe(p1, m))
            ee = p0 * ex + p2 * r
            ff = p0 * ex * ri * _safe(p1, m) - p2 * ri
        elif fam == VDW_EINV:
            ex = torch.exp(-r * _safe(p1, m))
            ee = p0 * ex - p2 * ri
            ff = p0 * ex * ri * _safe(p1, m) - p2 * ri * r2i
        elif fam == VDW_SURK:
            r6i = r2i * r2i * r2i
            den = p2 * rad_i + p3 * rad_j
            c2sum = p1 / torch.where(m, den, torch.ones_like(den))
            rprod = rad_i * rad_j
            c1ab2 = rprod * rprod * p0
            ee = rprod * r6i * (c1ab2 * ri - c2sum)
            ff = rprod * r6i * r2i * (7.0 * c1ab2 * ri - 6.0 * c2sum)
        else:
            continue
        f = torch.where(m, ff, f)
        e = torch.where(m, ee, e)
    return f, e
