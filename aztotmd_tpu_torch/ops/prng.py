"""Counter-based per-atom random bits (port of ``aztotmd_tpu/ops/prng.py``).

The radiative thermostat's noise is a pure function of (seed, step, atom
id), so the port draws the same words as the JAX package bit for bit.
torch has no full uint32 arithmetic, so a uint32 is held in an int64 in
[0, 2**32).  Products are formed from 16-bit halves so that no
intermediate leaves the int64 range, and every result is masked back to
32 bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
GOLD = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) and a 32-bit constant c."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _mix32(x):
    """murmur3 fmix32: bijective full-avalanche 32-bit mixer."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _word(v, device):
    """An int64 scalar tensor of ``v``: a Python int becomes a fill on
    ``device`` (no copy of host data, which a graph capture refuses)."""
    if torch.is_tensor(v):
        return v.to(torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


def counter_bits2(seed, step, gid):
    """Two decorrelated 32-bit words per element of ``gid``.

    seed, step: int64 scalars (tensors or ints); gid: (n,) integer tensor.
    Returns two int64 tensors with values in [0, 2**32).
    """
    seed = _word(seed, gid.device) & MASK32
    step = _word(step, gid.device) & MASK32
    s = _mix32(seed ^ _mul32(step, GOLD))
    h = _mix32((_mul32(gid.to(torch.int64) & MASK32, _C2) + s) & MASK32)
    w0 = _mix32(h ^ GOLD)
    w1 = _mix32((h + _C1) & MASK32)
    return w0, w1


def uniform4_16(seed, step, gid, dtype):
    """(n, 4) uniforms in [0, 1) with 16-bit resolution, keyed by
    (seed, step, gid)."""
    w0, w1 = counter_bits2(seed, step, gid)
    halves = [(w & 0xFFFF).to(dtype) for w in (w0, w1)] \
        + [(w >> 16).to(dtype) for w in (w0, w1)]
    return torch.stack(halves, dim=-1) * (1.0 / 65536.0)
