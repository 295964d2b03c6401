"""``jax.random.split`` and ``jax.random.uniform`` on raw threefry key data.

The JAX package's electron-jump Metropolis test draws its uniforms with
``rng, k = jax.random.split(state.rng)`` and
``jax.random.uniform(k, (N,), dtype)`` on the legacy ``uint32[2]`` key
that the state carries (``aztotmd_tpu/ops/ejump.py``).  This module
computes the same words without JAX, so both packages accept the same
jumps and carry the same key.

It reproduces JAX 0.9's default threefry2x32 PRNG with
``jax_threefry_partitionable = True`` (the default since JAX 0.5):

* threefry2x32 is Random123's Threefry-2x32 with 20 rounds (five groups
  of four, rotations 13 15 26 6 / 17 29 16 24, key schedule with
  0x1BD11BDA), as ``jax/_src/prng.py::_threefry2x32_lowering``;
* ``split(key, n)`` hashes the 64-bit counters 0..n-1 given as
  (hi, lo) word pairs and new key i is (hash_hi[i], hash_lo[i])
  (``_threefry_split_foldlike``);
* 32-bit draws are ``hash_hi ^ hash_lo`` of the counters 0..n-1 and
  64-bit draws ``hash_hi << 32 | hash_lo``
  (``_threefry_random_bits_partitionable``);
* ``uniform`` keeps the top mantissa bits (23 in f32, 52 in f64), sets
  the exponent of 1.0 and subtracts 1 (``jax/_src/random.py::_uniform``).

Words are uint32 values held in int64 tensors, as ``ops/prng.py`` holds
them; every sum is masked back to 32 bits.
"""

from __future__ import annotations

import torch

from .prng import MASK32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under key (k1, k2).

    All four are int64 tensors (or ints) with values in [0, 2**32);
    returns the two hashed words, broadcast to the counters' shape."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def _key_words(key):
    key = torch.as_tensor(key, dtype=torch.int64) & MASK32
    return key[0], key[1]


def _counter_hash(key, n: int):
    """The hashed (hi, lo) words of the 64-bit counters 0..n-1."""
    k1, k2 = _key_words(key)
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` on raw key data: (num, 2) int64."""
    hi, lo = _counter_hash(key, num)
    return torch.stack([hi, lo], dim=1)


def uniform(key, n: int, dtype):
    """``jax.random.uniform(key, (n,), dtype)`` in [0, 1), f32 or f64."""
    hi, lo = _counter_hash(key, n)
    if dtype == torch.float64:
        mant = (hi << 20) | (lo >> 12)                 # top 52 of 64 bits
        one = 0x3FF0000000000000
        return (mant | one).view(torch.float64) - 1.0
    if dtype == torch.float32:
        mant = (hi ^ lo) >> 9                          # top 23 of 32 bits
        return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    raise TypeError(f"uniform: f32 or f64 only, got {dtype}")
