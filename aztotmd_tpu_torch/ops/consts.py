"""Device constants built once from host values.

``torch.tensor(values, device="cuda")`` copies from pageable host memory
and waits for the copy, which a CUDA-graph capture refuses.  The step's
constants that come from the configuration (the box and its reciprocals,
cell scales and dims, stencil offsets, kind tables) come from here
instead: built by their first use, which is the warm-up call before a
capture (``runtime/graph.py``), and only read afterwards.  The values are
``torch.tensor``'s own, bit for bit.
"""

from __future__ import annotations

import torch

_CACHE: dict = {}


def _frozen(v):
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(x) for x in v)
    return v


def const(values, dtype, device=None) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, built once per
    (values, dtype, device).  The tensor is shared: never write to it."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    key = (_frozen(values), dtype, dev)
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.tensor(values, dtype=dtype, device=dev)
    return t
