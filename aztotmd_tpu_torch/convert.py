"""Convert the JAX package's ``ForceField`` / ``MDState`` leaves to the
port's tensors and back.

The input is a mapping of field name to array, or any object with those
attributes (for example the JAX dataclasses themselves: every leaf goes
through ``np.asarray``).  ``MDState.energies`` is a nested mapping or
object.  The RNG words are uint32 in the JAX package and int64 here.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import fields

import numpy as np
import torch

from .core.ffield import ForceField
from .core.state import Energies, MDState


def _get(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy()).to(device)


def _array(t, name):
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if name == "rng" else a


def forcefield_from_numpy(src, device=None) -> ForceField:
    return ForceField(**{f.name: _tensor(_get(src, f.name), device)
                         for f in fields(ForceField)})


def forcefield_to_numpy(ff: ForceField) -> dict:
    return {f.name: _array(getattr(ff, f.name), f.name)
            for f in fields(ForceField)}


def state_from_numpy(src, device=None) -> MDState:
    e_src = _get(src, "energies")
    energies = Energies(**{f.name: _tensor(_get(e_src, f.name), device)
                           for f in fields(Energies)})
    return MDState(energies=energies,
                   **{f.name: _tensor(_get(src, f.name), device)
                      for f in fields(MDState) if f.name != "energies"})


def state_to_numpy(state: MDState) -> dict:
    out = {f.name: _array(getattr(state, f.name), f.name)
           for f in fields(MDState) if f.name != "energies"}
    out["energies"] = {f.name: _array(getattr(state.energies, f.name),
                                      f.name)
                       for f in fields(Energies)}
    return out


def _grid(g):
    from .core.config import CellGrid
    if g is None:
        return None
    return CellGrid(dims=tuple(g.dims), cap=int(g.cap),
                    stencil=tuple(tuple(o) for o in g.stencil),
                    edge=tuple(g.edge))


def config_from(src):
    """The port's ``SimConfig`` of any object with its fields (the JAX
    package's ``SimConfig`` has the same ones); the cell grids become the
    port's ``CellGrid``."""
    from .core.config import SimConfig
    kw = {f.name: getattr(src, f.name) for f in fields(SimConfig)}
    kw["grid"] = _grid(kw["grid"])
    kw["nb_grid"] = _grid(kw["nb_grid"])
    return SimConfig(**kw)
