"""Atom-sharded execution of the MD step (port of
``aztotmd_tpu/parallel/mesh.py``, keeping its names).

Per-atom state fields are split into D equal row shards along the atom
axis; force-field tables, bond and angle tables, scalars and counters are
replicated.  A field is per-atom by the JAX package's rule
(``_is_per_atom``): a tensor with at least one axis whose first axis is
``n_at``.  A rank holds its shards of a per-atom field as one (L, N/D,
...) tensor, L being its communicator's local shards (``LocalRing``: all
D in one process, L = D; ``DistRing``: one a rank, L = 1).

The step is the one-device step (``runtime/step.py::make_step``),
unchanged.  Each call all-gathers the per-atom fields
(``comm.gather_rows``: a reshape over ``LocalRing``, an all-gather over
``DistRing``), runs the step on the gathered arrays and keeps each rank's
rows.  In the JAX package XLA propagates the shardings through the
program instead and inserts the collectives; it cannot partition a Pallas
custom call either, so there too the pair pass runs on gathered operands
and every kernel of a deck's path runs as on one device.  Over a
``LocalRing`` on one card the atom-sharded step is the one-device step in
another layout: the same kernels in the same order, the same results, no
speed gained.  Over a ``DistRing`` every rank computes the whole step.
"""

from __future__ import annotations

import torch

from ..runtime.graph import map_leaves, state_leaves
from ..runtime.step import MultiStep, make_multi_step, make_step
from .comm import LocalRing, make_comm

AXIS = "atoms"


def make_mesh(n_devices: int, device=None, dist: bool = False):
    """The communicator of an atom-sharded run (the JAX package's
    ``Mesh``): a ``LocalRing`` of ``n_devices`` shards on ``device``, or
    with ``dist`` the ``DistRing`` of the initialised process group."""
    return make_comm(n_devices, device, dist=dist)


def _is_per_atom(name: str, arr, n_at: int) -> bool:
    return torch.is_tensor(arr) and arr.ndim >= 1 and arr.shape[0] == n_at


def state_shardings(mesh, state, n_at: int) -> dict:
    """The sharding of each field of a single-device state, keyed as
    ``runtime.graph.state_leaves`` names them (``energies.kin``): the
    partition spec ``(AXIS, None, ...)`` of a per-atom field, ``()`` (one
    copy on every rank) of the rest."""
    return {name: ((AXIS,) + (None,) * (t.ndim - 1)
                   if _is_per_atom(name, t, n_at) else ())
            for name, t in state_leaves(state)}


def ff_shardings(mesh, ff) -> dict:
    """Every force-field table replicated."""
    return {name: () for name, _ in state_leaves(ff)}


def _sharded(spec) -> frozenset:
    return frozenset(name for name, s in spec.items() if s)


def shard_state(mesh, state, spec):
    """This rank's row shards, (L, N/D, ...), of the per-atom fields of a
    single-device state (views, no copy); the other fields as they are."""
    names, D = _sharded(spec), mesh.n_dev
    return map_leaves(state, lambda k, t: mesh.local_slabs(
        t.reshape((D, -1) + tuple(t.shape[1:]))) if k in names else t)


def gather_state(mesh, sstate, spec):
    """The single-device state of an atom-sharded one: every rank's rows
    of the per-atom fields (every rank takes part under ``DistRing``)."""
    names = _sharded(spec)
    return map_leaves(sstate, lambda k, t: mesh.gather_rows(t)
                      if k in names else t)


def shard_system(mesh, state, ff, n_at: int):
    """Place a single-device system on the mesh: (sharded state, ff,
    state shardings, ff shardings)."""
    st_sh = state_shardings(mesh, state, n_at)
    ff_sh = ff_shardings(mesh, ff)
    return shard_state(mesh, state, st_sh), ff, st_sh, ff_sh


def sharded(fn, mesh, spec):
    """``fn(state, ff) -> state`` of the one-device step over the row
    shards of ``spec``: gather the rows, run ``fn``, keep this rank's."""
    def run(sstate, ff):
        return shard_state(mesh, fn(gather_state(mesh, sstate, spec), ff),
                           spec)
    return run


def _check_divisible(n_at: int, n_dev: int):
    if n_at % n_dev:
        raise ValueError(
            f"n_at={n_at} not divisible by mesh size {n_dev}; pad the "
            "system (frozen ghost atoms) to a multiple of the mesh")


def make_sharded_step(cfg, aux, mesh, state, ff):
    """The full MD step over the mesh's atom shards.  Requires
    ``cfg.n_at`` divisible by the mesh size so that the shards are equal.
    Returns (step_fn, sharded_state, ff)."""
    _check_divisible(cfg.n_at, mesh.n_dev)
    state, ff, st_sh, _ = shard_system(mesh, state, ff, cfg.n_at)
    return sharded(make_step(cfg, aux), mesh, st_sh), state, ff


def make_sharded_multi_step(cfg, aux, mesh, spec,
                            graph: bool | None = None) -> MultiStep:
    """multi(sstate, ff, n) -> the atom-sharded state after n steps: the
    programs of ``runtime.step.make_multi_step`` (the step; on the
    neighbor engine the list rebuild and refine, on its schedule), each
    over the row shards of ``spec``.  Over a ``LocalRing`` ``graph`` is as
    there: on the card each program is a replay of a captured CUDA graph.
    ``DistRing`` (collectives across processes) runs eagerly:
    ``graph=None`` takes the eager path there and ``graph=True``
    raises."""
    _check_divisible(cfg.n_at, mesh.n_dev)
    if not isinstance(mesh, LocalRing):
        if graph:
            raise NotImplementedError(
                "a CUDA graph of the atom-sharded step over DistRing "
                "(collectives across processes) is not ported (ROADMAP.md, "
                "queue 1)")
        graph = False
    one = make_multi_step(cfg, aux, graph=False)
    return MultiStep({k: sharded(fn, mesh, spec) for k, fn in one.fns.items()},
                     graph, one.R, one.Q)
