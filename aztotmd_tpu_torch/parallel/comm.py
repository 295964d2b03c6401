"""The slab communicator: the collectives of the slab-decomposed step.

In the JAX package the slab step runs inside ``shard_map`` and talks over
the mesh axis with ``ppermute``, ``psum``, ``pmax`` and ``axis_index``
(``aztotmd_tpu/parallel/slab.py``).  Here the step is written once, over
tensors whose first axis is the *local slab axis* L, and calls a
communicator:

- ``shift_from_left(x)``: slab s receives slab s-1's ``x`` (a ppermute
  that sends every slab's tensor to its right neighbour), periodically;
- ``shift_from_right(x)``: slab s receives slab s+1's ``x``;
- ``psum(x)`` / ``pmax(x)``: the sum / max over every slab of ``x``, whose
  first axis is the local slab axis; the result has no slab axis and is
  the same on every rank;
- ``allsum(x)``: the sum over ranks of a partial already summed over the
  local slabs (a psum of per-slab partials computed on flattened slots);
- ``slab_index()``: the (L,) int64 indices of the local slabs;
- ``local_slabs(a)``: the local rows of a host-built (D, ...) array;
- ``gather_slabs(x)``: every slab's rows, (D, ...), on every rank;
- ``gather_rows(x)``: the (L, n, ...) row shards of every rank as one
  (D * n, ...) tensor on every rank (the all-gather of the atom-sharded
  mode, ``parallel/mesh.py``).

Two backends share the one code path:

- ``LocalRing``: all D slabs in one process on one device, L = D.  The
  shifts are ``torch.roll`` along the slab axis, ``psum`` a sum over it:
  each small op of the step runs once for all slabs; ``gather_rows`` is a
  reshape (no copy).  The tests, ``--cpu`` and a one-card run use it.
- ``DistRing``: one slab per rank, L = 1, over ``torch.distributed`` (gloo
  for CPU tensors, NCCL for CUDA tensors): the shifts are paired
  ``isend``/``irecv`` with the neighbour ranks, ``psum``/``pmax`` an
  ``all_reduce``, ``gather_rows`` an all-gather into one tensor.

Two slabs make the degenerate ring, left neighbour == right neighbour;
the step keeps the JAX package's rules for it (one halo copy in the dense
pass, no left migration buffer) on both backends.
"""

from __future__ import annotations

import datetime
import os

import torch


class LocalRing:
    """All ``n_dev`` slabs in this process, batched on the slab axis."""

    def __init__(self, n_dev: int, device=None):
        self.n_dev = int(n_dev)
        self.n_local = self.n_dev
        self.rank = 0
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")

    def slab_index(self):
        return torch.arange(self.n_dev, device=self.device)

    def shift_from_left(self, x):
        return torch.roll(x, 1, 0)

    def shift_from_right(self, x):
        return torch.roll(x, -1, 0)

    def psum(self, x):
        return x.sum(0, dtype=x.dtype)

    def pmax(self, x):
        return x.amax(0)

    def allsum(self, x):
        return x

    def local_slabs(self, a):
        return a

    def gather_slabs(self, x):
        return x

    def gather_rows(self, x):
        return x.reshape((-1,) + tuple(x.shape[2:]))


class DistRing:
    """One slab per rank of the default ``torch.distributed`` group."""

    def __init__(self, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistRing needs torch.distributed to be "
                               "initialised (see init_dist)")
        self._dist = dist
        self.rank = dist.get_rank()
        self.n_dev = dist.get_world_size()
        self.n_local = 1
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.left = (self.rank - 1) % self.n_dev
        self.right = (self.rank + 1) % self.n_dev

    def slab_index(self):
        return torch.tensor([self.rank], device=self.device)

    def _exchange(self, x, send_to, recv_from):
        """Send ``x`` to rank ``send_to`` and return what ``recv_from``
        sent (bool travels as uint8)."""
        dist = self._dist
        flag = x.dtype == torch.bool
        src = (x.to(torch.uint8) if flag else x).contiguous()
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, send_to),
               dist.P2POp(dist.irecv, out, recv_from)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(torch.bool) if flag else out

    def shift_from_left(self, x):
        return self._exchange(x, self.right, self.left)

    def shift_from_right(self, x):
        return self._exchange(x, self.left, self.right)

    def _reduce(self, y, op):
        self._dist.all_reduce(y, op=op)
        return y

    def psum(self, x):
        return self._reduce(x.sum(0, dtype=x.dtype).contiguous(),
                            self._dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x.amax(0).contiguous(), self._dist.ReduceOp.MAX)

    def allsum(self, x):
        return self._reduce(x.clone().contiguous(), self._dist.ReduceOp.SUM)

    def local_slabs(self, a):
        return a[self.rank:self.rank + 1]

    def gather_slabs(self, x):
        parts = [torch.empty_like(x) for _ in range(self.n_dev)]
        self._dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, 0)

    def gather_rows(self, x):
        dist = self._dist
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        flag = x.dtype == torch.bool
        src = (x.to(torch.uint8) if flag else x).reshape(
            (-1,) + tuple(x.shape[2:])).contiguous()
        out = src.new_empty((self.n_dev * src.shape[0],)
                            + tuple(src.shape[1:]))
        gather(out, src)
        return out.to(torch.bool) if flag else out


def make_comm(n_dev: int, device=None, dist: bool = False):
    """The communicator of a slab run (the ``make_mesh`` of the JAX
    package): ``DistRing`` over the initialised process group when
    ``dist``, else a ``LocalRing`` of ``n_dev`` slabs on ``device``."""
    if dist:
        comm = DistRing(device)
        if n_dev and n_dev != comm.n_dev:
            raise ValueError(f"--mesh {n_dev} with a world of {comm.n_dev} "
                             "ranks (one slab per rank)")
        return comm
    return LocalRing(n_dev, device)


def init_dist(device_type: str = "cpu", init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              timeout_s: float = 120.0):
    """Initialise the default process group: NCCL for a CUDA run, gloo
    for the CPU.  Under ``torchrun`` the rank, world size and address come
    from its environment (``env://``); otherwise pass them, with an
    ``init_method`` such as ``tcp://localhost:<port>`` or ``file://``.
    Returns the local rank (the CUDA device index of a NCCL run)."""
    import torch.distributed as dist
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return local
