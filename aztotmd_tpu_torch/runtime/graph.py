"""CUDA-graph capture of the step: the port's counterpart of the JAX
package's jitted ``lax.scan`` over a chunk (``aztotmd_tpu/runtime/
step.py::make_multi_step``).

``StateGraphs`` owns a static copy of the state (an ``MDState`` or a
``SlabState``) and captures, over it and the caller's force field (which
no step writes), programs that advance the static state in place: each
program is ``out = fn(static, ff)`` followed, inside the same capture, by
a copy of every field of ``out`` (nested ``Energies`` included) back into
``static`` (``copy_into``).  One replay of the step program is one step.
The neighbor engine adds its full rebuild and inner refine as programs of
their own over the same static state, in one memory pool; Python replays
them on the R/Q schedule.

Around every capture:

- **warm-up** on a clone of the state, on the capture's side stream, so
  that lazy work (kernel builds, the device constants of ``ops/consts.py``)
  happens outside the capture and the trajectory does not advance;
- **aliases**: an output field can be the very tensor of another input
  field (``nbr_ref=pos`` in a rebuild); every output that shares storage
  with the static state is staged through a clone before any copy;
- **launch counters** (the kernel wrappers' ``launches`` counts,
  ``runtime.step.nbr_counts`` and ``ops.rdf.rdf_counts``) count Python
  calls, which happen at capture
  only: the warm-up's and the capture's counts are taken back, and every
  replay adds the capture's; ``launch_counts`` counts each program's
  launches by ``"graph:<name>"``, and while a torch.profiler records each
  replay call is a range of that name;
- **failures raise** ``GraphCaptureError`` naming the program, the stage
  and the op's source line; nothing falls back to eager.

``GraphedSample`` captures a sample ``fn(state, hist, nhist) -> (hist,
nhist)`` (the RDF) into the caller's histogram buffers, recaptured when
any input tensor changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import traceback

import torch

from ..utils.profiling import profiler_range, profiling

# warm-up calls before a capture
WARMUP = 2

# captures made since the counts were last set to 0: of state programs
# (``StateGraphs``, one per load that had to capture) and of samples
# (``GraphedSample``), read by checks
capture_counts = {"state": 0, "sample": 0}

# graph launches of each program since the process started, by
# "graph:<program name>": ``Program.replay(n)`` adds n, one add a call
launch_counts = {}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GraphCaptureError(RuntimeError):
    """A program could not be captured; the message names the program, the
    stage (warm-up or capture) and the op."""


# ----------------------------------------------------------------------
# state trees

def state_leaves(tree, prefix: str = ""):
    """[(name, tensor)] of every tensor field of a state dataclass, nested
    dataclasses included as ``outer.inner``; None fields are skipped."""
    out = []
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out += state_leaves(v, prefix + f.name + ".")
        elif torch.is_tensor(v):
            out.append((prefix + f.name, v))
    return out


def map_leaves(tree, fn, prefix: str = ""):
    """A copy of a state dataclass with every tensor field ``t`` replaced
    by ``fn(name, t)``, named as ``state_leaves`` names them; other fields
    as they are."""
    kw = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = map_leaves(v, fn, prefix + f.name + ".")
        elif torch.is_tensor(v):
            kw[f.name] = fn(prefix + f.name, v)
    return dataclasses.replace(tree, **kw)


def clone_state(tree):
    """A copy of a state dataclass with every tensor cloned (fields that
    shared a tensor no longer do)."""
    return map_leaves(tree, lambda _, t: t.clone())


def same_layout(a, b) -> bool:
    """Whether two state trees have the same fields, shapes and dtypes."""
    la, lb = state_leaves(a), state_leaves(b)
    return [(n, t.shape, t.dtype) for n, t in la] == \
        [(n, t.shape, t.dtype) for n, t in lb]


def copy_into(dst, src):
    """Copy every tensor field of ``src`` into the same field of ``dst``,
    in place.  A source that shares storage with any field of ``dst``
    (and is not that very field) is cloned before the first copy, so the
    order of the copies cannot matter.  Raises for a field missing on
    either side or of another shape or dtype."""
    d = dict(state_leaves(dst))
    s = state_leaves(src)
    if sorted(d) != sorted(n for n, _ in s):
        raise ValueError("state fields differ: "
                         f"{sorted(set(d) ^ {n for n, _ in s})}")
    held = {t.untyped_storage().data_ptr() for t in d.values()}
    staged = []
    for name, t in s:
        dt = d[name]
        if t.shape != dt.shape or t.dtype != dt.dtype:
            raise ValueError(f"field {name}: {tuple(t.shape)} {t.dtype} "
                             f"into {tuple(dt.shape)} {dt.dtype}")
        if t.data_ptr() == dt.data_ptr() and t.stride() == dt.stride():
            continue                          # the field itself
        if t.untyped_storage().data_ptr() in held:
            t = t.clone()
        staged.append((dt, t))
    for dt, t in staged:
        dt.copy_(t)


def advance_in_place(fn, static, ff):
    """The body a state program captures: ``fn(static, ff)`` copied back
    into ``static``."""
    copy_into(static, fn(static, ff))


# ----------------------------------------------------------------------
# launch counters

def launch_counters():
    """[(holder, key)] of every launch counter: a module attribute of a
    kernel wrapper or a key of ``runtime.step.nbr_counts`` or of
    ``ops.rdf.rdf_counts``."""
    from ..ops import allpairs, cellblock, rdf, sparse, thermostat
    from . import step
    return ([(allpairs, "launches"), (allpairs, "cand_launches"),
             (allpairs, "rect_launches"), (sparse, "launches"),
             (sparse, "cand_launches"), (cellblock, "launches"),
             (rdf, "launches"), (thermostat, "launches")]
            + [(step.nbr_counts, k) for k in step.nbr_counts]
            + [(rdf.rdf_counts, k) for k in rdf.rdf_counts])


def _read(counters):
    return [h[k] if isinstance(h, dict) else getattr(h, k)
            for h, k in counters]


def _write(counters, vals):
    for (h, k), v in zip(counters, vals):
        if isinstance(h, dict):
            h[k] = v
        else:
            setattr(h, k, v)


def _where(exc) -> str:
    """The innermost frame of the port that the exception passed through:
    the op's source line."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.startswith(_PKG)
              and not f.filename.endswith(os.path.join("runtime",
                                                       "graph.py"))]
    if not frames:
        return "outside the port"
    f = frames[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(_PKG))}:"
            f"{f.lineno} in {f.name}: {f.line}")


# ----------------------------------------------------------------------
def _new_graph():
    """(CUDAGraph, whether it keeps its cudaGraph_t for ``_node_count``)."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


def _node_count(g):
    """The nodes of a captured graph (kernels, copies, fills), from the
    driver's ``cuGraphGetNodes``; None where the driver library cannot be
    read."""
    import ctypes
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                             ctypes.byref(n))
    return n.value if rc == 0 else None


class Program:
    """One captured CUDA graph of ``body()``, which reads and writes only
    tensors that outlive the capture.  ``replay(n)`` runs it n times on the
    current stream, adds n times its launch counts and n to
    ``launch_counts["graph:<name>"]``.  ``nodes`` is the
    graph's node count (None where it cannot be read), ``capture_seconds``
    the warm-up and capture's wall time."""

    def __init__(self, name, body, warm, device, pool=None, stream=None):
        self.name = name
        device = torch.device(device)
        stream = stream or torch.cuda.Stream(device)
        counters = launch_counters()
        before = _read(counters)
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(device))
        stage = "warm-up"
        try:
            with torch.cuda.stream(stream):
                for _ in range(WARMUP):
                    warm()
            torch.cuda.current_stream(device).wait_stream(stream)
            stage = "capture"
            self.graph, keep = _new_graph()
            at = _read(counters)
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                body()
            self.nodes = _node_count(self.graph) if keep else None
            if keep:
                self.graph.instantiate()
        except Exception as e:
            _write(counters, before)
            raise GraphCaptureError(
                f"CUDA-graph {stage} of the {name} program failed at "
                f"{_where(e)}: {type(e).__name__}: {e}") from e
        self.per_replay = [b - a for a, b in zip(at, _read(counters))]
        _write(counters, before)
        self._counters = counters
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0

    def replay(self, n: int = 1):
        key = "graph:" + self.name
        with profiler_range(key) if profiling() else contextlib.nullcontext():
            for _ in range(n):
                self.graph.replay()
        launch_counts[key] = launch_counts.get(key, 0) + n
        if any(self.per_replay):
            _write(self._counters,
                   [v + n * d for v, d in zip(_read(self._counters),
                                              self.per_replay)])


class StateGraphs:
    """Programs ``fn(state, ff) -> state`` captured over one static state
    and the caller's force field (no step writes to it), in one memory
    pool.  ``load`` puts a state into the static buffers (or recaptures
    when its layout differs, or when another force field is passed);
    ``run(name, n)`` replays a program n times; ``state`` is the static
    state."""

    def __init__(self, fns: dict):
        self.fns = dict(fns)
        self.state = None
        self.ff = None
        self.programs = {}

    def load(self, state, ff):
        """Make the static state hold ``state``, captured over ``ff``; a
        no-op for the static state itself."""
        if state is self.state and ff is self.ff:
            return
        if ff is self.ff and same_layout(self.state, state):
            copy_into(self.state, state)
        else:
            self._capture(state, ff)

    def _capture(self, state, ff):
        self.programs = {}
        self.state = clone_state(state)
        self.ff = ff
        dev = self.state.pos.device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        scratch = clone_state(self.state)
        for name, fn in self.fns.items():
            self.programs[name] = Program(
                name,
                lambda fn=fn: advance_in_place(fn, self.state, ff),
                lambda fn=fn: fn(scratch, ff), dev, pool=self.pool,
                stream=self.stream)
        capture_counts["state"] += 1

    def run(self, name: str, n: int = 1):
        if n > 0:
            self.programs[name].replay(n)


class GraphedSample:
    """``fn(state, hist, nhist) -> (hist, nhist)`` captured into the
    caller's histogram buffers: on the card each call replays the graph,
    which adds the sample into ``hist`` (and ``nhist``) in place and
    returns them; recaptured when any input tensor changes.  On the CPU,
    or with ``graph=False``, it calls ``fn``."""

    def __init__(self, fn, name: str = "sample", graph: bool | None = None):
        self.fn = fn
        self.name = name
        self.graph = graph
        self.program = None
        self._key = None

    def __call__(self, state, hist, nhist):
        if not use_graph(self.graph, state.pos.device):
            return self.fn(state, hist, nhist)
        bufs = [hist] + ([nhist] if nhist is not None else [])
        key = tuple(t.data_ptr() for _, t in state_leaves(state)) + tuple(
            t.data_ptr() for t in bufs)
        if key != self._key:
            def body():
                out = self.fn(state, hist, nhist)
                for b, o in zip(bufs, out):
                    b.copy_(o)
            self.program = Program(self.name, body,
                                   lambda: self.fn(state, hist, nhist),
                                   state.pos.device)
            self._key = key
            capture_counts["sample"] += 1
        self.program.replay()
        return hist, nhist


def use_graph(graph: bool | None, device) -> bool:
    """Capture on a CUDA device unless ``graph`` is False; ``graph=True``
    with a CPU state raises."""
    cuda = torch.device(device).type == "cuda"
    if graph and not cuda:
        raise ValueError("graph=True needs the state on a CUDA device")
    return cuda if graph is None else bool(graph)
