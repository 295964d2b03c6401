"""Timings the per-layer readers share, taken on the window's final state
after the window: a bare replayed chunk of steps, and CUDA-event timings
of a captured graph or a replayed sample."""

from __future__ import annotations

import statistics
import time

import torch


def bare_step_ms(ctx):
    """ms a step of ``make_multi_step(graph=True)`` on a copy of the
    window's final state: one chunk of a ring window's steps to
    capture, then one chunk's wall time over all its steps (not the best
    of several)."""
    if "bare_step_ms" in ctx.memo:
        return ctx.memo["bare_step_ms"]
    from aztotmd_tpu_torch.runtime.step import make_multi_step
    r = ctx.runner
    n = ctx.unit
    multi = make_multi_step(r.cfg, r.aux, graph=True)
    state = multi(ctx.state, r.ff, n)
    torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    multi(state, r.ff, n)
    torch.cuda.synchronize(ctx.device)
    ms = (time.perf_counter() - t0) * 1e3 / n
    ctx.memo["bare_step_ms"] = ms
    del multi, state
    return ms


def event_ms(fn, reps: int = 20):
    """Median ms of ``fn()`` by CUDA events over ``reps`` calls."""
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


def graph_call_ms(fn, device, calls: int = 20, replays: int = 5):
    """ms a call of ``fn()`` replayed from one CUDA graph of ``calls``
    calls, by CUDA events over ``replays`` replays (after two eager
    warm-up calls on the capture's stream)."""
    s = torch.cuda.Stream(device)
    s.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (calls * replays)
