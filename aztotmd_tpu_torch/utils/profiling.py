"""Profiling and tracing (port of ``aztotmd_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the host and the
card and writes it as a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) into ``log_dir``; ``StageTimer`` is the
per-stage wall-clock timer behind ``run --timings`` and ``--profile``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace context -> ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _wait(t):
    """Wait until the card has run everything queued on ``t``'s stream."""
    if torch.is_tensor(t) and t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name; waits on the
    CUDA stream of the given tensor before reading the clock, so device
    work is included."""

    def __init__(self):
        self.total = {}
        self.count = {}
        self._stack = []

    def start(self, stage: str):
        self._stack.append((stage, time.perf_counter()))

    def stop(self, wait_on=None):
        if wait_on is not None:
            _wait(wait_on)
        stage, t0 = self._stack.pop()
        dt = time.perf_counter() - t0
        self.total[stage] = self.total.get(stage, 0.0) + dt
        self.count[stage] = self.count.get(stage, 0) + 1
        return dt

    @contextlib.contextmanager
    def stage(self, name: str, wait_on_fn=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(wait_on_fn() if wait_on_fn else None)

    def report(self) -> str:
        lines = ["stage                    total_s   calls   ms/call"]
        for k in sorted(self.total, key=lambda k: -self.total[k]):
            t, c = self.total[k], self.count[k]
            lines.append(f"{k:<24} {t:8.3f} {c:7d} {1000 * t / c:9.2f}")
        return "\n".join(lines)
