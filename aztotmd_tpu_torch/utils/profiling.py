"""Profiling and tracing (port of ``aztotmd_tpu/utils/profiling.py``).

``StageTimer`` is the runner's recorder: host seconds and calls per named
span, which never waits on the card, and one record per ``MDRunner.run``
call (``run --timings`` prints the last).  While a ``torch.profiler``
records, each span is also a range of the same name in its trace, so the
trace places it on the clock of the device's events.

``trace(log_dir)`` records a ``torch.profiler`` trace of the host and the
card and writes it as a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) into ``log_dir``; then it prints the card's
idle seconds between device events by the span or ``graph:`` range the
host was in when each gap began (``idle_by_span``).
"""

from __future__ import annotations

import bisect
import contextlib
import os
import sys
import time

import torch

# the records a StageTimer keeps, the newest last
KEEP_CALLS = 8


def profiling() -> bool:
    """Whether a torch.profiler is recording."""
    return torch.autograd.profiler._is_profiler_enabled


def profiler_range(name: str):
    """A range named ``name`` in the recording profiler's trace, on the
    host's timeline only: a function-scope record.  ``record_function``
    makes a user annotation, which the profiler also draws over the
    kernels launched inside it as a device event, so that any reduction
    of the trace's device events would count the range as busy."""
    return torch._C._profiler._RecordFunctionFast(name)


class StageTimer:
    """Host seconds and calls of named spans.  A span reads
    ``time.perf_counter()`` at its start and end and never waits on the
    card; while a profiler records it is also a ``profiler_range``.
    ``begin``/``end`` bracket one call of the caller and append its record
    to ``calls`` (the last ``KEEP_CALLS``): ``{"steps", "wall_s",
    "spans": {name: [seconds, count]}, "counters": {name: n},
    "pair_pass"}``, the counters as deltas over the call and
    ``pair_pass`` the caller's words for the pair pass its steps ran."""

    def __init__(self):
        self.spans = {}
        self.calls = []
        self._counters = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        with profiler_range(name) if profiling() else contextlib.nullcontext():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                span = self.spans.setdefault(name, [0.0, 0])
                span[0] += time.perf_counter() - t0
                span[1] += 1

    def begin(self, counters: dict):
        """Open a call's record at the caller's ``counters`` now."""
        self.spans = {}
        self._counters = dict(counters)

    def end(self, steps: int, wall_s: float, counters: dict,
            pair_pass: str | None = None):
        """Close the open record with the call's steps, its wall seconds,
        the caller's ``counters`` now and its ``pair_pass``, and append
        it."""
        rec = {"steps": int(steps), "wall_s": float(wall_s),
               "spans": self.spans,
               "counters": {k: v - self._counters.get(k, 0)
                            for k, v in counters.items()},
               "pair_pass": pair_pass}
        self.spans = {}
        self.calls.append(rec)
        del self.calls[:-KEEP_CALLS]

    def report(self) -> str:
        """The last record: each span's host seconds, calls and ms a call,
        then ``other`` (the wall less the spans), then the counters and
        the pair pass."""
        rec = self.calls[-1]
        lines = ["stage                    total_s   calls   ms/call"]
        spans = rec["spans"]
        for k in sorted(spans, key=lambda k: -spans[k][0]):
            t, c = spans[k]
            lines.append(f"{k:<24} {t:8.3f} {c:7d} {1000 * t / c:9.2f}")
        other = rec["wall_s"] - sum(t for t, _ in spans.values())
        lines.append(f"{'other':<24} {other:8.3f}")
        for k, v in sorted(rec["counters"].items()):
            lines.append(f"{k:<24} {v:8d}")
        if rec["pair_pass"]:
            lines.append(f"{'pair_pass':<24} {rec['pair_pass']}")
        return "\n".join(lines)


# ----------------------------------------------------------------------
# the trace

# the runner's spans (``MDRunner._staged``)
SPANS = ("steps", "wait", "sampling")


def is_span(name: str) -> bool:
    """Whether a host range is one of the runner's spans or a graph's."""
    return name in SPANS or name.startswith("graph:")


def idle_by_span(events):
    """{label: [idle seconds, gaps]} of the card's idle gaps between
    device events, each labelled by the innermost span or ``graph:`` range
    (``is_span``) the host was in when it began, ``other`` outside every
    one.  ``events``: [(on_device, name, start_us, end_us)]."""
    dev = sorted((a, b) for d, _, a, b in events if d and b > a)
    spans = sorted((a, b, n) for d, n, a, b in events
                   if not d and b > a and is_span(n))
    starts = [s[0] for s in spans]
    out = {}
    if not dev:
        return out
    hi = dev[0][1]
    for a, b in dev[1:]:
        if a > hi:
            # the innermost: the latest start at or before the gap among
            # the spans still running then
            k = bisect.bisect_right(starts, hi)
            label = next((n for s, e, n in reversed(spans[:k]) if e > hi),
                         "other")
            t, c = out.get(label, (0.0, 0))
            out[label] = [t + (a - hi) * 1e-6, c + 1]
        hi = max(hi, b)
    return out


def _events(prof):
    """[(on_device, name, start_us, end_us)] of a finished profile."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        out.append((e.device_type() == DeviceType.CUDA, e.name(), a,
                    a + e.duration_ns() / 1e3))
    return out


def idle_report(idle) -> str:
    lines = ["idle by span             idle_s    gaps"]
    for k in sorted(idle, key=lambda k: -idle[k][0]):
        t, c = idle[k]
        lines.append(f"{k:<24} {t:8.4f} {c:7d}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace context -> ``log_dir/trace.json``, then the
    card's idle seconds by span on stderr."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    print(idle_report(idle_by_span(_events(prof))), file=sys.stderr)
