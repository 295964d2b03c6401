"""Reduction of a ``torch.profiler`` trace to the numbers a traced run reports:
the device's busy seconds (the union of its kernel, copy and fill
intervals), the traced window's wall seconds, the device operations that
took most time, and the longest idle gaps labelled by what the host was
doing when each began (the innermost host event then running), and the
device's idle seconds while the host was in the profiler's own buffer
requests."""

from __future__ import annotations

import bisect
import time

# the host event of the profiler's own activity-buffer requests
PROFILER_EVENT = "Activity Buffer Request"


def _raw_events(prof):
    """[(on_device, name, start_us, end_us)] of every recorded event."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        from torch.autograd import DeviceType
        for e in evs:
            dev = e.device_type() == DeviceType.CUDA
            a = e.start_ns() / 1e3
            out.append((dev, e.name(), a, a + e.duration_ns() / 1e3))
        return out
    except AttributeError:
        pass
    from torch.autograd import DeviceType
    for e in prof.events():
        out.append((e.device_type == DeviceType.CUDA, e.name,
                    e.time_range.start, e.time_range.end))
    return out


def profile(fn, device):
    """Run ``fn()`` under torch.profiler; returns a dict with "wall_s",
    "busy_s" (None where no device event was recorded), "device_ops"
    [[name, seconds]] (top 10 by total time) and "idle_gaps"
    [[host event, seconds]] (the 10 longest gaps between device events)
    and "profiler_idle_s" (the device's idle seconds while the host was
    in the profiler's own buffer requests, which an untraced run does not
    make)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return reduce_events(_raw_events(prof), wall)


def reduce_events(evs, wall):
    """``profile``'s dict from the events [(on_device, name, start_us,
    end_us)] of a stretch of ``wall`` seconds."""
    dev = sorted((a, b, n) for d, n, a, b in evs if d and b > a)
    host = sorted((a, b, n) for d, n, a, b in evs if not d and b > a)
    res = {"wall_s": wall, "busy_s": None, "device_ops": [],
           "idle_gaps": [], "profiler_idle_s": None}
    if not dev:
        return res
    by_name: dict = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    res["device_ops"] = [[n, s] for n, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    busy, gaps, merged = 0.0, [], []
    lo, hi = dev[0][0], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((a - hi, hi))
            merged.append((lo, hi))
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    merged.append((lo, hi))
    res["busy_s"] = busy * 1e-6
    starts = [h[0] for h in host]

    def label(at):
        # the innermost host event running when the gap began: the latest
        # start at or before it among those still running
        k = bisect.bisect_right(starts, at)
        for h in reversed(host[max(0, k - 200):k]):
            if h[1] >= at:
                return h[2]
        return "no host event"
    res["idle_gaps"] = [[label(at), g * 1e-6]
                        for g, at in sorted(gaps, reverse=True)[:10]]
    # the device's idle time while the host was in the profiler's buffer
    # requests, inside the device's first and last interval
    ends = [b for _, b in merged]
    idle = 0.0
    for a, b, n in host:
        if n != PROFILER_EVENT:
            continue
        a, b = max(a, merged[0][0]), min(b, merged[-1][1])
        k = bisect.bisect_right(ends, a)
        covered = 0.0
        while k < len(merged) and merged[k][0] < b:
            covered += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
        idle += max(b - a - covered, 0.0)
    res["profiler_idle_s"] = idle * 1e-6
    return res
