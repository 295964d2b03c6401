"""The port's own record of the window's unprofiled stretch, which the
span and launch readers share: ``MDRunner.timer.calls`` keeps one record
a ``run()`` call (``aztotmd_tpu_torch/utils/profiling.py::StageTimer``),
``{"steps", "wall_s", "spans": {name: [seconds, count]}, "counters":
{name: n}}``.  In a traced run the last call is the profiled stretch and
the one before it the unprofiled stretch, ``runner.run(T0 + L1)``."""

from __future__ import annotations


def window_record(ctx):
    """The record of the unprofiled stretch, or None where the program
    keeps no records or that record is of other steps."""
    calls = getattr(getattr(ctx.runner, "timer", None), "calls", None)
    if not calls or len(calls) < 2:
        return None
    rec = calls[-2]
    return rec if rec.get("steps") == ctx.win_steps else None


def span_ms_per_kstep(ctx, name):
    """Host ms of the record's span ``name`` a thousand steps (0 where the
    call never entered it), or None."""
    rec = window_record(ctx)
    if rec is None:
        return None
    seconds = rec["spans"].get(name, [0.0, 0])[0]
    return seconds * 1e3 * 1000.0 / rec["steps"]
