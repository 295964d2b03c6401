"""Host ms a thousand window steps in the runner's span ``steps``: the
host enqueuing the step-advancing programs (``MDRunner._ring``, one ring
window with its rows' copy to the host, and ``_advance``), from the
runner's record of the window's unprofiled stretch.  The span never waits
on the card, so on a card-paced cell it is a small share of the wall.
Null where the program keeps no such record."""

from mdbench.records import span_ms_per_kstep

META = {"unit": "ms/kstep", "better": "lower", "source": "program_span",
        "layer": "runner", "moves": "ns_per_day", "workloads": None}


def read(ctx):
    return span_ms_per_kstep(ctx, "steps")
