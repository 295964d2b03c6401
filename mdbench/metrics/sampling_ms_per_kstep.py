"""Host ms a thousand window steps in the runner's span ``sampling``: a
ring window's rows decoded into the writers and its monitors read
(``MDRunner._flush_window``), and the host events (``_sample_rest``),
from the runner's record of the window's unprofiled stretch.  Null where
the program keeps no such record."""

from mdbench.records import span_ms_per_kstep

META = {"unit": "ms/kstep", "better": "lower", "source": "program_span",
        "layer": "runner", "moves": "ns_per_day", "workloads": None}


def read(ctx):
    return span_ms_per_kstep(ctx, "sampling")
