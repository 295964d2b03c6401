"""ms a step of the bare replayed multi-step (``make_multi_step(graph=
True)``, no runner, no RDF, no output) on a copy of the window's final
state: a chunk's wall time over all its steps."""

from mdbench.timing import bare_step_ms

META = {"unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "step", "moves": "ns_per_day", "workloads": None}


def read(ctx):
    return bare_step_ms(ctx)
