"""Share of the runner's time a step that the bare step does not take:
1 - bare ms a step x the runner's steps/s over the unprofiled stretch of
the window, both from this process.  What it holds: the RDF samples, the
stat rows and their flush, the writers, the host's dispatch.

Only where the bare step does the runner's pair work: on a deck without a
neighbor list.  On the Verlet list the bare multi-step starts each call
with a full rebuild and rebuilds a superblock every ``nb_outer`` x
``nb_rebuild`` steps, while the ring's plan rebuilds once in ``k_super``
stat periods and refines each RDF block, so the difference would mix
list work into the runner's share."""

from mdbench.timing import bare_step_ms

META = {"unit": "%", "better": "lower", "source": "host_clock",
        "layer": "runner", "moves": "ns_per_day",
        "workloads": ["cs2_surkov_4k"]}


def read(ctx):
    rate = ctx.win_steps / ctx.win_wall
    return 100.0 * (1.0 - bare_step_ms(ctx) * 1e-3 * rate)
