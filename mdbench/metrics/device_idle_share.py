"""Share of the profiled stretch (the window's last whole ring windows)
in which no kernel, copy or fill ran on the card: 1 - the union of the
device intervals that torch.profiler recorded over the stretch's wall
time.  Idle time while the host was in the profiler's own buffer
requests counts (the run's log gives its seconds)."""

META = {"unit": "%", "better": "lower", "source": "device_trace",
        "layer": "device", "moves": "ns_per_day", "workloads": None}


def read(ctx):
    prof = ctx.prof
    if prof is None or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
