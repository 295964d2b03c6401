"""Verlet lists built a thousand window steps: full rebuilds plus inner
refines over the unprofiled stretch of the window, from the port's
counters ``runtime.step.nbr_counts`` (each replay adds its capture's)."""

META = {"unit": "lists/kstep", "better": "lower",
        "source": "program_counter", "layer": "neighbor list",
        "moves": "ns_per_day",
        "workloads": ["cs1_argon_40k", "cs1_argon_1080k"]}


def read(ctx):
    if "rebuild" not in ctx.runner.multi.fns:
        return None
    a, b = ctx.nbr_counts
    n = sum(b[k] - a[k] for k in ("rebuild", "refine"))
    return n * 1000.0 / ctx.win_steps
