"""Share of its roofline that the step's pair pass reaches: the least time
of the pair work (``mdbench/roofline.py``: the potential's operations
over the pairs within the cutoff on the window's final state, and each
input and output byte once) over the replayed ms of the function the
step calls for the deck's pair forces, timed alone by CUDA events over a
graph of 20 calls on that state.

The function timed is the one the step calls: on the Verlet list
``aztotmd_tpu_torch.ops.neighbors.pair_forces_rows`` (the row-compacted
walk; ``pair_forces_neighbors`` without row compaction), and for every
other engine ``runtime.step.PAIR_ENGINES`` of the configuration's engine
(``pair_forces_pallas`` on "pallas": K1 on a dense deck), with the same
arguments.  A name the port no longer has makes the metric null."""

import sys

from mdbench import roofline
from mdbench.reference.md import pairs_within
from mdbench.timing import graph_call_ms

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "pair kernels", "moves": "ns_per_day", "workloads": None}


def _pair_call(cfg, ff, st):
    """The pair function of the step and a call of it on ``st``."""
    radii = st.radii if cfg.use_radii else None
    if cfg.pair_engine == "neighbor":
        from aztotmd_tpu_torch.ops import neighbors as nb
        if cfg.nb_rowcap:
            return lambda: nb.pair_forces_rows(
                cfg, ff, st.pos, st.types, st.nbrow_idx, radii=radii,
                parents=st.parents)
        return lambda: nb.pair_forces_neighbors(
            cfg, ff, st.pos, st.types, st.nbr_idx, radii=radii,
            parents=st.parents)
    from aztotmd_tpu_torch.runtime import step as step_mod
    fn = step_mod.PAIR_ENGINES.get(cfg.pair_engine, step_mod.pair_forces)
    want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
    want_jump = cfg.ejtype != 0
    return lambda: fn(cfg, ff, st.pos, st.types, radii=radii,
                      parents=st.parents, want_bind=want_bind,
                      want_jump=want_jump)


def read(ctx):
    r = ctx.runner
    try:
        call = _pair_call(r.cfg, r.ff, ctx.state)
    except AttributeError:
        return None
    ms = graph_call_ms(call, ctx.device)
    p = ctx.params
    x = ctx.state.pos.double()
    i, _ = pairs_within(x, ctx.box, p["r_cut"])
    flops, nbytes = roofline.pair_work(p["pot"], x.shape[0], len(i),
                                       p["pot"] == "surk")
    least, bound = roofline.least_seconds(flops, nbytes)
    share = 100.0 * least * 1e3 / ms
    from mdbench.run import card_line
    print(f"# pair_roofline: {len(i)} pairs within {p['r_cut']} A, "
          f"{flops} flop, {nbytes} bytes, least {least * 1e3:.6g} ms "
          f"({bound}), replayed {ms:.6g} ms a call: {share:.6g}% "
          f"({card_line()})", file=sys.stderr, flush=True)
    return share
