"""Share of its roofline that the stacked cell-block kernel (K3) reaches
alone: the least time of the pair work (``mdbench/roofline.py``: the
potential's operations over the pairs within the cutoff on the window's
final state, and each input and output byte once) over the replayed ms of
the port's ``ops/cellblock.py::launch`` alone, on a table built once from
that state by ``cell_table`` outside the graph, 20 launches in one CUDA
graph.  The binning around it is ``cell_bin_ms``.  Null where the port
has no such functions, or where the runner's record of the window's
unprofiled stretch shows no launch of the kernel (``cellblock.launches``:
the window ran another pass)."""

import sys

from mdbench import roofline
from mdbench.records import window_record
from mdbench.reference.md import pairs_within
from mdbench.timing import graph_call_ms

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "pair kernels", "moves": "ns_per_day",
        "workloads": ["lj_liquid_32k"]}


def read(ctx):
    rec = window_record(ctx)
    launched = rec["counters"].get("cellblock.launches", 0) if rec else 0
    if not launched:
        return None
    try:
        from aztotmd_tpu_torch.ops.allpairs import kernel_tables
        from aztotmd_tpu_torch.ops.cellblock import cell_table, launch
    except ImportError:
        return None
    r = ctx.runner
    cfg, st = r.cfg, ctx.state
    table = cell_table(cfg, st.pos, st.types,
                       st.radii if cfg.use_radii else None)
    prm, kinds = kernel_tables(cfg, r.ff, ctx.device)
    ms = graph_call_ms(lambda: launch(cfg, prm, kinds, table), ctx.device)
    p = ctx.params
    x = st.pos.double()
    i, _ = pairs_within(x, ctx.box, p["r_cut"])
    flops, nbytes = roofline.pair_work(p["pot"], x.shape[0], len(i),
                                       p["pot"] == "surk")
    least, bound = roofline.least_seconds(flops, nbytes)
    share = 100.0 * least * 1e3 / ms
    from mdbench.run import card_line
    c = rec["counters"]
    print(f"# cellblock_roofline: {launched} launches in {rec['steps']} "
          f"window steps (pair pass {rec.get('pair_pass')!r}, regrow "
          f"{c.get('regrow')}, captures {c.get('captures')}); "
          f"{len(i)} pairs within {p['r_cut']} A, {flops} "
          f"flop, {nbytes} bytes, least {least * 1e3:.6g} ms ({bound}), "
          f"kernel replayed {ms:.6g} ms a launch: {share:.6g}% "
          f"({card_line()})", file=sys.stderr, flush=True)
    return share
