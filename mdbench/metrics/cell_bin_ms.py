"""ms of the stacked cell-block pass's binning alone: the port's
``ops/cellblock.py::cell_table`` (the atoms binned into the grid's
(n_cell, cap) table with the count of each cell) on the window's final
state, replayed from a CUDA graph of 20 calls as ``pair_roofline`` times
the whole pass.  With ``cellblock_roofline`` (the kernel alone on one
such table) it splits the pass that ``pair_roofline`` times into its two
parts.  Null where the port has no such function or no cell grid."""

import sys

from mdbench.timing import graph_call_ms

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "pair kernels", "moves": "ns_per_day",
        "workloads": ["lj_liquid_32k"]}


def read(ctx):
    try:
        from aztotmd_tpu_torch.ops.cellblock import cell_table
    except ImportError:
        return None
    cfg = ctx.runner.cfg
    if getattr(cfg, "grid", None) is None:
        return None
    st = ctx.state
    radii = st.radii if cfg.use_radii else None
    ms = graph_call_ms(lambda: cell_table(cfg, st.pos, st.types, radii),
                       ctx.device)
    g = cfg.grid
    print(f"# cell_bin_ms: {cfg.n_at} atoms into {g.dims} cells of cap "
          f"{g.cap}: replayed {ms:.6g} ms a call", file=sys.stderr,
          flush=True)
    return ms
