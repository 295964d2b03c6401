"""Nodes of the captured step program (kernels, copies, fills), as the
CUDA driver library counts them (``Program.nodes``)."""

META = {"unit": "nodes", "better": "lower", "source": "program_counter",
        "layer": "CUDA graphs", "moves": "ns_per_day", "workloads": None}


def read(ctx):
    prog = ctx.runner.multi.graphs.programs.get("step")
    return None if prog is None else prog.nodes
