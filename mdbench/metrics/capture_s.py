"""Seconds the runner's CUDA graphs took to warm up and capture: the sum
of ``Program.capture_seconds`` over the runner's state programs and its
captured RDF samples."""

META = {"unit": "s", "better": "lower", "source": "program_span",
        "layer": "CUDA graphs", "moves": "setup_s", "workloads": None}


def read(ctx):
    r = ctx.runner
    progs = list(r.multi.graphs.programs.values())
    for attr in ("_rdf", "_rdf_plan"):
        s = getattr(r, attr, None)
        if s is not None and s.program is not None:
            progs.append(s.program)
    if not progs:
        return None
    return sum(p.capture_seconds for p in progs)
