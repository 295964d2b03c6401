"""ms of one RDF sample as the runner's plan takes it (the list sampler
where the plan has a list, else the cell or all-pairs sampler), replayed
alone from its CUDA graph on a copy of the window's final state: median
of 20 by CUDA events."""

import torch

from mdbench.timing import event_ms

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "RDF", "moves": "ns_per_day", "workloads": None}


def read(ctx):
    from aztotmd_tpu_torch.runtime.graph import GraphedSample
    r = ctx.runner
    if r.rcfg is None:
        return None
    fn = r._rdf_plan.fn if r.use_list else r._rdf.fn
    hist = torch.zeros_like(r.hist)
    nhist = None if r.nhist is None else torch.zeros_like(r.nhist)
    sample = GraphedSample(fn, "RDF sample")
    sample(ctx.state, hist, nhist)
    return event_ms(lambda: sample(ctx.state, hist, nhist))
