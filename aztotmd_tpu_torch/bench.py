"""Headline benchmark of the port on one GPU: steps/s of in-tree decks (the
counterpart of the root ``bench.py``, which reads the reference's case
studies from outside the repo).

    python -m aztotmd_tpu_torch.bench [--deck DIR] [--scale] [--eager]
                                      [--chunk N] [--windows W]

Default decks, in this order: ``examples/argon_gas`` (case study 1's
shape: 40,000 Ar, LJ, the two-level Verlet list) and
``examples/surkov_cluster`` (case study 2's shape: 4,000 clustered Surkov
atoms, the dense pass K1).  ``--scale`` adds the decks of the JAX
system's tools, written into a temporary directory from
examples/argon_gas by ``systems``: the 320,000- and 1,080,000-atom tilings
(``write_scale_argon_deck``) and the dilute deck
(``write_dilute_argon_deck``, the outer-row-compacted refine).
``--deck DIR`` runs that deck alone.

It measures the production mode: ``make_multi_step`` with every step a
CUDA-graph replay (``runtime/graph.py``), one chunk of ``--chunk`` steps
to warm up and capture first, then the best of ``--windows`` windows of
one chunk each.  ``--eager`` measures eager steps instead (the
counterpart of bench.py's ``AZTOT_BENCH_MODE=step``).

Standard output: one JSON line per deck with bench.py's four keys
``metric``, ``value`` (steps/s), ``unit`` and ``vs_baseline``, against
bench.py's bar of 813 steps/s (its reading of the reference's own timing
note for an RTX 2080 Ti-class GPU, bench.py:20-29).  Standard error: one
``#`` line per deck with the deck, mode, ns/day, setup, warm-up and
capture seconds, the window times, chunk, atom count, engine, the card's
name and power limit, the peak memory allocated, and from the same call
the bare eager and replayed steps/s, the CLI's steps/s through the runner
(with the full list rebuilds and refines it ran), the RDF plan the runner
takes (``MDRunner._ring_plan``, the JAX stat ring's), and the replayed
RDF sample's ms on its own: ``rdf_sample_ms`` the cell-candidate (or
all-pairs) sample, ``rdf_plan_sample_ms`` the list sample the plan takes
instead, where it takes one.  A deck that fails prints its traceback,
the others still run, and the script exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

BASELINE_STEPS_PER_SEC = 813.0
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
DECKS = [
    ("steps_per_sec_argon_gas_40k_ar_lj",
     os.path.join(EXAMPLES, "argon_gas")),
    ("steps_per_sec_surkov_cluster_4k_surkov",
     os.path.join(EXAMPLES, "surkov_cluster")),
]
# bare eager steps timed beside the replayed ones, and steps of the CLI
EAGER_STEPS = 100
CLI_STEPS = 1000


def scale_decks(root: str):
    """(metric, deck) of the tools' decks, written under ``root``."""
    from . import systems
    out = []
    for tiles, tag in ((2, "320k"), (3, "1080k")):
        d = os.path.join(root, f"argon_scale_{tag}")
        systems.write_scale_argon_deck(d, tiles)
        out.append((f"steps_per_sec_argon_scale_{tag}_ar_lj", d))
    d = os.path.join(root, "argon_dilute")
    systems.write_dilute_argon_deck(d)
    out.append(("steps_per_sec_argon_dilute_40k_ar_lj", d))
    return out


def card_line() -> str:
    """``name, power limit`` of the card, as nvidia-smi prints them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return (res.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(sysd: dict, chunk: int, windows: int, graph: bool,
            warm: int | None = None) -> dict:
    """Time the deck's multi-step (``make_multi_step``; every step a
    CUDA-graph replay with ``graph``, else eager): ``warm`` steps (default
    one chunk) to warm up and capture, then ``windows`` windows of
    ``chunk`` steps.  Returns {"warm_s", "capture_s" (None eager),
    "nodes" (graph nodes a step, None eager), "times" (s a window),
    "steps_per_sec" (the best window's), "state"}."""
    from .runtime.step import make_multi_step
    cfg, ff = sysd["cfg"], sysd["ff"]
    device = sysd["state"].pos.device
    multi = make_multi_step(cfg, sysd["aux"], graph=graph)
    _sync(device)
    t0 = time.perf_counter()
    state = multi(sysd["state"], ff, chunk if warm is None else warm)
    _sync(device)
    warm_s = time.perf_counter() - t0
    progs = multi.graphs.programs if graph else {}
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        state = multi(state, ff, chunk)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return {"warm_s": warm_s,
            "capture_s": (sum(p.capture_seconds for p in progs.values())
                          if progs else None),
            "nodes": progs["step"].nodes if progs else None,
            "times": times, "steps_per_sec": chunk / min(times),
            "state": state}


def _cli_rate(sysd, device, steps):
    """steps/s of the runner over ``steps`` steps (outputs to a temporary
    directory; loop time, setup excluded), the runner and the full list
    rebuilds and refines it ran."""
    from .runtime import step as step_mod
    from .runtime.runner import MDRunner
    with tempfile.TemporaryDirectory(prefix="aztotmd_bench_") as out:
        r = MDRunner(sysd, out_dir=out, quiet=True)
        counts0 = dict(step_mod.nbr_counts)
        step_mod.nbr_counts.update(rebuild=0, refine=0)
        r.run(steps)
        _sync(device)
        counts = dict(step_mod.nbr_counts)
        step_mod.nbr_counts.update(counts0)
        return r.steps_run / r.loop_seconds, r, counts


def plan_name(runner) -> str:
    """The RDF plan of the runner in one word: "from_outer" (the outer
    Verlet list), "list_covers_outer" (the RDF list, the outer list
    refined from it), "list" (the RDF list), "cells" (the cell candidates
    or all pairs, without a stat-period plan or its list), "none" (no
    RDF)."""
    if runner.rcfg is None:
        return "none"
    if not (runner._ring_plan and runner.use_list):
        return "cells"
    if runner._ring_plan["rdf_from_outer"]:
        return "from_outer"
    return ("list_covers_outer" if runner._ring_plan["rdf_covers_outer"]
            else "list")


def _rdf_ms(runner, device, fn=None):
    """ms of one RDF sample ``fn`` (default: the cell-candidate or
    all-pairs sample) of the runner's state on its own: replayed from its
    CUDA graph on the card (CUDA events, median of 20), eager on the CPU
    (wall clock); None without an RDF."""
    import statistics

    import torch

    from .runtime.graph import GraphedSample
    if runner.rcfg is None:
        return None
    st = runner.state
    hist = torch.zeros_like(runner.hist)
    nhist = None if runner.nhist is None else torch.zeros_like(runner.nhist)
    sample = GraphedSample(fn or runner._rdf.fn, "RDF sample")
    sample(st, hist, nhist)
    ms = []
    for _ in range(20):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sample(st, hist, nhist)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            sample(st, hist, nhist)
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def bench_deck(metric, deck, device, chunk=2000, windows=5, eager=False,
               card=None) -> dict:
    """One deck: the JSON line on stdout, the ``#`` line on stderr;
    returns both as a dict ({"line", plus every number})."""
    import torch

    from .runtime.setup import load_deck_dir
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)        # initialises the allocator
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    sysd = load_deck_dir(deck, device=device)
    setup_s = time.perf_counter() - t0
    cfg = sysd["cfg"]
    main = measure(sysd, chunk, windows, graph=not eager)
    sps = main["steps_per_sec"]
    line = {"metric": metric, "value": round(sps, 2), "unit": "steps/s",
            "vs_baseline": round(sps / BASELINE_STEPS_PER_SEC, 3)}
    print(json.dumps(line), flush=True)
    del main["state"]
    # ROADMAP item 5's numbers from the same call: bare eager and replayed
    # steps/s, the CLI through the runner, the replayed RDF sample alone
    # (the programs are functional and the graphs advance a static copy:
    # sysd's state is still the deck's first state)
    if eager:
        eager_sps, graph_sps = sps, None
    else:
        n = min(EAGER_STEPS, chunk)
        eager_sps = measure(sysd, n, 1, graph=False,
                            warm=min(10, n))["steps_per_sec"]
        graph_sps = sps
    cli_sps, runner, counts = _cli_rate(sysd, device, CLI_STEPS)
    rdf_ms = _rdf_ms(runner, device)
    plan = plan_name(runner)
    plan_ms = (_rdf_ms(runner, device, runner._rdf_plan.fn)
               if plan not in ("none", "cells") else None)
    del runner
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    ns_day = sps * cfg.dt * 86400.0 / 1000.0          # dt in ps
    rec = dict(line=line, deck=deck, mode="eager" if eager else "graph",
               ns_day=ns_day, setup_s=setup_s, warm_s=main["warm_s"],
               capture_s=main["capture_s"], nodes=main["nodes"],
               windows=main["times"], chunk=chunk, n_at=cfg.n_at,
               engine=cfg.pair_engine, nb_orowcap=cfg.nb_orowcap,
               card=card or (card_line() if cuda else "cpu"),
               peak_bytes=peak, eager_steps_per_sec=eager_sps,
               graph_steps_per_sec=graph_sps, cli_steps_per_sec=cli_sps,
               cli_steps=CLI_STEPS, cli_rebuilds=counts["rebuild"],
               cli_refines=counts["refine"], rdf_plan=plan,
               rdf_sample_ms=rdf_ms, rdf_plan_sample_ms=plan_ms)
    fmt = lambda v: "null" if v is None else f"{v:.4g}"
    print(f"# deck={deck!r} mode={rec['mode']} ns/day={ns_day:.2f} "
          f"setup={setup_s:.1f}s warmup+capture={main['warm_s']:.2f}s "
          f"(capture {fmt(main['capture_s'])}s, {main['nodes']} graph "
          f"nodes a step) windows={[round(t, 4) for t in main['times']]} "
          f"chunk={chunk} n_at={cfg.n_at} engine={cfg.pair_engine} "
          f"nb_orowcap={cfg.nb_orowcap} card={rec['card']!r} "
          f"max_memory_allocated={peak} bare eager steps/s="
          f"{fmt(eager_sps)} bare replayed steps/s={fmt(graph_sps)} "
          f"CLI steps/s={fmt(cli_sps)} ({CLI_STEPS} steps, rebuilds="
          f"{counts['rebuild']} refines={counts['refine']}) rdf_plan={plan} "
          f"replayed RDF sample ms={fmt(rdf_ms)} (cell candidates) "
          f"rdf_plan_sample_ms={fmt(plan_ms)}", file=sys.stderr, flush=True)
    return rec


def main(argv=None, device=None):
    """Run the bench; returns the decks' records, or exits 1 when a deck
    failed (after every other deck ran)."""
    ap = argparse.ArgumentParser(prog="python -m aztotmd_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--deck", default=None,
                    help="run this deck directory alone")
    ap.add_argument("--scale", action="store_true",
                    help="add the 320k and 1.08M tilings and the dilute "
                         "deck of examples/argon_gas")
    ap.add_argument("--eager", action="store_true",
                    help="time eager steps instead of graph replays")
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            sys.exit("aztotmd_tpu_torch.bench: no CUDA device is available")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    eager = args.eager or device.type != "cuda"
    card = card_line() if device.type == "cuda" else "cpu"
    failed = 0
    recs = []
    with tempfile.TemporaryDirectory(prefix="aztotmd_bench_decks_") as tmp:
        decks = ([("steps_per_sec_custom_deck", args.deck)] if args.deck
                 else list(DECKS))
        if args.scale:
            decks += scale_decks(tmp)
        for metric, deck in decks:
            try:
                recs.append(bench_deck(metric, deck, device, args.chunk,
                                       args.windows, eager, card))
            except Exception:               # noqa: BLE001
                # one deck's failure must not erase another deck's line
                import traceback
                traceback.print_exc()
                failed += 1
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if failed:
        sys.exit(1)
    return recs


if __name__ == "__main__":
    main()
