"""Run one cell of the benchmark once:

    python3 -m mdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's steps), ``failed`` (steps it did not
complete), ``metrics`` (with ``--trace 0`` the cell's end-to-end metrics,
``ns_per_day`` and ``setup_s``; with ``--trace 1`` its per-layer metrics),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s`` of the
profiled stretch), with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with its limit, which are also the last
lines of standard error.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), when the run or its check fails to
complete, and when a JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# never loaded by the process that prints a result (compared by whole
# top-level module names: the port's name starts with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "aztotmd_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m mdbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        sys.exit("mdbench: --seed must be a whole number >= 0")

    from mdbench import registry
    w = registry.workload(args.workload)
    chips = int(w["chips"])

    import torch
    if not torch.cuda.is_available():
        print("mdbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"mdbench: the cell asks for {chips} devices, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from mdbench.harness import log, run_cell
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   dev, T_START)

    bad = forbidden_modules()
    if bad:
        print(f"mdbench: JAX modules are loaded: {bad}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": res["peak"]}
    if args.trace:
        metrics = res["layer"]
        prof = res["prof"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["wall_s"]
    else:
        metrics = {"ns_per_day": {"value": res["ns_per_day"],
                                  "unit": "ns/day"},
                   "setup_s": {"value": res["setup_s"], "unit": "s"}}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["checks"].items()}
    card = card_line()
    log(f"# card: {card}; window {res['window_steps']} steps in "
        f"{res['window_s']:.4f} s; reference {res['ref_s']:.3f} s")
    for k, (v, lim) in res["checks"].items():
        log(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(out), flush=True)
    return 0


def card_line() -> str:
    """``name, power limit`` of the card, as nvidia-smi prints them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (r.stdout.strip().splitlines() or ["no output"])[0]


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
