"""Readings for setting the check's limits, on the card at the cell's own
size: the run's numbers over many seeds (the lower readings) and the
control's, the reference in bfloat16 put in the run's place, on the first
few (the upper readings), in one process so that set-up is paid once:

    python3 -m mdbench.calibrate --workload <cell> --seeds 11,12,13 \
        --controls 3 --seconds 3 [--out readings.jsonl]

One JSON line a seed on standard output (and appended to ``--out``):
{"seed", "numbers", "control" (or null), "correct", "ns_per_day",
"window_steps"}.  The benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m mdbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mdbench.calibrate: no CUDA device is available")
    from mdbench.harness import run_cell
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for k, seed in enumerate(seeds):
        res = run_cell(args.workload, seed, args.seconds, False, dev,
                       time.perf_counter(), controls=k < args.controls)
        rec = {"workload": args.workload, "seed": seed,
               "numbers": {n: v for n, (v, _) in res["checks"].items()},
               "control": res["control"], "correct": res["correct"],
               "ns_per_day": res["ns_per_day"],
               "window_steps": res["window_steps"]}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
