"""Command-line interface (port of ``aztotmd_tpu/__main__.py``).

``python -m aztotmd_tpu_torch run <deck_dir> -o <out_dir>`` reads
control.txt / field.txt / atoms.xyz from the deck directory, runs it on
the GPU and writes the output files.  ``--cpu`` runs it on the CPU with
the kernels' plain versions.  ``--mesh N`` runs the slab-decomposed step
over N slabs on the one device, and with ``--mesh-mode atoms`` the
atom-sharded step over N row shards; with ``--dist``, under ``torchrun
--nproc-per-node N``, one slab or shard per process (NCCL on the GPUs,
gloo with ``--cpu``), where rank 0 writes to ``-o`` and rank r to
``<out>/rank<r>``.
``--debug`` checks the state's invariants after every chunk,
``--timings`` prints the host seconds of the runner's spans, which never
wait on the card, and the call's counters, and ``--profile LOG_DIR``
also writes a torch.profiler trace there and prints the card's idle
seconds by span.  On the card each step is a replay of a captured CUDA
graph (``runtime/graph.py``).
``bench`` times steps of a deck, eager and as graph replays, with the
measuring function of the headline bench (``python -m
aztotmd_tpu_torch.bench``).
"""

from __future__ import annotations

import argparse
import os
import sys


def _device(cpu: bool, dist: bool = False):
    import torch
    if not cpu and not torch.cuda.is_available():
        sys.exit("aztotmd_tpu_torch: no CUDA device is available; pass "
                 "--cpu to run on the CPU")
    if dist:
        from .parallel import init_dist
        local = init_dist("cpu" if cpu else "cuda")
        return torch.device("cpu") if cpu else torch.device("cuda", local)
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def main(argv=None):
    """Run the CLI; returns the MDRunner of a ``run``, or the result dict
    of a ``bench``."""
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU (kernels' plain versions) "
                             "instead of the GPU")
    common.add_argument("--dtype", choices=("f32", "f64"), default="f32",
                        help="compute precision")
    p = argparse.ArgumentParser(prog="aztotmd_tpu_torch",
                                description="azTotMD in PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", parents=[common],
                       help="run a simulation deck directory")
    r.add_argument("deck", help="directory with control.txt/field.txt/"
                                "atoms.xyz")
    r.add_argument("-o", "--out", default=".", help="output directory")
    r.add_argument("--steps", type=int, default=None,
                   help="override nstep from control.txt")
    r.add_argument("--seed", type=int, default=12345)
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--checkpoint-every", type=int, default=0,
                   help="write checkpoint.npz every N steps")
    r.add_argument("--resume", default=None,
                   help="checkpoint.npz to resume from (from either "
                        "package)")
    r.add_argument("--no-bond-equil-hack", action="store_true",
                   help="disable the reference's reactive-bond "
                        "velocity-zeroing equilibration hack")
    r.add_argument("--debug", action="store_true",
                   help="check state invariants after every chunk "
                        "(the reference's DEBUG_MODE verify kernels)")
    r.add_argument("--profile", default=None, metavar="LOG_DIR",
                   help="capture a torch.profiler trace into LOG_DIR, "
                        "print the card's idle seconds by span and the "
                        "span timings")
    r.add_argument("--timings", action="store_true",
                   help="print the host seconds of each runner span (no "
                        "sync; the card's wait as 'wait') and the counters")
    r.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run over an N-shard mesh (see --mesh-mode)")
    r.add_argument("--mesh-mode", choices=("slab", "atoms"),
                   default="slab",
                   help="slab: the slab-decomposed step over N x-slabs, "
                        "with migration; atoms: per-atom arrays in N equal "
                        "row shards, the one-device step over their "
                        "gather (any deck whose atom count N divides)")
    r.add_argument("--dist", action="store_true",
                   help="one slab or shard per process under torchrun "
                        "(with --mesh N = the number of processes)")

    b = sub.add_parser("bench", parents=[common],
                       help="benchmark a deck (steps/sec)")
    b.add_argument("deck")
    b.add_argument("--steps", type=int, default=200)
    b.add_argument("--warmup", type=int, default=20)
    args = p.parse_args(argv)
    dist = args.cmd == "run" and args.dist
    device = _device(args.cpu, dist)

    if args.cmd == "run":
        from .runtime.runner import MDRunner
        from .runtime.setup import load_deck_dir
        sysd = load_deck_dir(args.deck, dtype=args.dtype, seed=args.seed,
                             device=device,
                             bond_equil_hack=not args.no_bond_equil_hack)
        if args.resume:
            from .runtime.checkpoint import load_checkpoint
            sysd["state"] = load_checkpoint(args.resume, sysd["state"])
            print(f"resumed from {args.resume} at step "
                  f"{int(sysd['state'].step)}", file=sys.stderr)
        comm, out = None, args.out
        if dist:
            from .parallel import make_comm
            comm = make_comm(args.mesh, device, dist=True)
            if comm.rank:
                out = os.path.join(args.out, f"rank{comm.rank}")
        runner = MDRunner(sysd, out_dir=out, quiet=args.quiet or (
                              comm is not None and comm.rank > 0),
                          checkpoint_every=args.checkpoint_every,
                          append=args.resume is not None,
                          mesh_devices=args.mesh, mesh_mode=args.mesh_mode,
                          comm=comm,
                          profile=args.profile is not None or args.timings,
                          debug=args.debug)
        if args.profile:
            from .utils import trace
            with trace(args.profile):
                runner.run(args.steps)
        else:
            runner.run(args.steps)
        runner.finalize()
        return runner

    import json

    import torch

    from .bench import measure
    from .runtime.setup import load_deck_dir
    from .runtime.step import torch_engine_reason
    sysd = load_deck_dir(args.deck, dtype=args.dtype, device=device)
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"

    res = None
    # one line eager, one line as CUDA-graph replays of the same steps,
    # each timed by the headline bench's measure (bench.py)
    for graph in (False, True):
        line = {"graph": graph, "n_at": sysd["cfg"].n_at, "device": name}
        if graph and not cuda:
            line.update(steps_per_sec=None,
                        note="CUDA graphs need the card")
            print(json.dumps(line))
            continue
        line["steps_per_sec"] = measure(sysd, args.steps, 1, graph,
                                        warm=args.warmup)["steps_per_sec"]
        if cuda:
            # why the pair pass is torch ops and no kernel, or null
            line["torch_engine"] = torch_engine_reason(
                sysd["cfg"], sysd["state"].pos.dtype)
        print(json.dumps(line))
        if res is None:
            res = line
        else:
            res["graph_steps_per_sec"] = line["steps_per_sec"]
    return res


if __name__ == "__main__":
    main()
