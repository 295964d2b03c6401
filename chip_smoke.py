#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (aztotmd_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout.  It builds the port's CUDA kernels
(csrc/allpairs.cu, K1, and csrc/sparse.cu, K4) for sm_90a from the
checkout, one nvcc each, in parallel, and then, for each kernel, checks
it against its plain PyTorch version on the card:
  K1, the dense pair pass: the Surkov slice deck's 4,000-atom state,
      every VdW family, three species with direct/Ewald/Fennel Coulomb
      and radii, ragged N;
  K4, the Morton block-sparse pass: the nanoclusters deck's 12,000-atom
      state (T=256, pair_cap 1,536), multi-cluster systems with 1-3
      species, direct/Ewald/Fennel and radii, ragged N (N not a multiple
      of T, and N < T) and a truncated worklist (max_occ equal, tiles no
      entry visits exactly zero).
It drives each kernel's path through the ``run`` CLI, with every launch
count set to 0 just before and read just after: examples/surkov_cluster
(K1) and examples/nanoclusters (K4, Nose-Hoover, cell-list RDF), and
checks that every pair pass went through that path's kernel, that
stat.dat is finite and rdf.dat non-zero.  It compares 20 steps with each
kernel against 20 steps with its plain version, and times both versions
at the paths' sizes with CUDA events, beside a lower bound computed from
an operation count read off csrc/pair_physics.cuh.  Any failure exits
non-zero.  The last line of standard output is {"ok": true, "device":
{...}}; the line before it lists the kernels with their launches,
errors, times and bounds.  The runs' output files go to --out (default:
a temporary directory that is removed).
"""

import argparse
import concurrent.futures
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SURKOV_DECK = os.path.join(HERE, "examples", "surkov_cluster")
NANO_DECK = os.path.join(HERE, "examples", "nanoclusters")
SLICE_STEPS = 2000
FORCE_ATOL = 3e-5        # x max|F|: f32 sums in another order
ENERGY_REL = 1e-4
TRAJ_POS_ATOL = 1e-4     # A after 20 steps, f32
TRAJ_ENERGY_REL = 1e-4

# Peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet; the MUFU
# rate is 16 results per clock per SM for compute capability 9.0 at the
# 1.98 GHz boost clock, CUDA C++ Programming Guide throughput table).
PEAK_FP32 = 67e12        # FLOP/s outside the tensor cores
PEAK_MUFU = 132 * 16 * 1.98e9
PEAK_BYTES = 3.35e12     # HBM3 bytes/s
# FP32 operations (an FMA counts 2) read off csrc/pair_physics.cuh:
# every slot pair: displacement, min-image (mul, rint, fma) per axis, r2
# and the cutoff test; a pair in range: r2i, rr, r2cut test, clip, energy
# and force accumulation, plus the family's own terms; MUFU: the rsqrt,
# and the reciprocal of Surkov's division.
OPS_SLOT = 21
OPS_PAIR = {"lnjs": 24, "surk": 40}
MUFU_PAIR = {"lnjs": 1, "surk": 2}


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def toolchain(torch, cuda_build):
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    rel = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch CUDA {torch.version.cuda}  nvcc: "
        f"{rel[0].strip() if rel else 'unknown'}")


def build_all(cuda_build, names):
    """One nvcc per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(cuda_build.build, names)))
    for name in names:
        so, secs = built[name]
        log(f"build: {os.path.relpath(so, HERE)} in {secs:.1f} s")
        with open(so[:-3] + ".log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    log("  ptxas: " + ln.strip())


def compare(torch, kernel, plain, name, cfg, ff, pos, types, radii, **kw):
    """Kernel against plain on the card; returns the max abs force error."""
    k = kernel(cfg, ff, pos, types, radii, **kw)
    p = plain(cfg, ff, pos, types, radii, **kw)
    torch.cuda.synchronize()
    err = float((k.frc - p.frc).abs().max()) if cfg.n_at else 0.0
    scale = float(p.frc.abs().max()) if cfg.n_at else 0.0
    ev, pv = float(k.eng_vdw), float(p.eng_vdw)
    ec, pc = float(k.eng_coul), float(p.eng_coul)
    ko, po = int(k.max_occ), int(p.max_occ)
    ok = (err <= FORCE_ATOL * max(scale, 1.0)
          and abs(ev - pv) <= ENERGY_REL * abs(pv) + 1e-6
          and abs(ec - pc) <= ENERGY_REL * abs(pc) + 1e-6 and ko == po)
    log(f"  {name:34s} N={cfg.n_at:5d}  max|dF|={err:.3e} "
        f"(limit {FORCE_ATOL * max(scale, 1.0):.3e})  "
        f"Evdw {ev:.6f} vs {pv:.6f}  Ecoul {ec:.6f} vs {pc:.6f}  "
        f"max_occ {ko} vs {po}  {'ok' if ok else 'FAIL'}")
    check(ok, f"kernel disagrees with plain version: {name}")
    return err, k


def time_calls(torch, fn, n=10):
    """Per-call device times (ms) of n calls, from CUDA events."""
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def timed(torch, fns):
    """Medians (ms) of each callable, warmed, in turns a, b, b, a."""
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for order in (range(len(fns)), reversed(range(len(fns)))):
        for i in order:
            times[i] += time_calls(torch, fns[i])
    return [statistics.median(t) for t in times]


def pairs_in_range(torch, cfg, pos, rows=1024):
    """Ordered pairs i != j with min-image r2 <= r2_max (the pairs that
    take the physics branch), counted on the card."""
    box = torch.tensor(cfg.box, dtype=pos.dtype, device=pos.device)
    n = 0
    for i0 in range(0, cfg.n_at, rows):
        d = pos[i0:i0 + rows, None, :] - pos[None, :, :]
        d = d - box * torch.round(d / box)
        n += int(((d * d).sum(-1) <= cfg.r2_max).sum())
    return n - cfg.n_at                    # the self pairs have r2 = 0


def bound(slot_pairs, pairs, fam, nbytes):
    """(bound_ms, bound_by, detail) from this run's counts."""
    fp32 = (slot_pairs * OPS_SLOT + pairs * OPS_PAIR[fam]) / PEAK_FP32
    mufu = pairs * MUFU_PAIR[fam] / PEAK_MUFU
    t_bytes = nbytes / PEAK_BYTES
    detail = (f"FP32 {fp32 * 1e3:.4f} ms, MUFU {mufu * 1e3:.4f} ms, "
              f"bytes {t_bytes * 1e3:.5f} ms")
    which = "operations" if max(fp32, mufu) >= t_bytes else "bytes"
    return max(fp32, mufu, t_bytes) * 1e3, which, detail


def drive(cli, torch, counters, name, deck, out, steps):
    """One path through the run CLI with every launch count set to 0 just
    before it; returns (runner, launches per kernel, steps/s)."""
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    runner = cli(["run", deck, "--steps", str(steps), "-o", out, "--quiet"])
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}
    rate = runner.steps_run / runner.loop_seconds
    log(f"{name} run: {runner.steps_run} steps of {runner.cfg.n_at} atoms "
        f"in {runner.loop_seconds:.2f} s loop ({wall:.2f} s with setup): "
        f"{rate:.1f} steps/s")
    log(f"  kernel launches {launches}, pair-force evaluations "
        f"{runner.steps_run}")
    check(runner.steps_run == steps, f"{name} run stopped early")
    rows = []
    with open(os.path.join(out, "stat.dat")) as f:
        for ln in f.readlines()[2:]:
            rows.append([float(v) for v in ln.split()])
    check(len(rows) == steps // runner.p_stat, f"{name} stat.dat rows")
    check(all(all(v == v and abs(v) < 1e30 for v in r) for r in rows),
          f"{name} stat.dat not finite")
    log(f"  stat.dat: {len(rows)} finite rows; last engTot {rows[-1][2]:.4f}"
        f" eV engKin {rows[-1][3]:.4f} eV engVdW {rows[-1][4]:.4f} eV")
    with open(os.path.join(out, "rdf.dat")) as f:
        gr = [float(ln.split()[1]) for ln in f.readlines()[1:]]
    check(len(gr) == runner.rcfg.n_bin and max(gr) > 0.0,
          f"{name} rdf.dat empty or zero")
    peak = max(range(len(gr)), key=gr.__getitem__)
    log(f"  rdf.dat: {len(gr)} bins, highest g={gr[peak]:.3f} at "
        f"r={(peak + 0.5) * runner.rcfg.d_rdf:.3f} A")
    return runner, launches, rate


def trajectories(torch, load_deck_dir, make_multi_step, name, deck, dev,
                 plain_fn):
    """20 steps with the kernel against 20 with the plain version."""
    runs = []
    for fn in (None, plain_fn):
        d = load_deck_dir(deck, device=dev)
        s = make_multi_step(d["cfg"], d["aux"], pair_fn=fn)(
            d["state"], d["ff"], 20)
        torch.cuda.synchronize()
        runs.append(s)
    dpos = float((runs[0].pos - runs[1].pos).abs().max())
    log(f"{name}, 20 steps kernel vs plain: max|dpos|={dpos:.3e} A "
        f"(limit {TRAJ_POS_ATOL})")
    check(dpos <= TRAJ_POS_ATOL, f"{name}: kernel and plain trajectories "
          "diverge")
    for key in ("kin", "vdw", "tot"):
        a = float(getattr(runs[0].energies, key))
        b = float(getattr(runs[1].energies, key))
        log(f"  E{key}: {a:.6f} vs {b:.6f}")
        check(abs(a - b) <= TRAJ_ENERGY_REL * abs(b) + 1e-6,
              f"{name}: trajectory energy {key} differs")
    return dpos


def profile_steps(torch, load_deck_dir, make_multi_step, deck, dev, n=100):
    """Device busy time and the kernels that take it over ``n`` bare steps
    (no output, no RDF), from torch.profiler; "not measured" when the
    profiler records no device activity on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    d = load_deck_dir(deck, device=dev)
    multi = make_multi_step(d["cfg"], d["aux"])
    state = multi(d["state"], d["ff"], 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        multi(state, d["ff"], n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() * 1e-6
    busy = sum(by_name.values())
    if busy <= 0.0:
        log(f"profile {os.path.basename(deck)}: no device activity "
            "recorded; device idle share not measured")
        return
    log(f"profile {os.path.basename(deck)}, {n} bare steps: wall "
        f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, device "
        f"idle share {1.0 - busy / wall:.3f} (torch.profiler)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {t * 1e3 / n:8.4f} ms/step  {t / busy:6.1%} of busy  "
            f"{name[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="keep the runs' output files here")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "aztotmd_tpu_torch")):
        print("chip_smoke.py: run it from the root of a checkout (no "
              "aztotmd_tpu_torch/ beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = args.out or tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kernels = run(torch.device("cuda", 0), out)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, out):
    """All phases on device ``dev``; returns the kernels' JSON records."""
    import torch
    from aztotmd_tpu_torch import systems
    from aztotmd_tpu_torch.__main__ import main as cli
    from aztotmd_tpu_torch.ops import allpairs, cuda_build, sparse
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    from aztotmd_tpu_torch.runtime.step import make_multi_step

    card = card_line()
    log(card)
    toolchain(torch, cuda_build)
    build_all(cuda_build, ["allpairs", "sparse"])
    counters = {"allpairs": allpairs, "sparse": sparse}

    # --- K1 against its plain version ---
    log("K1 (allpairs) vs plain (forces atol 3e-5*max|F|, energies rel "
        "1e-4):")
    k1 = (allpairs.pair_forces_allpairs, allpairs.pair_forces_allpairs_plain)
    d = load_deck_dir(SURKOV_DECK, device=dev)
    st = d["state"]
    k1_args = (d["cfg"], d["ff"], st.pos, st.types, st.radii)
    k1_err, _ = compare(torch, *k1, "Surkov slice deck (radii)", *k1_args)
    for fam in sorted(systems.FAMILY_PARAMS):
        compare(torch, *k1, f"family {fam}",
                *systems.pair_system(systems.family_specs(fam), device=dev))
    for elec, nm in ((1, "direct"), (2, "Ewald real"), (3, "Fennel")):
        compare(torch, *k1, f"nsp=3 {nm} + radii",
                *systems.pair_system(systems.clustered_specs(
                    nsp=3, elec=elec, radii=True), device=dev))
    for n in (600, 4001, 1):
        compare(torch, *k1, f"ragged N={n}",
                *systems.pair_system(systems.clustered_specs(
                    n_atoms=n, nsp=2, elec=1, radii=True), device=dev))

    # --- K4 against its plain version ---
    log("K4 (sparse) vs plain (forces atol 3e-5*max|F|, energies rel 1e-4,"
        " max_occ exact):")
    k4 = (sparse.pair_forces_sparse, sparse.pair_forces_sparse_plain)
    d = load_deck_dir(NANO_DECK, device=dev)
    st = d["state"]
    check(d["cfg"].pair_engine == "sparse", "nanoclusters not on sparse")
    k4_args = (d["cfg"], d["ff"], st.pos, st.types, None)
    T, n_t, cap = sparse.tile_shape(d["cfg"])
    log(f"  nanoclusters: T={T} n_t={n_t} pair_cap={cap}")
    k4_err, k4_res = compare(torch, *k4, "nanoclusters deck", *k4_args)
    need = int(k4_res.max_occ)
    sp = lambda **kw: systems.pair_system(systems.multi_cluster_specs(**kw),
                                          device=dev, pair_engine="sparse")
    for nsp, elec, nm in ((1, 0, "no Coulomb"), (1, 1, "direct"),
                          (2, 2, "Ewald real"), (3, 3, "Fennel")):
        for radii in (False, True):
            compare(torch, *k4, f"nsp={nsp} {nm}{' + radii' * radii}",
                    *sp(nsp=nsp, elec=elec, radii=radii))
    for n in (1501, 100):
        compare(torch, *k4, f"ragged N={n}",
                *sp(n_atoms=n, n_clusters=min(5, n // 50), nsp=2, elec=1,
                    radii=True))
    _, cut = compare(torch, *k4, f"nanoclusters pair_cap={need // 2}",
                     *k4_args, pair_cap=need // 2)
    S = sparse.sort_tiles(d["cfg"], st.pos, st.types, pair_cap=need // 2)
    empty = S.row_ptr[1:] == S.row_ptr[:-1]
    unvisited = S.perm[empty.repeat_interleave(T)[:d["cfg"].n_at]]
    check(int(cut.max_occ) == need, "truncated max_occ is not the need")
    check(bool(empty.any()) and bool((cut.frc[unvisited] == 0).all()),
          "tiles no entry visits are not exactly zero")
    log(f"  truncated: max_occ {int(cut.max_occ)} == need {need}; "
        f"{int(empty.sum())} unvisited tiles exactly zero")

    # --- each path through the run CLI ---
    runner, l1, surk_rate = drive(cli, torch, counters, "surkov_cluster",
                                  SURKOV_DECK, os.path.join(out, "surkov"),
                                  SLICE_STEPS)
    check(l1 == {"allpairs": runner.steps_run, "sparse": 0},
          "the Surkov run's pair passes did not all go through K1")
    runner, l4, nano_rate = drive(cli, torch, counters, "nanoclusters",
                                  NANO_DECK, os.path.join(out, "nano"),
                                  SLICE_STEPS)
    check(l4 == {"allpairs": 0, "sparse": runner.steps_run},
          "the nanoclusters run's pair passes did not all go through K4")
    log(f"  sparse pair_cap: {cap} at start, {runner.cfg.sparse_pair_cap} "
        f"at end ({'regrown' if runner.cfg.sparse_pair_cap != cap else 'no regrow'}"
        f"); worklist need at the last check {int(runner.state.cell_overflow)}")
    log(f"steps/s on {card}: surkov_cluster {surk_rate:.1f}, nanoclusters "
        f"{nano_rate:.1f}")

    # --- 20 steps with each kernel against 20 with its plain version ---
    trajectories(torch, load_deck_dir, make_multi_step, "surkov_cluster",
                 SURKOV_DECK, dev,
                 lambda c, f, p, t, radii=None: k1[1](c, f, p, t, radii))
    trajectories(torch, load_deck_dir, make_multi_step, "nanoclusters",
                 NANO_DECK, dev,
                 lambda c, f, p, t, radii=None: k4[1](c, f, p, t, radii))

    # --- where a step's time goes (the profiler adds its own cost) ---
    for deck in (SURKOV_DECK, NANO_DECK):
        profile_steps(torch, load_deck_dir, make_multi_step, deck, dev)

    # --- timing at the paths' sizes: wrapper, kernel alone, plain ---
    cfg1 = k1_args[0]
    tab1 = allpairs.kernel_tables(cfg1, k1_args[1], dev)
    ms1, alone1, plain1 = timed(torch, [
        lambda: k1[0](*k1_args),
        lambda: allpairs.launch(cfg1, *tab1, *k1_args[2:]),
        lambda: k1[1](*k1_args)])
    cfg4 = k4_args[0]
    tab4 = allpairs.kernel_tables(cfg4, k4_args[1], dev)
    S4 = sparse.sort_tiles(cfg4, *k4_args[2:])
    ms4, alone4, plain4 = timed(torch, [
        lambda: k4[0](*k4_args),
        lambda: sparse.launch(cfg4, *tab4, S4),
        lambda: k4[1](*k4_args)])
    for nm, n, a, b, c in (("K1", cfg1.n_at, ms1, alone1, plain1),
                           ("K4", cfg4.n_at, ms4, alone4, plain4)):
        log(f"timing {nm} N={n}: wrapper {a:.4f} ms, kernel alone {b:.4f} "
            f"ms, plain {c:.4f} ms per call (medians of 20, CUDA events) "
            f"on {card}")

    # --- bounds from this run's inputs ---
    pairs1 = pairs_in_range(torch, cfg1, k1_args[2])
    b1 = bound(cfg1.n_at * (cfg1.n_at - 1), pairs1, "surk",
               cfg1.n_at * (12 + 4 + 4 + 12) + 8)
    pairs4 = pairs_in_range(torch, cfg4, k4_args[2])
    slots4 = need * T * T
    b4 = bound(slots4, pairs4, "lnjs",
               n_t * T * 6 * 4 + (n_t + 1 + cap) * 4 + cfg4.n_at * 12 + 8)
    log(f"bound K1: {cfg1.n_at * (cfg1.n_at - 1)} slot pairs, {pairs1} in "
        f"range: {b1[0]:.4f} ms ({b1[2]}); computed from the operation "
        "count of csrc/pair_physics.cuh, not from a counter")
    log(f"bound K4: {need} tile pairs x {T}^2 = {slots4} slot pairs, "
        f"{pairs4} in range: {b4[0]:.4f} ms ({b4[2]}); computed from the "
        "operation count of csrc/pair_physics.cuh, not from a counter")

    return [
        {"name": "allpairs", "route": "cuda",
         "source": "aztotmd_tpu_torch/csrc/allpairs.cu",
         "replaces": "aztotmd_tpu/ops/pallas_pair.py:335",
         "launches": l1["allpairs"], "max_abs_err": k1_err,
         "ms": ms1, "kernel_ms": alone1, "plain_ms": plain1,
         "bound_ms": b1[0], "bound_by": b1[1], "library_ms": None},
        {"name": "sparse", "route": "cuda",
         "source": "aztotmd_tpu_torch/csrc/sparse.cu",
         "replaces": "aztotmd_tpu/ops/pallas_sparse.py:129",
         "launches": l4["sparse"], "max_abs_err": k4_err,
         "ms": ms4, "kernel_ms": alone4, "plain_ms": plain4,
         "bound_ms": b4[0], "bound_by": b4[1], "library_ms": None}]


if __name__ == "__main__":
    sys.exit(main())
