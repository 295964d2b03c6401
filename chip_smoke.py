#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (aztotmd_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout.  It builds the port's CUDA kernels
(csrc/allpairs.cu: K1 and K1-cand, the dense pass without and with the
fused bind/jump candidates; csrc/sparse.cu: K4 and K4-cand, the Morton
block-sparse pass; csrc/cellblock.cu: K3, the stacked cell-block pass;
csrc/allpairs_rect.cu: K2, the rectangular pass of the slab-decomposed
step) for sm_90a from the checkout, one nvcc each, in parallel, and then,
for each kernel, checks it against its plain PyTorch version on the card:
  K2, the rectangular pass: the slab states of examples/surkov_cluster
      over 2 slabs (2 x 3,208 x 6,416 slots) and examples/nanoclusters
      over 4 (4 x 5,024 x 15,072), and synthetic slabs with a fifth of
      the slots empty, 1-3 species, direct/Ewald/Fennel, radii, one and
      three slabs a launch;
  K1, the dense pair pass: the Surkov slice deck's 4,000-atom state,
      every VdW family, three species with direct/Ewald/Fennel Coulomb
      and radii, ragged N;
  K4, the Morton block-sparse pass: the nanoclusters deck's 12,000-atom
      state (T=256, pair_cap 1,536), multi-cluster systems with 1-3
      species, direct/Ewald/Fennel and radii, ragged N (N not a multiple
      of T, and N < T) and a truncated worklist (max_occ equal, tiles no
      entry visits exactly zero);
  K3, the stacked cell-block pass: the liquid_argon deck's 32,768-atom
      state (13^3 cells of 46 slots), two species with Fennel Coulomb,
      Surkov with radii, and a capacity below the fullest cell (dropped
      atoms get zero force on both sides, max_occ equal);
  K1-cand: the reactive_polymer state after 300 plain steps (parents
      set), the ejump_redox state, the three-species bind + jump system
      with direct Coulomb, ragged N;
  K4-cand: reactive_polymer and ejump_redox tiled 3x3x3 (13,824 and
      9,504 atoms) on the sparse engine;
  every <BIND, JUMP, PAR> instantiation of K1 and K4 on an unjittered
      2 A lattice, whose exact distances make candidates tie in r2;
the candidate ids equal, their r2 bitwise equal, max_occ equal.  The
build logs each kernel instantiation's registers, static shared memory
and spills (ptxas -v).
It drives each kernel's path, with every launch count set to 0 just
before and read just after: through the ``run`` CLI
examples/surkov_cluster (K1), examples/nanoclusters (K4, Nose-Hoover,
cell-list RDF), examples/reactive_polymer and examples/ejump_redox
(K1-cand: bonds form, break and mutate; electrons jump) and
examples/molten_salt (K1 plus the Ewald reciprocal sum), and through
the runner the two tiled decks on the sparse engine (K4-cand) and
examples/liquid_argon on the pallas engine (K3); liquid_argon also runs
through the CLI on "auto", the cell-block engine in torch ops.  The
slab-decomposed step runs through ``run --mesh N`` on the one card (all
slabs batched in one process): examples/surkov_cluster over 2 slabs and
examples/nanoclusters over 4 (K2, every pair pass), examples/liquid_argon
over 4 (the slab stencil pass in torch ops); no atom may be lost to a
migration; 20 mesh steps are held against 20 one-device kernel steps
(K1, K4) with the JAX package's slab bounds, and 50 bare mesh steps are
profiled.  With two or more cards it also runs the slabs one per process
over NCCL.  It
checks that every pair pass went through that path's kernel, that
stat.dat is finite and rdf.dat non-zero, that bonds and jumps happened
(stat_bnd.dat, jumps.dat) and revbonds.txt and lengths.dat were
written.  It compares 20 steps with each kernel against 20 steps with
its plain version (the reactive decks' topology and RNG words exactly),
profiles bare steps of each deck, and times the kernels, their
wrappers and plain versions at the paths' sizes with CUDA events and
each kernel alone with torch.profiler, beside a lower bound computed
from an operation count read off csrc/pair_physics.cuh; it logs K1's
and K4's launch plans (splits, blocks, dynamic shared memory) and the
sub-tile pairs that K4's warp cull kept, as the kernel records them
(held exactly against sparse.subtile_keep); K4's bound counts the
filled slot pairs in them.  Any failure exits non-zero.
The last line of standard output is {"ok": true, "device": {...}}; the
line before it lists the kernels with their launches, errors, times and
bounds.  The runs' output files go to --out (default: a temporary
directory that is removed).
"""

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SURKOV_DECK = os.path.join(HERE, "examples", "surkov_cluster")
NANO_DECK = os.path.join(HERE, "examples", "nanoclusters")
POLY_DECK = os.path.join(HERE, "examples", "reactive_polymer")
EJUMP_DECK = os.path.join(HERE, "examples", "ejump_redox")
ARGON_DECK = os.path.join(HERE, "examples", "liquid_argon")
SALT_DECK = os.path.join(HERE, "examples", "molten_salt")
SLICE_STEPS = 1000       # the four decks of the earlier slices
NEW_STEPS = 2000         # liquid_argon on K3, molten_salt
MESH_STEPS = {"surkov_cluster": 1000, "nanoclusters": 500,
              "liquid_argon": 200}
MESH_DEV = {"surkov_cluster": 2, "nanoclusters": 4, "liquid_argon": 4}
# the JAX package's slab-vs-single-chip bounds (tests/test_parallel.py)
MESH_POS_ATOL = 5e-4     # A after 20 steps
MESH_VEL_ATOL = 1e-4     # x max|v|
TILED_STEPS = 200        # the 3x3x3 tiled reactive decks (K4-cand), and
                         # liquid_argon on the torch cell-block engine
PROFILE_STEPS = 50
FORCE_ATOL = 3e-5        # x max|F|: f32 sums in another order
ENERGY_REL = 1e-4
TRAJ_POS_ATOL = 1e-4     # A after 20 steps, f32
TRAJ_ENERGY_REL = 1e-4
# the kernels' <BIND, JUMP, PAR> template instantiations
INSTANCES = [(False, False, False), (True, True, True), (True, True, False),
             (True, False, True), (True, False, False), (False, True, False)]
TOPOLOGY = ("types", "bond_at1", "bond_at2", "bond_type", "n_bond",
            "n_jump", "rng", "parents")

# Peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet; the MUFU
# rate is 16 results per clock per SM for compute capability 9.0 at the
# 1.98 GHz boost clock, CUDA C++ Programming Guide throughput table).
PEAK_FP32 = 67e12        # FLOP/s outside the tensor cores
PEAK_MUFU = 132 * 16 * 1.98e9
PEAK_BYTES = 3.35e12     # HBM3 bytes/s
# FP32 operations (an FMA counts 2) read off csrc/pair_physics.cuh:
# every slot pair: displacement, min-image (mul, rint, fma) per axis, r2
# and the cutoff test; a pair in range: r2i, rr, r2cut test, clip, energy
# and force accumulation, plus the family's own terms (Buckingham with
# direct Coulomb for ejump_redox); MUFU: the rsqrt, the reciprocals and
# Buckingham's exp.  A candidate pass adds, per pair in range, the key
# arithmetic and the compares of cand_pair/cand_update, counted at the
# FP32 issue rate.
OPS_SLOT = 21
# K3 shifts the neighbor cells by the periodic image when it stages them,
# so a slot pair costs the displacement, r2 and the cutoff test only
OPS_SLOT_SHIFTED = 9
OPS_PAIR = {"lnjs": 24, "surk": 40, "buck+dir": 36, "bmhs+ewald": 62}
MUFU_PAIR = {"lnjs": 1, "surk": 2, "buck+dir": 3, "bmhs+ewald": 4}
OPS_CAND = 10


_T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name):
    """A phase header with the seconds since the script started."""
    log(f"[{time.perf_counter() - _T0:6.1f} s] {name}")


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


def kernel_name(mangled):
    """``allpairs_kernel<1,0,1>`` from a mangled entry name: its last
    length-prefixed name and its bool template arguments."""
    at, name = mangled.find("N") + 1, mangled
    while at and at < len(mangled) and mangled[at].isdigit():
        m = re.match(r"\d+", mangled[at:])
        n = int(m.group())
        name = mangled[at + m.end():at + m.end() + n]
        at += m.end() + n
    args = re.match(r"I((?:Lb[01]E)+)E", mangled[at:]) if at else None
    return name + (f"<{','.join(re.findall(r'Lb([01])E', args.group(1)))}>"
                   if args else "")


def build_all(cuda_build, names):
    """One nvcc per source, all started together; logs each kernel's
    registers, static shared memory and spills from ``-Xptxas -v``."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(cuda_build.build, names)))
    for name in names:
        so, secs = built[name]
        log(f"build: {os.path.relpath(so, HERE)} in {secs:.1f} s")
        with open(so[:-3] + ".log") as f:
            text = f.read()
        for fn, body in re.findall(
                r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry"
                r" function|\Z)", text, re.S):
            regs = re.search(r"Used (\d+) registers", body)
            smem = re.search(r"(\d+) bytes smem", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", body)
            log(f"  ptxas {kernel_name(fn)}: "
                f"{regs.group(1) if regs else '?'} registers, "
                f"{smem.group(1) if smem else 0} bytes static shared memory"
                f" a block, spill stores/loads "
                f"{spill.group(1) + '/' + spill.group(2) if spill else '?'}"
                " bytes")


def compare(torch, kernel, plain, name, cfg, ff, pos, types, radii, **kw):
    """Kernel against plain on the card; returns the max abs force error
    and the kernel's result.  With candidates (``want_bind``/``want_jump``
    in ``kw``) their ids must be equal and their r2 bitwise equal."""
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
    cand = ""
    if kw.get("want_bind") or kw.get("want_jump"):
        same = all(torch.equal(getattr(k, a), getattr(p, a)) for a in
                   ("bind_idx", "bind_r2", "jump_idx", "jump_r2"))
        ok = ok and same
        cand = (f"  bind {int((k.bind_idx < cfg.n_at).sum())} jump "
                f"{int((k.jump_idx < cfg.n_at).sum())} candidates "
                f"{'equal' if same else 'DIFFER'}")
    log(f"  {name:34s} N={cfg.n_at:5d}  max|dF|={err:.3e} "
        f"(limit {FORCE_ATOL * max(scale, 1.0):.3e})  "
        f"Evdw {ev:.6f} vs {pv:.6f}  Ecoul {ec:.6f} vs {pc:.6f}  "
        f"max_occ {ko} vs {po}{cand}  {'ok' if ok else 'FAIL'}")
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


def timed(torch, fns, n=10):
    """Medians (ms) of each callable, warmed, in turns a, b, b, a, with
    ``n`` calls of each per turn."""
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for order in (range(len(fns)), reversed(range(len(fns)))):
        for i in order:
            times[i] += time_calls(torch, fns[i], n)
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


def bound(slot_pairs, pairs, fam, nbytes, cand=False):
    """(bound_ms, bound_by, detail) from this run's counts."""
    fp32 = (slot_pairs * OPS_SLOT + pairs * (OPS_PAIR[fam]
                                             + (OPS_CAND if cand else 0))
            ) / PEAK_FP32
    mufu = pairs * MUFU_PAIR[fam] / PEAK_MUFU
    return bound_of(fp32, mufu, nbytes)


def bound_of(fp32, mufu, nbytes):
    """(bound_ms, bound_by, detail) of FP32 seconds, MUFU seconds and the
    bytes moved."""
    t_bytes = nbytes / PEAK_BYTES
    detail = (f"FP32 {fp32 * 1e3:.4g} ms, MUFU {mufu * 1e3:.4g} ms, "
              f"bytes {t_bytes * 1e3:.4g} ms")
    which = "operations" if max(fp32, mufu) >= t_bytes else "bytes"
    return max(fp32, mufu, t_bytes) * 1e3, which, detail


def read_table(path, skip):
    with open(path) as f:
        return [[float(v) for v in ln.split()] for ln in f.readlines()[skip:]]


def drive(cli, counters, name, deck, out, steps, runner_fn=None, mesh=0):
    """One path through the run CLI (``--mesh mesh`` when set; or
    ``runner_fn(out)``, which runs and returns an MDRunner) with every
    launch count set to 0 just before it; returns (runner, launches per
    kernel, steps/s)."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    if runner_fn is None:
        runner = cli(["run", deck, "--steps", str(steps), "-o", out,
                      "--quiet"] + (["--mesh", str(mesh)] if mesh else []))
    else:
        runner = runner_fn(out)
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    rate = runner.steps_run / runner.loop_seconds
    log(f"{name} run: {runner.steps_run} steps of {runner.cfg.n_at} atoms "
        f"in {runner.loop_seconds:.2f} s loop ({wall:.2f} s with setup): "
        f"{rate:.1f} steps/s")
    log(f"  kernel launches {launches}, pair-force evaluations "
        f"{runner.steps_run}")
    check(runner.steps_run == steps, f"{name} run stopped early")
    if mesh:
        lost = int(runner.state.mig_lost)
        log(f"  slabs {mesh}, slot capacity {runner.state.pos.shape[1]}: "
            f"{int(runner.state.mig_total)} atoms migrated, {lost} lost, "
            f"{int(runner.state.mig_defer)} sends deferred; fullest cell "
            f"{int(runner.state.slab_occ)} of cap {runner.cfg.grid.cap}")
        check(lost == 0, f"{name}: a migration deleted atoms")
    rows = read_table(os.path.join(out, "stat.dat"), 2)
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
    cfg = runner.cfg
    if cfg.use_bnd:
        bnd = read_table(os.path.join(out, "stat_bnd.dat"), 1)
        check(len(bnd) == len(rows) and bnd[-1][2] > 0,
              f"{name} stat_bnd.dat shows no bonds")
        with open(os.path.join(out, "revbonds.txt")) as f:
            n_list = int(f.readline())
        check(n_list == int(runner.state.n_bond) and os.path.getsize(
            os.path.join(out, "lengths.dat")) > 0,
            f"{name} revbonds.txt / lengths.dat not written")
        log(f"  stat_bnd.dat: n_bond {int(bnd[-1][2])} at the end, "
            f"{int(runner.state.bt_lt_count.sum())} bonds broken or "
            f"mutated; revbonds.txt lists {n_list}")
    if cfg.ejtype:
        jmp = read_table(os.path.join(out, "jumps.dat"), 1)
        check(len(jmp) == len(rows) and jmp[-1][2] > 0,
              f"{name} jumps.dat shows no jumps")
        log(f"  jumps.dat: n_jump {int(jmp[-1][2])} (pos {int(jmp[-1][3])},"
            f" neg {int(jmp[-1][4])})")
    return runner, launches, rate


def trajectories(torch, load_deck_dir, make_multi_step, name, deck, dev,
                 plain_fn, **load_kw):
    """20 steps with the kernel against 20 with the plain version; the
    reactive topology and RNG words must be equal."""
    runs = []
    for fn in (None, plain_fn):
        d = load_deck_dir(deck, device=dev, **load_kw)
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
    if d["cfg"].use_bnd or d["cfg"].ejtype:
        for key in TOPOLOGY:
            check(torch.equal(getattr(runs[0], key), getattr(runs[1], key)),
                  f"{name}: {key} differs between kernel and plain steps")
        log(f"  topology equal: n_bond {int(runs[0].n_bond)}, n_jump "
            f"{int(runs[0].n_jump)}, rng words equal")
    return dpos


def mesh_system(load_deck_dir, deck, n_dev, dev):
    """(cfg, ff, aux, comm, slab state) of a deck over n_dev slabs on the
    one card."""
    from aztotmd_tpu_torch.parallel import LocalRing, slab
    d = load_deck_dir(deck, device=dev)
    cfg = slab.prepare_slab_cfg(d["cfg"], n_dev)
    comm = LocalRing(n_dev, dev)
    return cfg, d["ff"], d["aux"], comm, slab.make_slab_state(
        cfg, d["state"], comm)


def profile_steps(torch, load_deck_dir, make_multi_step, deck, dev,
                  n=PROFILE_STEPS, mesh=0, **load_kw):
    """Device busy time and the kernels that take it over ``n`` bare steps
    (no output, no RDF; over ``mesh`` slabs when set), from
    torch.profiler; "not measured" when the profiler records no device
    activity on this machine.  Returns the device seconds per step by
    kernel name, or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if mesh:
        from aztotmd_tpu_torch.parallel import slab
        cfg, ff, aux, comm, st = mesh_system(load_deck_dir, deck, mesh, dev)
        multi = slab.make_slab_multi_step(cfg, aux, comm)
        d = {"ff": ff}
        state = multi(st, ff, 10)
    else:
        d = load_deck_dir(deck, device=dev, **load_kw)
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
    tag = os.path.basename(deck) + (f" over {mesh} slabs" if mesh else "")
    if busy <= 0.0:
        log(f"profile {tag}: no device activity recorded; device idle "
            "share not measured")
        return None
    log(f"profile {tag}, {n} bare steps: wall {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / n:.3f} ms/step), device busy {busy * 1e3:.1f} ms, "
        f"device idle share {1.0 - busy / wall:.3f}, {len(prof.events())} "
        "events (torch.profiler)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {t * 1e3 / n:8.4f} ms/step  {t / busy:6.1%} of busy  "
            f"{name[:90]}")
    return {k: v / n for k, v in by_name.items()}


def random_parents(torch, n, dev, seed=7):
    """Parents for 40% of n atoms, partners drawn from a seeded
    generator (the parent test of the bind candidates)."""
    g = torch.Generator().manual_seed(seed)
    par = torch.randint(0, n, (n,), generator=g, dtype=torch.int32)
    keep = torch.rand(n, generator=g) < 0.4
    return torch.where(keep, par, -1).to(dev)


def rect_args(slab, cfg, comm, st):
    """K2's arguments on a slab state: (args, kwargs) of
    pair_forces_allpairs_rect, as the dense slab pass builds them."""
    a = slab.dense_pass_inputs(cfg, comm, {k: getattr(st, k) for k in
                                           slab.PER_SLOT}, st.gid >= 0)
    return a[:6], dict(radii_i=a[6], radii_j=a[7])


def rect_pairs(torch, cfg, args, rows=1024):
    """(valid slot pairs, valid ordered pairs in range) of K2's inputs,
    counted on the card: the pairs of filled slots, self slot excluded,
    that the function needs, and those that take the physics branch."""
    pos_i, _, valid_i, pos_j, _, valid_j = args
    box = torch.tensor(cfg.box, dtype=pos_i.dtype, device=pos_i.device)
    slots = inr = 0
    for s in range(pos_i.shape[0]):
        nv_j = int(valid_j[s].sum())
        nv_i = int(valid_i[s].sum())
        slots += nv_i * nv_j - nv_i
        pj = pos_j[s][valid_j[s]]
        pi = pos_i[s][valid_i[s]]
        for i0 in range(0, pi.shape[0], rows):
            d = pi[i0:i0 + rows, None, :] - pj[None, :, :]
            d = d - box * torch.round(d / box)
            inr += int(((d * d).sum(-1) <= cfg.r2_max).sum())
        inr -= nv_i                          # the self pairs have r2 = 0
    return slots, inr


def mesh_trajectory(torch, load_deck_dir, make_multi_step, name, deck,
                    n_dev, dev):
    """20 steps over n_dev slabs (K2) against 20 one-device steps (the
    deck's kernel): positions atol 5e-4 A, velocities atol 1e-4*max|v|,
    the bounds of the JAX package's slab-vs-single-chip tests."""
    from aztotmd_tpu_torch.parallel import slab
    cfg, ff, aux, comm, st = mesh_system(load_deck_dir, deck, n_dev, dev)
    st = slab.make_slab_multi_step(cfg, aux, comm)(st, ff, 20)
    g = slab.gather_state(st, cfg.n_at, comm)
    d = load_deck_dir(deck, device=dev)
    one = make_multi_step(d["cfg"], d["aux"])(d["state"], d["ff"], 20)
    torch.cuda.synchronize()
    pos, vel = one.pos.cpu().numpy(), one.vel.cpu().numpy()
    dpos = float(abs(g["pos"] - pos).max())
    dvel = float(abs(g["vel"] - vel).max())
    vmax = float(abs(vel).max())
    log(f"{name} over {n_dev} slabs vs one device, 20 steps: max|dpos|="
        f"{dpos:.3e} A (limit {MESH_POS_ATOL}), max|dvel|={dvel:.3e} "
        f"(limit {MESH_VEL_ATOL * vmax:.3e}); Evdw "
        f"{float(st.energies.vdw):.6f} vs {float(one.energies.vdw):.6f}; "
        f"{int(st.mig_total)} migrated, {int(st.mig_lost)} lost")
    check(dpos <= MESH_POS_ATOL and dvel <= MESH_VEL_ATOL * vmax
          and int(st.mig_lost) == 0,
          f"{name}: mesh and one-device trajectories diverge")
    return dpos


def dist_phase(out):
    """The slabs one per process over NCCL (``run --mesh N --dist`` under
    torchrun) on surkov_cluster, when the machine has N >= 2 cards; its
    stat.dat must be finite.  Returns a status line."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        return (f"NCCL DistRing phase not run: {n} card on this machine "
                "(it needs two or more)")
    n = 2
    o = os.path.join(out, "surkov_dist")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "aztotmd_tpu_torch", "run",
           SURKOV_DECK, "--mesh", str(n), "--dist", "--steps", "200", "-o",
           o, "--quiet"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=HERE)
    check(res.returncode == 0, f"NCCL DistRing run failed:\n{res.stderr}")
    rows = read_table(os.path.join(o, "stat.dat"), 2)
    check(rows and all(all(v == v for v in r) for r in rows),
          "NCCL DistRing stat.dat not finite")
    return (f"NCCL DistRing: surkov_cluster over {n} processes, 200 steps "
            f"in {time.perf_counter() - t0:.1f} s, {len(rows)} finite rows")


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


def plain_pair(fn):
    """A step's pair_fn that runs the plain version ``fn``."""
    return lambda c, f, p, t, radii=None, **kw: fn(c, f, p, t, radii, **kw)


def run(dev, out):
    """All phases on device ``dev``; returns the kernels' JSON records."""
    import torch
    from aztotmd_tpu_torch import systems
    from aztotmd_tpu_torch.__main__ import main as cli
    from aztotmd_tpu_torch.ops import allpairs, cellblock, cuda_build, sparse
    from aztotmd_tpu_torch.ops.elec import ewald_recip
    from aztotmd_tpu_torch.parallel import slab
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    from aztotmd_tpu_torch.runtime.step import make_multi_step

    card = card_line()
    log(card)
    toolchain(torch, cuda_build)
    build_all(cuda_build, ["allpairs", "sparse", "cellblock",
                           "allpairs_rect"])
    counters = {"allpairs": (allpairs, "launches"),
                "allpairs_cand": (allpairs, "cand_launches"),
                "sparse": (sparse, "launches"),
                "sparse_cand": (sparse, "cand_launches"),
                "cellblock": (cellblock, "launches"),
                "allpairs_rect": (allpairs, "rect_launches")}

    # --- K1 against its plain version ---
    phase("K1 (allpairs) vs plain (forces atol 3e-5*max|F|, energies rel "
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

    # --- K1-cand against its plain version ---
    phase("K1-cand (allpairs, bind/jump candidates) vs plain (forces atol "
        "3e-5*max|F|, energies rel 1e-4, candidate ids equal, r2 bitwise "
        "equal):")
    d = load_deck_dir(POLY_DECK, device=dev)
    st = make_multi_step(d["cfg"], d["aux"], pair_fn=plain_pair(k1[1]))(
        d["state"], d["ff"], 300)
    check(int((st.parents >= 0).sum()) > 0, "no parents after 300 steps")
    log(f"  reactive_polymer after 300 plain steps: n_bond "
        f"{int(st.n_bond)}, {int((st.parents >= 0).sum())} atoms with a "
        "parent")
    k1c_poly = (d["cfg"], d["ff"], st.pos, st.types, None)
    k1c_poly_kw = dict(parents=st.parents, want_bind=True)
    k1c_err, _ = compare(torch, *k1, "reactive_polymer (bind, parents)",
                         *k1c_poly, **k1c_poly_kw)
    d = load_deck_dir(EJUMP_DECK, device=dev)
    st = d["state"]
    k1c_ej = (d["cfg"], d["ff"], st.pos, st.types, None)
    k1c_ej_kw = dict(parents=st.parents, want_jump=True)
    compare(torch, *k1, "ejump_redox (jump, direct Coulomb)", *k1c_ej,
            **k1c_ej_kw)
    for n, nm in ((1000, "nsp=3 bind + jump, direct"),
                  (777, "ragged N=777 bind + jump")):
        cfg, ff, pos, types, _ = systems.pair_system(
            systems.reactive_specs(n), device=dev)
        compare(torch, *k1, nm, cfg, ff, pos, types, None,
                parents=random_parents(torch, n, dev), want_bind=True,
                want_jump=True)

    # --- K4 against its plain version ---
    phase("K4 (sparse) vs plain (forces atol 3e-5*max|F|, energies rel "
          "1e-4, max_occ exact):")
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

    # --- K4-cand against its plain version, on the 3x3x3 tiled decks ---
    phase("K4-cand (sparse, bind/jump candidates) vs plain on the decks "
        "3x3x3 (same limits, max_occ exact):")
    tiled = {}
    for deck, nm in ((POLY_DECK, "reactive_polymer"),
                     (EJUMP_DECK, "ejump_redox")):
        tiled[nm] = os.path.join(out, f"{nm}_x3")
        systems.tile_deck(deck, tiled[nm], 3)
    d = load_deck_dir(tiled["reactive_polymer"], device=dev,
                      pair_engine="sparse")
    st = d["state"]
    n = d["cfg"].n_at
    k4c_poly = (d["cfg"], d["ff"], st.pos, st.types, None)
    k4c_poly_kw = dict(parents=random_parents(torch, n, dev),
                       want_bind=True)
    k4c_err, k4c_res = compare(
        torch, *k4, "reactive_polymer x3 (bind, random parents)",
        *k4c_poly, **k4c_poly_kw)
    d = load_deck_dir(tiled["ejump_redox"], device=dev, pair_engine="sparse")
    st = d["state"]
    k4c_ej = (d["cfg"], d["ff"], st.pos, st.types, None)
    k4c_ej_kw = dict(parents=st.parents, want_jump=True)
    compare(torch, *k4, "ejump_redox x3 (jump, direct Coulomb)", *k4c_ej,
            **k4c_ej_kw)

    # --- every <BIND, JUMP, PAR> instantiation, with equal-r2 ties ---
    phase("every <BIND, JUMP, PAR> instantiation of K1 and K4 vs plain on "
          "an unjittered 2 A lattice (exact distances: r2 ties, so the key "
          "decides; ids equal, r2 bitwise equal):")
    n = 1000
    for engine, fns, nm in (("pallas", k1, "K1"), ("sparse", k4, "K4")):
        cfg, ff, pos, types, _ = systems.pair_system(
            systems.reactive_specs(n, spacing=2.0, jitter=0.0), device=dev,
            pair_engine=engine)
        for bind, jump, par in INSTANCES:
            compare(torch, *fns, f"{nm}<{int(bind)},{int(jump)},{int(par)}>"
                    " lattice", cfg, ff, pos, types, None,
                    parents=random_parents(torch, n, dev) if par else None,
                    want_bind=bind, want_jump=jump)

    # --- K3 against its plain version ---
    phase("K3 (cellblock, stacked pass) vs plain (forces atol "
          "3e-5*max|F|, energies rel 1e-4, max_occ exact):")
    k3 = (cellblock.pair_forces_stacked, cellblock.pair_forces_stacked_plain)
    d = load_deck_dir(ARGON_DECK, device=dev, pair_engine="pallas")
    st = d["state"]
    g = d["cfg"].grid
    check(allpairs.pallas_branch(d["cfg"], torch.float32) == "stacked",
          "liquid_argon on the pallas engine does not take the stacked pass")
    log(f"  liquid_argon: grid {g.dims} cap {g.cap}, "
        f"{len(cellblock.full_stencil(g))} cells a block, half-stencil slot "
        f"pairs {14 * g.cap * g.cap * g.n_cell}")
    k3_args = (d["cfg"], d["ff"], st.pos, st.types, None)
    k3_err, k3_res = compare(torch, *k3, "liquid_argon deck", *k3_args)
    fluid = lambda **kw: systems.pair_system(
        systems.liquid_argon_specs(**kw), device=dev)
    compare(torch, *k3, "nsp=2 Fennel", *fluid(nsp=2, elec=3))
    compare(torch, *k3, "nsp=3 Ewald real + radii",
            *fluid(nsp=3, elec=2, radii=True))
    compare(torch, *k3, "Surkov + radii", *fluid(radii=True))
    compare(torch, *k3, "ragged N=5000, rcut 8.5",
            *fluid(n_atoms=5000, density=0.021, rcut=8.5))
    occ = int(k3_res.max_occ)
    small = dataclasses.replace(d["cfg"], grid=dataclasses.replace(
        g, cap=occ - 4))
    _, cut = compare(torch, *k3, f"liquid_argon cap={occ - 4} < {occ}",
                     small, *k3_args[1:])
    dropped = cellblock.cell_table(small, st.pos, st.types)["slot_of_atom"] \
        == small.grid.n_cell * small.grid.cap
    check(int(cut.max_occ) == occ and int(dropped.sum()) > 0
          and bool((cut.frc[dropped] == 0).all())
          and bool((cut.frc[~dropped] != 0).any(1).all()),
          "atoms past the capacity are not exactly the zero-force atoms")
    log(f"  over capacity: max_occ {int(cut.max_occ)}, "
        f"{int(dropped.sum())} dropped atoms with exactly zero force")

    # --- K2 against its plain version ---
    phase("K2 (allpairs_rect, the slab step's dense pass) vs plain (forces "
          "atol 3e-5*max|F|, energies rel 1e-4 per slab):")

    def compare_rect(name, cfg, ff, args, kw):
        k = allpairs.pair_forces_allpairs_rect(cfg, ff, *args, **kw)
        p = allpairs.pair_forces_allpairs_rect_plain(cfg, ff, *args, **kw)
        torch.cuda.synchronize()
        err = float((k[0] - p[0]).abs().max())
        scale = float(p[0].abs().max())
        e_ok = all(bool(((a - b).abs() <= ENERGY_REL * b.abs() + 1e-6).all())
                   for a, b in ((k[1], p[1]), (k[2], p[2])))
        empty_zero = bool((k[0][~args[2]] == 0).all())
        ok = err <= FORCE_ATOL * max(scale, 1.0) and e_ok and empty_zero
        L, ni = args[0].shape[:2]
        log(f"  {name:34s} {L} x {ni} x {args[3].shape[1]}  max|dF|="
            f"{err:.3e} (limit {FORCE_ATOL * max(scale, 1.0):.3e})  Evdw "
            f"{[round(v, 4) for v in k[1].tolist()]} vs "
            f"{[round(v, 4) for v in p[1].tolist()]}  Ecoul "
            f"{float(k[2].sum()):.6f} vs {float(p[2].sum()):.6f}  empty i "
            f"slots zero: {empty_zero}  {'ok' if ok else 'FAIL'}")
        check(ok, f"K2 disagrees with its plain version: {name}")
        return err

    k2_in = {}
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK)):
        n_dev = MESH_DEV[nm]
        cfg, ff, _, comm, st = mesh_system(load_deck_dir, deck, n_dev, dev)
        occ = (st.gid >= 0).sum(1).tolist()
        log(f"  {nm} over {n_dev} slabs: grid {cfg.grid.dims} cap "
            f"{cfg.grid.cap}, slot capacity {st.pos.shape[1]}, atoms a "
            f"slab {occ}")
        k2_in[nm] = (cfg, ff) + rect_args(slab, cfg, comm, st)
    k2_err = compare_rect("surkov_cluster over 2 slabs (radii)",
                          *k2_in["surkov_cluster"])
    compare_rect("nanoclusters over 4 slabs", *k2_in["nanoclusters"])
    for case in (dict(nsp=1, elec=0), dict(nsp=2, elec=1),
                 dict(nsp=3, elec=2), dict(nsp=3, elec=3, radii=True)):
        for n_i, n_slab in ((700, 1), (333, 3)):
            nm = ("nsp={nsp} elec={elec}".format(**case)
                  + " + radii" * bool(case.get("radii"))
                  + f", {n_slab} slab{'s' * (n_slab > 1)}")
            compare_rect(nm, *systems.rect_system(systems.clustered_specs(
                n_atoms=1000, **case), n_i, n_slab=n_slab, device=dev))

    # --- each path, counts set to 0 just before and read just after ---
    phase("the decks' paths")
    runs = {}
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK),
                     ("reactive_polymer", POLY_DECK),
                     ("ejump_redox", EJUMP_DECK)):
        runs[nm] = drive(cli, counters, nm, deck, os.path.join(out, nm),
                         SLICE_STEPS)

    def sparse_run(deck):
        def go(o):
            r = MDRunner(load_deck_dir(deck, device=dev,
                                       pair_engine="sparse"),
                         out_dir=o, quiet=True)
            r.run(TILED_STEPS)
            r.finalize()
            return r
        return go

    for nm in ("reactive_polymer", "ejump_redox"):
        runs[nm + "_x3"] = drive(
            cli, counters, f"{nm} x3 (sparse engine)", None,
            os.path.join(out, nm + "_x3_run"), TILED_STEPS,
            runner_fn=sparse_run(tiled[nm]))
    def argon_k3(o):
        r = MDRunner(load_deck_dir(ARGON_DECK, device=dev,
                                   pair_engine="pallas"),
                     out_dir=o, quiet=True)
        r.run(NEW_STEPS)
        r.finalize()
        return r

    runs["liquid_argon"] = drive(
        cli, counters, "liquid_argon (pallas engine, K3)", None,
        os.path.join(out, "liquid_argon"), NEW_STEPS, runner_fn=argon_k3)
    runs["liquid_argon_block"] = drive(
        cli, counters, "liquid_argon (auto: torch cell-block engine)",
        ARGON_DECK, os.path.join(out, "liquid_argon_block"), TILED_STEPS)
    check(runs["liquid_argon_block"][0].cfg.pair_engine == "block",
          "liquid_argon is not auto-selected to the block engine")
    runs["molten_salt"] = drive(cli, counters, "molten_salt", SALT_DECK,
                                os.path.join(out, "molten_salt"), NEW_STEPS)
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK),
                     ("liquid_argon", ARGON_DECK)):
        runs[nm + "_mesh"] = drive(
            cli, counters, f"{nm} --mesh {MESH_DEV[nm]}", deck,
            os.path.join(out, nm + "_mesh"), MESH_STEPS[nm],
            mesh=MESH_DEV[nm])
    check(runs["liquid_argon_mesh"][0].cfg.pair_engine == "block",
          "liquid_argon --mesh 4 does not take the slab stencil pass")
    c2 = [r[6] for r in read_table(os.path.join(out, "molten_salt",
                                                "stat.dat"), 2)]
    check(all(v == v and abs(v) < 1e30 and v != 0.0 for v in c2),
          "molten_salt coul2 zero or not finite")
    log(f"  molten_salt: engCoul2 (Ewald reciprocal) {c2[0]:.4f} .. "
        f"{c2[-1]:.4f} eV over {len(c2)} rows, constant "
        f"{runs['molten_salt'][0].cfg.eng_ewald_const:.4f} eV")
    r = runs["liquid_argon"][0]
    log(f"  liquid_argon cell cap: {g.cap} at start, {r.cfg.grid.cap} at "
        f"end; fullest cell seen {int(r.state.cell_overflow)}")
    expect = {"surkov_cluster": "allpairs", "nanoclusters": "sparse",
              "liquid_argon": "cellblock", "liquid_argon_block": None,
              "molten_salt": "allpairs",
              "reactive_polymer": "allpairs_cand",
              "ejump_redox": "allpairs_cand",
              "reactive_polymer_x3": "sparse_cand",
              "ejump_redox_x3": "sparse_cand",
              "surkov_cluster_mesh": "allpairs_rect",
              "nanoclusters_mesh": "allpairs_rect",
              "liquid_argon_mesh": None}
    for nm, kern in expect.items():
        runner, launches, _ = runs[nm]
        want = {k: (runner.steps_run if k == kern else 0) for k in counters}
        check(launches == want, f"the {nm} run's pair passes did not all go "
              f"through {kern or 'torch ops'}")
    runner = runs["nanoclusters"][0]
    log(f"  nanoclusters sparse pair_cap: {cap} at start, "
        f"{runner.cfg.sparse_pair_cap} at end "
        f"({'regrown' if runner.cfg.sparse_pair_cap != cap else 'no regrow'}"
        f"); worklist need at the last check "
        f"{int(runner.state.cell_overflow)}")
    log(f"steps/s on {card}: " + ", ".join(
        f"{nm} {r[2]:.1f}" for nm, r in runs.items()))

    # --- 20 steps with each kernel against 20 with its plain version ---
    phase("20 kernel steps vs 20 plain steps")
    trajectories(torch, load_deck_dir, make_multi_step, "surkov_cluster",
                 SURKOV_DECK, dev, plain_pair(k1[1]))
    trajectories(torch, load_deck_dir, make_multi_step, "nanoclusters",
                 NANO_DECK, dev, plain_pair(k4[1]))
    for nm, deck in (("reactive_polymer", POLY_DECK),
                     ("ejump_redox", EJUMP_DECK)):
        trajectories(torch, load_deck_dir, make_multi_step, nm, deck, dev,
                     plain_pair(k1[1]))

    trajectories(torch, load_deck_dir, make_multi_step, "liquid_argon",
                 ARGON_DECK, dev,
                 lambda c, f, p, t, radii=None, **kw: k3[1](c, f, p, t, radii),
                 pair_engine="pallas")
    trajectories(torch, load_deck_dir, make_multi_step, "molten_salt",
                 SALT_DECK, dev, plain_pair(k1[1]))
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK)):
        mesh_trajectory(torch, load_deck_dir, make_multi_step, nm, deck,
                        MESH_DEV[nm], dev)

    # --- where a step's time goes (the profiler adds its own cost) ---
    phase("profiles")
    prof = {}
    for deck in (SURKOV_DECK, NANO_DECK, POLY_DECK, EJUMP_DECK, SALT_DECK):
        # ejump_redox's five jump passes give ~18,600 profiler events a
        # step, whose processing dominated this phase: 10 steps of it
        prof[deck] = profile_steps(torch, load_deck_dir, make_multi_step,
                                   deck, dev,
                                   n=10 if deck == EJUMP_DECK else
                                   PROFILE_STEPS)
    prof[ARGON_DECK] = profile_steps(torch, load_deck_dir, make_multi_step,
                                     ARGON_DECK, dev, pair_engine="pallas")
    profile_steps(torch, load_deck_dir, make_multi_step, ARGON_DECK, dev,
                  n=10)                      # "auto": the torch block engine
    poly_x3 = tiled["reactive_polymer"]
    prof[poly_x3] = profile_steps(torch, load_deck_dir, make_multi_step,
                                  poly_x3, dev, pair_engine="sparse")
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK)):
        prof[nm + "_mesh"] = profile_steps(torch, load_deck_dir,
                                           make_multi_step, deck, dev,
                                           mesh=MESH_DEV[nm])

    # --- timing at the paths' sizes: wrapper, kernel alone, plain ---
    phase("timing")
    def timing(nm, fns, args, kw, alone):
        # the plain K4-cand passes take ~0.6 s a call: fewer calls there
        n = 10 if args[0].n_at < 9000 else 4
        ms, ms_alone, ms_plain = timed(torch, [
            lambda: fns[0](*args, **kw), alone,
            lambda: fns[1](*args, **kw)], n=n)
        log(f"timing {nm} N={args[0].n_at}: wrapper {ms:.4f} ms, kernel "
            f"alone {ms_alone:.4f} ms, plain {ms_plain:.4f} ms per call "
            f"(medians of {2 * n}, CUDA events) on {card}")
        return ms, ms_alone, ms_plain

    def k1_alone(args, kw):
        cfg = args[0]
        tab = allpairs.kernel_tables(cfg, args[1], dev,
                                     kw.get("want_bind", False))
        c = allpairs.cand_args(cfg, args[1], kw.get("parents"),
                               kw.get("want_bind", False),
                               kw.get("want_jump", False), dev)
        return lambda: allpairs.launch(cfg, *tab, *args[2:], c)

    def k4_alone(args, kw):
        cfg = args[0]
        tab = allpairs.kernel_tables(cfg, args[1], dev,
                                     kw.get("want_bind", False))
        c = allpairs.cand_args(cfg, args[1], kw.get("parents"),
                               kw.get("want_bind", False),
                               kw.get("want_jump", False), dev)
        S = sparse.sort_tiles(cfg, *args[2:], parents=(
            c.parents if c is not None else None))
        if c is not None:
            c = dataclasses.replace(c, parents=S.parents)
        return lambda: sparse.launch(cfg, *tab, S, c)

    def k3_alone(args, kw):
        cfg = args[0]
        tab = allpairs.kernel_tables(cfg, args[1], dev)
        T = cellblock.cell_table(cfg, args[2], args[3])
        return lambda: cellblock.launch(cfg, *tab, T)

    def k1_plan(key, args, kw):
        cfg = args[0]
        lib = allpairs._lib()
        tile = lib.aztotmd_allpairs_tile()
        s = allpairs.allpairs_split(cfg.n_at, tile, allpairs.sm_count(dev),
                                    lib.aztotmd_allpairs_max_range())
        cand = bool(kw.get("want_bind") or kw.get("want_jump"))
        par = kw.get("parents") is not None and bool(kw.get("want_bind"))
        smem = lib.aztotmd_allpairs_smem_bytes(cfg.n_at, s, cfg.n_spec,
                                               int(cand), int(par))
        log(f"plan {key}: {-(-cfg.n_at // tile)} i blocks x {s} splits of "
            f"{-(-cfg.n_at // s)} j atoms, {tile} threads, {smem} bytes of "
            "dynamic shared memory a block")

    def k4_plan(key, args):
        cfg = args[0]
        T4, n_t4, _ = sparse.tile_shape(cfg)
        s = sparse.sparse_split(n_t4, allpairs.sm_count(dev))
        log(f"plan {key}: {n_t4} tiles x {s} splits, {T4} threads, "
            "two staged j tiles in static shared memory (ptxas above) and "
            f"the {cfg.n_spec}-species tables in dynamic")

    def profile_alone(fn, n=20):
        """Profiler device ms of one call of ``fn``, which launches one
        kernel and nothing else, averaged over the launches the profiler
        recorded (late in a long process it may keep fewer than ``n``);
        returns (ms or None when none was recorded, launches recorded)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_a:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        t = [e.time_range.elapsed_us() for e in prof_a.events()
             if e.device_type == DeviceType.CUDA]
        return (sum(t) * 1e-3 / len(t) if t else None), len(t)

    d = load_deck_dir(SALT_DECK, device=dev)
    salt_args = (d["cfg"], d["ff"], d["state"].pos, d["state"].types, None)
    times, alones = {}, {}
    for key, fns, args, kw, alone in (
            ("K3", k3, k3_args, {}, k3_alone),
            ("K1 molten_salt", k1, salt_args, {}, k1_alone),
            ("K1", k1, k1_args, {}, k1_alone),
            ("K1-cand reactive_polymer", k1, k1c_poly, k1c_poly_kw,
             k1_alone),
            ("K1-cand ejump_redox", k1, k1c_ej, k1c_ej_kw, k1_alone),
            ("K4", k4, k4_args, {}, k4_alone),
            ("K4-cand reactive_polymer x3", k4, k4c_poly, k4c_poly_kw,
             k4_alone),
            ("K4-cand ejump_redox x3", k4, k4c_ej, k4c_ej_kw, k4_alone)):
        alones[key] = alone(args, kw)
        times[key] = timing(key, fns, args, kw, alones[key])
        if alone is k1_alone:
            k1_plan(key, args, kw)
        elif alone is k4_alone:
            k4_plan(key, args)

    def k2_timing(nm):
        cfg, ff, args, kw = k2_in[nm]
        tab = allpairs.kernel_tables(cfg, ff, dev)
        alone = lambda: allpairs.launch_rect(
            cfg, *tab, args[0], args[1], args[2], kw["radii_i"], args[3],
            args[4], args[5], kw["radii_j"])
        n = 10
        ms, ms_alone = timed(torch, [
            lambda: allpairs.pair_forces_allpairs_rect(cfg, ff, *args, **kw),
            alone], n=n)
        ms_plain, = timed(torch, [
            lambda: allpairs.pair_forces_allpairs_rect_plain(cfg, ff, *args,
                                                             **kw)], n=2)
        log(f"timing K2 {nm} over {args[0].shape[0]} slabs: wrapper "
            f"{ms:.4f} ms, kernel alone {ms_alone:.4f} ms (medians of "
            f"{2 * n}), plain {ms_plain:.4f} ms (median of 4), CUDA events, "
            f"on {card}")
        alones["K2" if nm == "surkov_cluster" else "K2 " + nm] = alone
        return ms, ms_alone, ms_plain

    times["K2"] = k2_timing("surkov_cluster")
    times["K2 nanoclusters"] = k2_timing("nanoclusters")
    kprof = {}
    for key, fn in alones.items():
        kprof[key], seen = profile_alone(fn)
        log(f"profile {key}: kernel alone "
            + (f"{kprof[key]:.4f} ms a launch" if kprof[key] else
               "not measured (no device time recorded)")
            + f" (torch.profiler, mean of the {seen} of 20 launches it "
            f"recorded) on {card}")

    block_cfg = dataclasses.replace(k3_args[0], pair_engine="block")
    n_block = 4
    block_ms, = timed(torch, [lambda: cellblock.pair_forces_block(
        block_cfg, *k3_args[1:])], n=n_block)
    log(f"timing torch cell-block engine N={block_cfg.n_at}: "
        f"{block_ms:.4f} ms per pass (median of {2 * n_block}, CUDA events) "
        f"on {card}")
    sa = d["state"]
    charge = d["ff"].spec_charge[sa.types.long()]
    n_ewald = 10
    ewald_ms, = timed(torch, [lambda: ewald_recip(
        d["cfg"], sa.pos, charge, d["aux"].rk, d["aux"].kweights)],
        n=n_ewald)
    log(f"timing Ewald reciprocal sum N={d['cfg'].n_at} "
        f"K={d['aux'].rk.shape[0]}: {ewald_ms:.4f} ms per call (torch ops "
        f"and two matmuls in full f32, median of {2 * n_ewald}) on {card}")

    # --- bounds from this run's inputs ---
    phase("bounds")
    def k1_bound(args, fam, cand):
        cfg = args[0]
        pairs = pairs_in_range(torch, cfg, args[2])
        nb = cfg.n_at * (12 + 4 + 4 + 12) + 8
        if cand:
            nb += cfg.n_at * (4 + 3 * (4 + 8))
        return (cfg.n_at * (cfg.n_at - 1), pairs,
                bound(cfg.n_at * (cfg.n_at - 1), pairs, fam, nb, cand))

    worklist_bounds = {}

    def k4_bound(key, args, kw, fam, cand):
        # the work this run's data needs: the filled slot pairs of the
        # sub-tile pairs that the kernel's warp cull keeps (the kernel's
        # own record of one launch, held exactly against
        # sparse.subtile_keep), each at the cost of the min-image and
        # cutoff test, and the pairs in range at the cost of the physics;
        # need*T^2, every slot pair the worklist names (the count up to
        # the culling kernel), is kept beside it as bound_worklist_ms
        cfg = args[0]
        T4, n_t4, cap4 = sparse.tile_shape(cfg)
        need4 = int(k4[0](*args, **kw).max_occ)
        S = sparse.sort_tiles(cfg, *args[2:])
        keep = sparse.kernel_keep(
            cfg, *allpairs.kernel_tables(cfg, args[1], dev), S)
        check(bool((keep == sparse.subtile_keep(cfg, S)).all()),
              f"K4 N={cfg.n_at}: the kernel's warp cull is not "
              "sparse.subtile_keep")
        n_sub = keep.shape[1]
        full = torch.nn.functional.pad(
            (S.gid >= 0).reshape(n_t4, T4),
            (0, n_sub * sparse.CULL_SUB - T4)).reshape(n_t4, n_sub, -1)
        per = full.sum(-1)
        kept = int((keep * per[S.it.long()][:, :, None]
                    * per[S.jt.long()][:, None, :]).sum())
        subs = int(keep.sum())
        log(f"K4 N={cfg.n_at}: worklist need {need4}, need*T^2 = "
            f"{need4 * T4 * T4} visited slot pairs; the kernel's warps kept "
            f"{subs} sub-tile pairs (equal to sparse.subtile_keep), "
            f"{subs * sparse.CULL_SUB ** 2} slot pairs "
            f"({subs * sparse.CULL_SUB ** 2 / (need4 * T4 * T4):.4f}), "
            f"{kept} of filled slots; the bound counts these")
        pairs = pairs_in_range(torch, cfg, args[2])
        nb = (n_t4 * T4 * 6 * 4 + (n_t4 + 1 + cap4) * 4 + cfg.n_at * 12 + 8)
        if cand:
            nb += n_t4 * T4 * (4 + 3 * (4 + 8))
        worklist_bounds[key] = bound(need4 * T4 * T4, pairs, fam, nb, cand)
        log(f"bound {key} over need*T^2: {worklist_bounds[key][0]:.4g} ms "
            f"({worklist_bounds[key][2]})")
        return kept, pairs, bound(kept, pairs, fam, nb, cand)

    def k3_bound(args):
        # the work the function needs on this run's data, whichever
        # stencil the kernel walks: the pairs of filled slots that the
        # Newton half stencil brings together (unordered in the own cell,
        # cell against cell in the 13 neighbors), each at the cost of a
        # displacement, r2 and the cutoff test on pre-shifted images, and
        # the unordered pairs in range at the cost of the physics
        cfg = args[0]
        gr = cfg.grid
        cnt = cellblock.cell_table(cfg, args[2], args[3])["cnt"].reshape(
            gr.dims).long()
        half = cellblock.half_stencil(gr)
        filled = int((cnt * (cnt - 1) // 2).sum())
        for off in half[1:]:
            nbr = torch.roll(cnt, [-o for o in off], [0, 1, 2])
            filled += int((cnt * nbr).sum())
        padded = len(half) * gr.cap * gr.cap * gr.n_cell
        log(f"K3 half stencil: {filled} pairs of filled slots of {padded} "
            f"padded slot pairs ({len(half)} cells x cap {gr.cap}^2 x "
            f"{gr.n_cell} cells; the TPU kernel walks the padded ones); the "
            "bound counts the filled ones")
        pairs = pairs_in_range(torch, cfg, args[2]) // 2
        nb = cfg.n_at * (12 + 4 + 12) + 8
        fp32 = (filled * OPS_SLOT_SHIFTED + pairs * OPS_PAIR["lnjs"]
                ) / PEAK_FP32
        mufu = pairs * MUFU_PAIR["lnjs"] / PEAK_MUFU
        return filled, pairs, bound_of(fp32, mufu, nb)

    bounds = {"K3": k3_bound(k3_args),
              "K1 molten_salt": k1_bound(salt_args, "bmhs+ewald", False),
              "K1": k1_bound(k1_args, "surk", False),
              "K1-cand reactive_polymer": k1_bound(k1c_poly, "lnjs", True),
              "K1-cand ejump_redox": k1_bound(k1c_ej, "buck+dir", True),
              "K4": k4_bound("K4", k4_args, {}, "lnjs", False),
              "K4-cand reactive_polymer x3": k4_bound(
                  "K4-cand reactive_polymer x3", k4c_poly, k4c_poly_kw,
                  "lnjs", True),
              "K4-cand ejump_redox x3": k4_bound(
                  "K4-cand ejump_redox x3", k4c_ej, k4c_ej_kw, "buck+dir",
                  True)}
    def k2_bound(nm, fam):
        # the work this run's data needs: every pair of filled slots (i an
        # owned slot, j an owned or halo slot, not the same slot) at the
        # cost of the displacement, min-image and cutoff test, and the
        # pairs in range at the cost of the physics; each input read once,
        # each output written once
        cfg, ff, args, kw = k2_in[nm]
        L, ni = args[0].shape[:2]
        nj = args[3].shape[1]
        slots, pairs = rect_pairs(torch, cfg, args)
        log(f"K2 {nm}: {slots} pairs of filled slots of {L * ni * nj} "
            f"padded slot pairs ({L} slabs x {ni} x {nj}); the bound counts "
            "the filled ones")
        nb = L * (ni + nj) * (12 + 4 + 1 + (4 if kw["radii_i"] is not None
                                            else 0)) + L * ni * 12 + 8 * L
        return slots, pairs, bound(slots, pairs, fam, nb)

    bounds["K2"] = k2_bound("surkov_cluster", "surk")
    bounds["K2 nanoclusters"] = k2_bound("nanoclusters", "lnjs")
    for key, (slots, pairs, b) in bounds.items():
        log(f"bound {key}: {slots} slot pairs, {pairs} in range: "
            f"{b[0]:.4g} ms ({b[2]}); computed from the operation count "
            "of csrc/pair_physics.cuh, not from a counter")

    phase("NCCL DistRing")
    log(dist_phase(out))

    def prof_ms(deck, kernel):
        """Profiler device ms per step of the kernel instantiation whose
        name holds ``kernel`` over the profiled bare steps (None when the
        profiler saw no device activity)."""
        by = prof.get(deck) or {}
        t = sum(v for k, v in by.items() if kernel in k)
        return t * 1e3 if t else None

    def entry(name, source, replaces, launches, err, key, extra=None):
        ms, alone, plain = times[key]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "kernel_ms": alone,
               "plain_ms": plain, "bound_ms": bounds[key][2][0],
               "bound_by": bounds[key][2][1], "library_ms": None,
               "kernel_profiler_ms": kprof[key]}
        rec.update(extra or {})
        return rec

    l = {nm: r[1] for nm, r in runs.items()}
    salt = times["K1 molten_salt"]
    k1c_launch = (l["reactive_polymer"]["allpairs_cand"]
                  + l["ejump_redox"]["allpairs_cand"])
    k4c_launch = (l["reactive_polymer_x3"]["sparse_cand"]
                  + l["ejump_redox_x3"]["sparse_cand"])
    ej1 = times["K1-cand ejump_redox"]
    ej4 = times["K4-cand ejump_redox x3"]
    k2n = times["K2 nanoclusters"]
    return [
        entry("allpairs_rect", "aztotmd_tpu_torch/csrc/allpairs_rect.cu",
              "aztotmd_tpu/ops/pallas_pair.py:708",
              l["surkov_cluster_mesh"]["allpairs_rect"]
              + l["nanoclusters_mesh"]["allpairs_rect"], k2_err, "K2",
              {"profiler_ms": prof_ms("surkov_cluster_mesh", "rect_kernel"),
               "nanoclusters": {
                   "ms": k2n[0], "kernel_ms": k2n[1], "plain_ms": k2n[2],
                   "bound_ms": bounds["K2 nanoclusters"][2][0],
                   "kernel_profiler_ms": kprof["K2 nanoclusters"],
                   "profiler_ms": prof_ms("nanoclusters_mesh",
                                          "rect_kernel")}}),
        entry("allpairs", "aztotmd_tpu_torch/csrc/allpairs.cu",
              "aztotmd_tpu/ops/pallas_pair.py:335",
              l["surkov_cluster"]["allpairs"] + l["molten_salt"]["allpairs"],
              k1_err, "K1",
              {"profiler_ms": prof_ms(SURKOV_DECK, "allpairs_kernel<false, "
                                      "false, false>"),
               "molten_salt": {
                   "ms": salt[0], "kernel_ms": salt[1], "plain_ms": salt[2],
                   "bound_ms": bounds["K1 molten_salt"][2][0],
                   "kernel_profiler_ms": kprof["K1 molten_salt"],
                   "profiler_ms": prof_ms(SALT_DECK, "allpairs_kernel<false, "
                                          "false, false>"),
                   "ewald_recip_ms": ewald_ms}}),
        entry("cellblock", "aztotmd_tpu_torch/csrc/cellblock.cu",
              "aztotmd_tpu/ops/pallas_pair.py:120",
              l["liquid_argon"]["cellblock"], k3_err, "K3",
              {"profiler_ms": prof_ms(ARGON_DECK, "cellblock_kernel"),
               "torch_block_engine_ms": block_ms}),
        entry("allpairs_cand", "aztotmd_tpu_torch/csrc/allpairs.cu",
              "aztotmd_tpu/ops/pallas_pair.py:264", k1c_launch, k1c_err,
              "K1-cand reactive_polymer",
              {"profiler_ms": prof_ms(POLY_DECK, "allpairs_kernel<true, "
                                      "false, true>"),
               "ejump_redox": {
                   "ms": ej1[0], "kernel_ms": ej1[1], "plain_ms": ej1[2],
                   "bound_ms": bounds["K1-cand ejump_redox"][2][0],
                   "kernel_profiler_ms": kprof["K1-cand ejump_redox"],
                   "profiler_ms": prof_ms(EJUMP_DECK, "allpairs_kernel<false, "
                                          "true, false>")}}),
        entry("sparse", "aztotmd_tpu_torch/csrc/sparse.cu",
              "aztotmd_tpu/ops/pallas_sparse.py:129",
              l["nanoclusters"]["sparse"], k4_err, "K4",
              {"profiler_ms": prof_ms(NANO_DECK, "sparse_kernel<false, "
                                      "false, false, false>"),
               "bound_worklist_ms": worklist_bounds["K4"][0]}),
        entry("sparse_cand", "aztotmd_tpu_torch/csrc/sparse.cu",
              "aztotmd_tpu/ops/pallas_sparse.py:189", k4c_launch, k4c_err,
              "K4-cand reactive_polymer x3",
              {"profiler_ms": prof_ms(poly_x3, "sparse_kernel<true, false, "
                                      "true, false>"),
               "bound_worklist_ms":
                   worklist_bounds["K4-cand reactive_polymer x3"][0],
               "ejump_redox_x3": {
                  "ms": ej4[0], "kernel_ms": ej4[1], "plain_ms": ej4[2],
                  "bound_ms": bounds["K4-cand ejump_redox x3"][2][0],
                  "bound_worklist_ms":
                      worklist_bounds["K4-cand ejump_redox x3"][0],
                  "kernel_profiler_ms": kprof["K4-cand ejump_redox x3"]}})]


if __name__ == "__main__":
    sys.exit(main())
