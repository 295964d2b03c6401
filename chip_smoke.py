#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (aztotmd_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout.  It builds the port's CUDA kernels
(csrc/allpairs.cu: K1 and K1-cand, the dense pass without and with the
fused bind/jump candidates; csrc/sparse.cu: K4 and K4-cand, the Morton
block-sparse pass; csrc/cellblock.cu: K3, the stacked cell-block pass;
csrc/allpairs_rect.cu: K2, the rectangular pass of the slab-decomposed
step; csrc/rdf.cu: the all-pairs RDF sample's integer counts;
csrc/tstat.cu: the radiative thermostat) for sm_90a
from the checkout, one nvcc each, in parallel, and then, for each kernel,
checks it against its plain PyTorch version on the card:
  the RDF kernel: counts exactly equal on crafted pairs at r_rdf, on bin
      edges and at half the box (f32, f64, 1-3 species), on the
      surkov_cluster deck at three seeds and on molten_salt with the
      nuclei histogram, then timed beside its bound;
  the radiative thermostat's kernel: the rng words exactly, velocities,
      internal energies and radii within 2e-6 (f32) / 1e-13 (f64) of
      the largest plain |v|, an atom's internal plus kinetic energy and
      radius on surkov_cluster's state at the start
      and after an MDRunner run whose steps each launched it once, then
      timed at 4,000, 40,000 and 1,080,000 atoms beside its byte bound;
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
examples/liquid_argon through the CLI on "auto" (K3: on the card "auto"
takes the stacked pass for a cell-block deck it fits); liquid_argon also
runs with pair_engine="block", the cell-block engine in torch ops.  The
slab-decomposed step runs through ``run --mesh N`` on the one card (all
slabs batched in one process): examples/surkov_cluster over 2 slabs and
examples/nanoclusters over 4 (K2, every pair pass), examples/liquid_argon
over 4 (the slab stencil pass in torch ops); no atom may be lost to a
migration; 20 mesh steps are held against 20 one-device kernel steps
(K1, K4) with the JAX package's slab bounds, and 50 bare mesh steps are
profiled.  With two or more cards it also runs the slabs one per process
over NCCL.  Topology on the slab mesh (``topology_mesh_phases``):
reactive_polymer and ejump_redox tiled 3x3x3 through ``run --mesh 4`` and
``--mesh 3`` (the replicated reactive tables, the stencil pass),
examples/bonded_fluid through ``run --mesh 4`` (the per-atom bond and
angle records) and over 4 slabs on "pallas" (K2 beside the bonded pass,
every pair pass a K2 launch); graph replays against eager slab steps
with the replicated tables exactly equal; f64 mesh against f64 one
device on reactive_polymer over 4 and ejump_redox over 3 (topology
exactly, positions within 1e-7 A) and f32 on the tiled decks; profiles;
and the time of the work that runs once for all slabs beside a step's.
It
checks that every pair pass went through that path's kernel, that
stat.dat is finite and rdf.dat non-zero, that bonds and jumps happened
(stat_bnd.dat, jumps.dat) and revbonds.txt and lengths.dat were
written.  It compares 20 steps with each kernel against 20 steps with
its plain version (the reactive decks' topology and RNG words exactly),
profiles bare steps of each deck (a profile counts only where it
recorded every launch of the port's kernels), and times the kernels, their
wrappers and plain versions at the paths' sizes with CUDA events and
each kernel alone with torch.profiler, beside a lower bound computed
from an operation count read off csrc/pair_physics.cuh; it logs K1's
and K4's launch plans (splits, blocks, dynamic shared memory), K2's
(splits, thread groups) and K3's (cells a block, shared memory), and the
sub-tile pairs that the warp culls of K4 and K2 kept, as the kernels
record them (held exactly against sparse.subtile_keep and
allpairs.rect_subtile_keep); the bounds of K4 and K2 count the filled
slot pairs in them (K2's over every filled slot pair beside it).
Last, the Verlet-list engine, which has no pair kernel (no Pallas kernel
lies on its path in the JAX package): examples/argon_gas (case study 1's
40,000-atom gas) and examples/bonded_fluid (constant bonds and angles)
1,000 steps each through the CLI with no pair kernel launched (the
radiative thermostat's kernel once a step on argon_gas), no skin
violation, every list monitor within its capacity or regrown and the
angle outputs checked; make_multi_step over 2*Q*R bare argon_gas steps
with its 2 full rebuilds and 2*(Q-1) refines counted; 20 steps on the
card against 20 on the CPU from the same state (the first build's lists
equal, in order from the sorted build); the list passes, a bare step
and apply_angles timed with CUDA events; a 50-step profile.
Every run and every multi-step on the card goes through CUDA graphs
(``aztotmd_tpu_torch/runtime/graph.py``): the launch counts add each
replay's launches, so "every pair pass a launch" holds unchanged.  Each
deck (the eight examples, liquid_argon on K3 through "auto" and on the
torch block engine named, surkov_cluster over 2 slabs, nanoclusters over 4) runs 1 + 100
steps eager and 1 + 100 replayed from the same state: integer fields
exactly equal, positions within 1e-6 A, with the graph's nodes, its
capture time and both rates; the step profiles run replayed and eager
(the device idle share of each); argon_gas through the CLI takes the
JAX stat ring's plan (``rdf_from_outer``, k_super 4: its window of 5
stat periods cut 4 + 1, so 2 full rebuilds and 20 refines in 1,000
steps, the RDF sampled from the outer Verlet list), and on its last
state the list sampler's histograms equal the cell-candidate sampler's
exactly, both timed replayed; bonded_fluid's regrow of K (at the end
of its run's one stat-ring window, as JAX's) is replayed captured at the
next window, and its graph run matches an eager run; run --debug
--timings, run --profile and bench run on surkov_cluster.  The kernel-vs-plain trajectories run eager.
The atom-sharded mode (``parallel/mesh.py``, ``atoms_mesh_phases``):
molten_salt (1,000 steps, K1 + Ewald), ejump_redox (1,000, K1-cand) and
nanoclusters (500, K4) through ``run --mesh 4 --mesh-mode atoms``, every
pair pass a launch of the deck's kernel; 1 + 100 atoms-mode steps
replayed against eager ones and against the one-device replays (integer
fields exactly, positions within 1e-6 A), with graph nodes and rates
beside one device's.  The domain pass (``domain_phase``) over 4 x-slabs
on 4,096 argon atoms against the all-pairs plain pass, both timed.  The
entry points (``entry_api_phases``): ``entry()`` steps once on the card,
``dryrun_multichip(4)`` passes, and ``aztotmd_tpu_torch.run`` writes the
CLI's stat.dat byte for byte.  K2 alone on bonded_fluid over 4 is
profiled over 200 back-to-back launches and timed over a graph of 200.
Last, the JAX stat ring's RDF-list plan on small argon gases, one for
each of its list regimes (``rdf_plan_phase``: 400 f32 steps replayed
against eager, JAX's rebuild counts, every sample by the plan's
sampler), then the JAX system's scale, dilute and NVE paths and its last
pair engine (``scale_phases``; no kernel lies on them): its tools' decks,
written from examples/argon_gas by ``aztotmd_tpu_torch.systems``, the
320,000- and 1,080,000-atom tilings 2,000 and 1,000 steps through the
run CLI after bare replayed steps (setup, capture, rates, rebuilds and
refines counted against the JAX ring's plan, peak memory; finite
stat.dat, non-zero rdf.dat sampled from the outer Verlet list, no atom
lost, no skin violation, every list monitor within its capacity; the
list sampler's histograms against the cell sampler's on the last state,
both timed); the dilute deck with and without ``nb_orowcap``
(the inner lists equal after each of 6 refines and on atoms moved up to
6 A; both rates and the refine's ms), and with ``nb_orowcap`` forced
below the outer-occupied rows (the runner's warning, regrow and
recapture, the lists equal after it); the NVE deck 1,000 f32 steps
against 1,000 f64 (total energy within rel 1e-4) and 20,000 f32 steps
through the CLI (the total energy's drift); "gather" on liquid_argon, 20
steps against 20 of the block engine (within 1e-4 A) and its replayed
rate; and ``python -m aztotmd_tpu_torch.bench --windows 2 --chunk 500``
in a process of its own (exit 0, two four-key lines).
The stat ring (``ring_phase``, PR 14): every run above counts one copy
of rows to the host and one flush a window (``ring_counts``), the ring's
rows of surkov_cluster and argon_gas equal the host loop's float32-cast
values of the same states (1 ulp; MSD rel 1e-5), argon_gas's device
idle share between periods is profiled on the ring and on the host loop,
and the ring runs' CLI steps/s are logged beside PR 13's.
Any failure exits non-zero.
The last line of standard output is {"ok": true, "device": {...}}; the
line before it lists the kernels with their launches, errors, times and
bounds.  The runs' output files go to --out (default: a temporary
directory that is removed).
"""

import argparse
import concurrent.futures
import dataclasses
import json
import math
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
GAS_DECK = os.path.join(HERE, "examples", "argon_gas")
BONDED_DECK = os.path.join(HERE, "examples", "bonded_fluid")
GAS_STEPS = 1000         # 5 stat periods, one window of JAX's ring: its
                         # superblocks of 4 and 1 take 2 full rebuilds
                         # and 20 refines (GAS_RING)
GAS_RING = {"rebuild": 2, "refine": 20}
BONDED_STEPS = 1000
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
                         # (pair_engine="block")
PROFILE_STEPS = 50
BONDED_K2_STEPS = 1000   # bonded_fluid's slab steps before K2's second
                         # comparison on its path (its CLI run's length)
TOPO_F64_STEPS = 40      # f64 mesh against f64 one device, topology decks
TOPO_F64_ATOL = 1e-7     # A: the JAX package's slab-vs-one-device bound
TOPO_F32_STEPS = 20      # f32 mesh against one device, the tiled decks
# ejump_redox x3 over 3 slabs takes ~0.63 s a step on the H100 (JAX's
# environment-dU sweep over N x C a slab, five passes a step): its
# topology phases run at this cut depth (CLI steps, graph steps, profiled
# steps, timed calls) to keep the script within half its time limit
EJUMP_MESH_DEPTH = (100, 10, 4, 3)
ATOMS_STEPS = {"molten_salt": 1000, "ejump_redox": 1000,
               "nanoclusters": 500}    # run --mesh 4 --mesh-mode atoms
ATOMS_DEV = 4
DOMAIN_ATOMS = 4096      # the domain pass on build_lj_argon's system
API_STEPS = 200          # aztotmd_tpu_torch.run against the CLI: one stat
                         # row of surkov_cluster (stat every 200 steps)
ALONE_LAUNCHES = 200     # K2 alone on bonded_fluid over 4: back-to-back
SCALE_STEPS = {2: 2000, 3: 1000}  # the tiled argon decks (320k, 1.08M atoms)
# JAX's ring on them: one window of 10 and of 5 stat periods, superblocks
# of 4 (4 + 4 + 2 and 4 + 1), a refine each RDF block of 50 steps
SCALE_RING = {2: {"rebuild": 3, "refine": 40},
              3: {"rebuild": 2, "refine": 20}}
SCALE_BARE = {2: 400, 3: 200}     # bare replayed steps timed on them
OROW_REFINES = 6         # refines compared with and without nb_orowcap
NVE_STEPS = 20000        # f32 NVE steps through run (drift)
NVE_EQUIL = 2000         # steps before the drift's reference row
NVE_GATE_STEPS = 1000    # f32 against f64 total energy
NVE_GATE_REL = 1e-4
GATHER_STEPS = 20        # "gather" against the block engine on liquid_argon
PLAN_STEPS = 400         # each RDF-plan regime, replayed and eager
GATHER_POS_ATOL = 1e-4   # A
BENCH_ARGS = ["--windows", "2", "--chunk", "500"]
# the stat ring (PR 14): the runs whose windows and flushes are counted
# (name in the log -> CLI steps/s of PR 13's final run, NVIDIA H100 80GB
# HBM3, 700.00 W), the rows held against the host loop's, and the window
# profiled for the card's idle share between periods
RING_PR13 = {"surkov_cluster": 877.1, "argon_gas": 948.1,
             "argon_gas x3^3 (1080000 atoms)": 303.6,
             "surkov_cluster --mesh 2": 427.5,
             "nanoclusters --mesh 4 --mesh-mode atoms": 812.1}
RING_ROW_STEPS = {"surkov_cluster": 400, "argon_gas": 1000}
RING_MSD_REL = 1e-5
RING_PROFILE_STEPS = 400      # argon_gas: two windows of one period
GRAPH_STEPS = 100        # graph replays against eager steps, per deck
GRAPH_POS_ATOL = 1e-6    # A: the same kernels in the same order
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
TSTAT_SIZES = (4000, 40000, 1080000)   # the thermostat kernel timed
TSTAT_STEPS = 200        # MDRunner.run on surkov_cluster, a launch a step
TSTAT_TOL = {"float32": 2e-6, "float64": 1e-13}
# f32 bytes an atom: read vel, engs, type, photon; write vel, engs, radii
TSTAT_BYTES = 44
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
# The all-pairs RDF kernel (csrc/rdf.cu), issue slots on the FP32 pipe
# (none is an FMA, so at half the FLOP peak): every unordered pair the
# displacement, the |d| > box/2 test per axis, r2 and the cut (12); a
# pair in range the sqrt's and the division's fix-ups, the conversion,
# the clamp and the slot (14) and two MUFU results (rsqrt, reciprocal).
OPS_RDF_PAIR = 12
OPS_RDF_RANGE = 14
MUFU_RDF_RANGE = 2


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


def drive(cli, counters, name, deck, out, steps, runner_fn=None, mesh=0,
          mesh_mode="slab"):
    """One path through the run CLI (``--mesh mesh --mesh-mode mesh_mode``
    when set; or ``runner_fn(out)``, which runs and returns an MDRunner)
    with every launch count set to 0 just before it, and the counts held
    against the launches torch.profiler records over a window of the same
    runner (``launch_window``); returns (runner, launches per kernel,
    steps/s)."""
    import torch
    from aztotmd_tpu_torch.ops import rdf as ops_rdf
    _zero(counters)
    ops_rdf.launches = ops_rdf.rdf_counts["allpairs"] = 0
    t0 = time.perf_counter()
    if runner_fn is None:
        runner = cli(["run", deck, "--steps", str(steps), "-o", out,
                      "--quiet"] + (["--mesh", str(mesh), "--mesh-mode",
                                     mesh_mode] if mesh else []))
    else:
        runner = runner_fn(out)
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    rate = runner.steps_run / runner.loop_seconds
    log(f"{name} run: {runner.steps_run} steps of {runner.cfg.n_at} atoms "
        f"in {runner.loop_seconds:.2f} s loop ({wall:.2f} s with setup): "
        f"{rate:.1f} steps/s")
    log(f"  kernel launches {launches}, pair-force evaluations "
        f"{runner.steps_run}; all-pairs RDF samples "
        f"{ops_rdf.rdf_counts['allpairs']}, RDF kernel launches "
        f"{ops_rdf.launches}")
    check(ops_rdf.launches == ops_rdf.rdf_counts["allpairs"],
          f"{name}: an all-pairs RDF sample did not launch csrc/rdf.cu")
    check(runner.steps_run == steps, f"{name} run stopped early")
    slab_mesh = mesh and mesh_mode == "slab"
    if mesh_mode == "atoms":
        n_dev = runner._atoms_mesh.n_dev
        check(runner.comm is None and n_dev == mesh and tuple(
            runner.state.pos.shape) == (mesh, runner.cfg.n_at // mesh, 3),
            f"{name}: not {mesh} atom row shards")
        log(f"  atom row shards {n_dev} of {runner.cfg.n_at // n_dev} rows")
    if slab_mesh:
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
        # on a mesh the topology is the replicated tables of a reactive
        # deck (``rg``) or the per-atom records of a constant one, which
        # the runner's view counts
        topo = runner.state.rg if slab_mesh else runner._view()
        bnd = read_table(os.path.join(out, "stat_bnd.dat"), 1)
        check(len(bnd) == len(rows) and bnd[-1][2] > 0,
              f"{name} stat_bnd.dat shows no bonds")
        with open(os.path.join(out, "revbonds.txt")) as f:
            n_list = int(f.readline())
        check(n_list == int(runner._view().n_bond) and os.path.getsize(
            os.path.join(out, "lengths.dat")) > 0,
            f"{name} revbonds.txt / lengths.dat not written")
        broken = (f"{int(topo.bt_lt_count.sum())} bonds broken or mutated"
                  if topo is not None else "constant bonds")
        log(f"  stat_bnd.dat: n_bond {int(bnd[-1][2])} at the end, "
            f"{broken}; revbonds.txt lists {n_list}")
    if slab_mesh and (cfg.use_bnd or cfg.use_angl):
        miss = int(runner.state.bond_miss)
        log(f"  bond/angle records beyond one slab (bond_miss): {miss}")
        check(miss == 0, f"{name}: bond or angle records lost their partner")
    if cfg.ejtype:
        jmp = read_table(os.path.join(out, "jumps.dat"), 1)
        check(len(jmp) == len(rows) and jmp[-1][2] > 0,
              f"{name} jumps.dat shows no jumps")
        log(f"  jumps.dat: n_jump {int(jmp[-1][2])} (pos {int(jmp[-1][3])},"
            f" neg {int(jmp[-1][4])})")
    ring_counts(runner, name, steps, rate)
    launch_window(torch, runner, counters, name, rate)
    return runner, launches, rate


def trajectories(torch, load_deck_dir, make_multi_step, name, deck, dev,
                 plain_fn, **load_kw):
    """20 steps with the kernel against 20 with the plain version; the
    reactive topology and RNG words must be equal."""
    runs = []
    for fn in (None, plain_fn):
        d = load_deck_dir(deck, device=dev, **load_kw)
        s = make_multi_step(d["cfg"], d["aux"], pair_fn=fn, graph=False)(
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


def plan_words(runner):
    """The runner's RDF plan (``bench.plan_name``) with its list width."""
    from aztotmd_tpu_torch.bench import plan_name
    name = plan_name(runner)
    if name == "from_outer":
        return (f"{name}, k_super {runner._ring_plan['k_super']}, the outer "
                f"list's {runner.cfg.n_neigh2} slots an atom")
    if name.startswith("list"):
        return f"{name}, k_cap {runner.rcfg.k_cap}"
    return name


def rdf_list_case(torch, name, runner, card):
    """The run's plan sampler (``runner._rdf_plan``: the outer Verlet list
    or the RDF list) against the cell-candidate sampler (``runner._rdf``)
    on the run's last state and lists, which the run's last sample read:
    the histograms (integer counts times one weight table) exactly equal;
    both timed as graph replays (CUDA events, medians) and per step at
    the deck's RDF period.  Returns the numbers."""
    from aztotmd_tpu_torch.runtime.graph import GraphedSample
    st = runner.state
    zero = lambda h: None if h is None else torch.zeros_like(h)
    fns = {"list": runner._rdf_plan.fn, "cells": runner._rdf.fn}
    got = {k: fn(st, zero(runner.hist), zero(runner.nhist))
           for k, fn in fns.items()}
    same = all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got["list"], got["cells"]))
    bufs = {k: (zero(runner.hist), zero(runner.nhist)) for k in fns}
    graphs = {k: GraphedSample(fn, f"{k} RDF sample")
              for k, fn in fns.items()}
    ms = dict(zip(fns, timed(torch, [
        lambda k=k: graphs[k](st, *bufs[k]) for k in fns], n=5)))
    rc = runner.rcfg
    m_cells = len(rc.grid.stencil) * rc.grid.cap
    width = (runner.cfg.n_neigh2 if runner._ring_plan["rdf_from_outer"]
             else rc.k_cap)
    log(f"  {name}: RDF sample on the plan's list ({width} slots an atom) "
        f"{ms['list']:.4f} ms replayed, on the cell candidates ({m_cells} "
        f"slots an atom, grid {rc.grid.dims} cap {rc.grid.cap}) "
        f"{ms['cells']:.4f} ms replayed on {card}; every {runner.p_rdf} "
        f"steps: {ms['list'] / runner.p_rdf:.4f} against "
        f"{ms['cells'] / runner.p_rdf:.4f} ms a step; histograms "
        f"{'equal' if same else 'DIFFER'} (total g weight "
        f"{float(got['list'][0].sum()):.6g})")
    check(same and float(got["list"][0].sum()) > 0,
          f"{name}: the list sampler's counts differ from the cell "
          "sampler's on the card, or are zero")
    return {"list_ms": ms["list"], "cells_ms": ms["cells"],
            "list_slots": width, "cell_slots": m_cells}


def gas_variant(d, n_atoms, density, rdf=None, temp=None):
    """examples/argon_gas's writer at ``n_atoms`` and ``density``, with the
    RDF reach (A) or the temperature (K) replaced."""
    from aztotmd_tpu_torch import systems
    systems.write_argon_gas_deck(d, n_atoms=n_atoms, density=density,
                                 steps=PLAN_STEPS)
    path = os.path.join(d, "control.txt")
    with open(path) as f:
        text = f.read()
    if rdf:
        text = text.replace("rdf\t14.0", f"rdf\t{rdf}")
    if temp:
        text = text.replace("temperature 298.0", f"temperature {temp}")
    with open(path, "w") as f:
        f.write(text)


# the JAX ring's list regimes on small gases (the decks of
# tests/test_torch_runner_rdf_list.py): (writer arguments, load keywords,
# the plan's name (bench.plan_name), the full rebuilds and refines of
# JAX's ring in PLAN_STEPS steps: one window of 2 stat periods of 200
# steps, 4 RDF blocks each)
PLAN_REGIMES = {
    "rdf_from_outer": ((3000, 2.69e-5), {}, "from_outer",
                       {"rebuild": 1, "refine": 8}),
    "rdf_covers_outer": ((2000, 1e-3), {}, "list_covers_outer",
                         {"rebuild": 0, "refine": 8}),
    "refine_blocks": ((2000, 1e-3, "14.75", 10.0), {}, "list",
                      {"rebuild": 2, "refine": 8}),
    "gather": ((1000, 3e-4), {"pair_engine": "gather"}, "list",
               {"rebuild": 0, "refine": 0}),
}


def rdf_plan_phase(torch, dev, out, card):
    """Each list regime of the plan on the card: PLAN_STEPS f32 steps
    replayed from CUDA graphs (the RDF list program and the list samples
    among them) against as many eager steps from the same deck: the plan
    named, the rebuilds and refines of JAX's ring, every sample taken by
    the list sampler, stat.dat and rdf.dat rows alike, final positions
    within TRAJ_POS_ATOL.  Returns the numbers."""
    from aztotmd_tpu_torch.bench import plan_name
    from aztotmd_tpu_torch.ops import rdf as ops_rdf
    from aztotmd_tpu_torch.runtime import step as step_mod
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    phase(f"the RDF plan's regimes: {PLAN_STEPS} f32 steps replayed vs "
          "eager on small argon gases")
    res = {}
    for name, (args, load_kw, want_plan, want) in PLAN_REGIMES.items():
        deck = os.path.join(out, "plan_" + name)
        gas_variant(deck, *args)
        runs = {}
        for graph in (None, False):
            o = os.path.join(out, f"plan_{name}_{graph}")
            r = MDRunner(load_deck_dir(deck, device=dev, **load_kw),
                         out_dir=o, quiet=True, graph=graph)
            step_mod.nbr_counts.update(rebuild=0, refine=0)
            ops_rdf.rdf_counts.update({k: 0 for k in ops_rdf.rdf_counts})
            r.run(PLAN_STEPS)
            r.finalize()
            runs[graph] = (r, o, dict(step_mod.nbr_counts),
                           dict(ops_rdf.rdf_counts))
        (g, og, cg, sg), (e, oe, ce, se) = runs[None], runs[False]
        n_samples = PLAN_STEPS // g.p_rdf
        dpos = float((g.state.pos - e.state.pos).abs().max())
        ta, tb = (read_table(os.path.join(o, "stat.dat"), 2)
                  for o in (og, oe))
        ra, rb = (read_table(os.path.join(o, "rdf.dat"), 1)
                  for o in (og, oe))
        dstat = max(abs(a - b) / (abs(b) + 1e-6) for x, y in zip(ta, tb)
                    for a, b in zip(x, y))
        drdf = max(abs(x[1] - y[1]) for x, y in zip(ra, rb))
        log(f"  {name}: {g.cfg.n_at} atoms, plan {plan_words(g)}, "
            f"refine_blocks {g._ring_plan['refine_blocks']}; rebuilds "
            f"{cg['rebuild']} refines {cg['refine']} replayed, "
            f"{ce['rebuild']} / {ce['refine']} eager (JAX's ring: {want}); "
            f"samples {sg} replayed on {card}; max|dpos| {dpos:.3e} A, "
            f"stat.dat rows within rel {dstat:.2e}, rdf.dat g within "
            f"{drdf:.3e}")
        check(plan_name(g) == want_plan
              and g._ring_plan["refine_blocks"] == (not load_kw)
              and cg == ce == want and sg == se
              and sg["list"] == n_samples
              and sg["cells"] == sg["allpairs"] == 0,
              f"{name}: the plan, its cadence or its sampler differs")
        check(dpos <= TRAJ_POS_ATOL and len(ta) == len(tb)
              and len(ra) == len(rb) and max(x[1] for x in ra) > 0,
              f"{name}: the replayed plan left the eager run")
        res[name] = {"max_dpos": dpos, "stat_rel": dstat, "rdf_abs": drdf}
        del runs, g, e
        _free(torch)
    return res


def neighbor_run_checks(torch, runner, cfg0, name):
    """The Verlet-list checks of a run: no skin violation, every monitor
    within the capacity it ends with (a capacity that grew was regrown by
    the runner, which warns on stderr), every atom still there."""
    st, cfg = runner.state, runner.cfg
    viol = int(st.nbr_viol)
    mon = {"nbr_over": (int(st.nbr_over), cfg.n_neigh, cfg0.n_neigh),
           "nbr2_over": (int(st.nbr2_over), cfg.n_neigh2, cfg0.n_neigh2),
           "cell_overflow": (int(st.cell_overflow), cfg.nb_grid.cap,
                             cfg0.nb_grid.cap)}
    if cfg.nb_rowcap:
        mon["nbrow_over"] = (int(st.nbrow_over), cfg.nb_rowcap,
                             cfg0.nb_rowcap)
    log(f"  {name}: nbr_viol {viol}; monitors (seen, capacity at the end, "
        f"at the start): {mon}")
    check(viol == 0, f"{name}: neighbor-skin violations")
    for k, (seen, cap, _) in mon.items():
        check(seen <= cap, f"{name}: {k} {seen} past its capacity {cap}")
    n = int(st.spec_number.sum())
    check(n == cfg.n_at and bool(torch.isfinite(st.pos).all()),
          f"{name}: atoms lost or not finite ({n} of {cfg.n_at})")


def neighbor_phases(torch, dev, out, cli, counters, card, profile):
    """The Verlet-list engine (no Pallas kernel on its path, so no pair
    kernel and no pair-kernel launch either): examples/argon_gas and
    examples/bonded_fluid through the run CLI, the two-level schedule on
    argon_gas over 2*Q*R bare steps with its rebuilds and refines counted,
    20 steps on the card against 20 on the CPU, the first build's lists
    equal, the list passes and a step timed with CUDA events, and a
    50-step profile.  Returns the numbers it measured."""
    from aztotmd_tpu_torch.ops import angles, neighbors as nbr
    from aztotmd_tpu_torch.runtime import graph as graph_mod
    from aztotmd_tpu_torch.runtime import step as step_mod
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    res = {}

    phase(f"neighbor engine: argon_gas ({GAS_STEPS} steps) and "
          f"bonded_fluid ({BONDED_STEPS}) through the run CLI")
    for nm, deck, steps in (("argon_gas", GAS_DECK, GAS_STEPS),
                            ("bonded_fluid", BONDED_DECK, BONDED_STEPS)):
        cfg0 = load_deck_dir(deck, device="cpu")["cfg"]
        check(cfg0.pair_engine == "neighbor", f"{nm} is not on the neighbor "
              "engine")
        log(f"  {nm}: N={cfg0.n_at} R={cfg0.nb_rebuild} Q={cfg0.nb_outer} "
            f"K={cfg0.n_neigh} K2={cfg0.n_neigh2} rowcap={cfg0.nb_rowcap} "
            f"nb_grid {cfg0.nb_grid.dims} cap {cfg0.nb_grid.cap}, sorted "
            f"build {nbr.sorted_build_ok(cfg0)}")
        step_mod.nbr_counts.update(rebuild=0, refine=0)
        graph_mod.capture_counts.update(state=0, sample=0)
        runner, launches, rate = drive(cli, counters, nm, deck,
                                       os.path.join(out, nm), steps)
        check(launches == expected_launches(counters, runner, None),
              f"{nm}: a pair kernel ran on the neighbor path, or a step "
              "did not launch the thermostat kernel")
        got = dict(step_mod.nbr_counts)
        caps = dict(graph_mod.capture_counts)
        log(f"  plan: {plan_words(runner)} ({runner._ring_plan})")
        if nm == "argon_gas":
            # JAX's plan for it (tests/test_torch_runner_rdf_list.py)
            check(runner._ring_plan.get("rdf_from_outer")
                  and runner._ring_plan["k_super"] == 4,
                  "argon_gas does not take JAX's rdf_from_outer plan")
            log(f"  list rebuilds {got['rebuild']}, refines "
                f"{got['refine']}: the JAX stat ring's cadence, its window "
                f"of {steps // runner.p_stat} stat periods of "
                f"{runner.p_stat} steps, one refine per RDF block of "
                f"{runner.p_rdf} (expected {GAS_RING['rebuild']} and "
                f"{GAS_RING['refine']})")
            check(got == GAS_RING, f"{nm}: the CLI ran another cadence")
        else:
            log(f"  list rebuilds {got['rebuild']}, refines "
                f"{got['refine']} (no ring cadence on this deck: each RDF "
                f"block of {runner.p_rdf} steps restarts the schedule)")
        log(f"  CUDA-graph captures: {caps['state']} of the step programs, "
            f"{caps['sample']} of the RDF sample")
        neighbor_run_checks(torch, runner, cfg0, nm)
        res[nm + "_steps_per_s"] = rate
        res[nm + "_rebuilds"] = got["rebuild"]
        res[nm + "_refines"] = got["refine"]
        if nm == "argon_gas":
            res["argon_gas_rdf"] = rdf_list_case(torch, nm, runner, card)
        if nm == "bonded_fluid":
            rows = read_table(os.path.join(out, nm, "stat.dat"), 2)
            check(all(r[8] != 0.0 for r in rows), "engAngle is zero")
            with open(os.path.join(deck, "angles.txt")) as f:
                n_in = int(f.readline())
            with open(os.path.join(out, nm, "revangles.txt")) as f:
                lines = f.read().splitlines()
            check(int(lines[0]) == n_in and len(lines) == n_in + 1,
                  "revangles.txt does not list the deck's angles")
            log(f"  engAngle {rows[0][8]:.4f} .. {rows[-1][8]:.4f} eV; "
                f"revangles.txt lists {n_in} angles, as angles.txt")
            # the stat ring reads the monitors one window late, as JAX's:
            # the run's one window regrows K at its end
            check(runner.cfg.n_neigh != cfg0.n_neigh,
                  "bonded_fluid: no regrow")
            eo = os.path.join(out, nm + "_eager")
            er = MDRunner(load_deck_dir(deck, device=dev), out_dir=eo,
                          quiet=True, graph=False)
            er.run(steps)
            er.finalize()
            from aztotmd_tpu_torch.runtime.graph import state_leaves
            ga, ea = dict(state_leaves(runner.state)), dict(
                state_leaves(er.state))
            differ = [k for k in ea if not ea[k].is_floating_point()
                      and not torch.equal(ga[k], ea[k])]
            dpos = float((ga["pos"] - ea["pos"]).abs().max())
            erows = read_table(os.path.join(eo, "stat.dat"), 2)
            drow = max(abs(a - b) for ra, rb in zip(rows, erows)
                       for a, b in zip(ra, rb))
            log(f"  bonded_fluid graph run against an eager run "
                f"(graph=False), {steps} steps: regrown K equal "
                f"({er.cfg.n_neigh}), integer fields "
                f"{'equal' if not differ else differ}, max|dpos| {dpos:.3e}"
                f" A, stat.dat rows within {drow:.3e}")
            check(er.cfg.n_neigh == runner.cfg.n_neigh and not differ
                  and dpos <= GRAPH_POS_ATOL and len(erows) == len(rows),
                  "bonded_fluid: the graph run left the eager run")
            # the regrow rebuilt the programs: the next window replays
            # them captured over the regrown lists (its rows are not
            # decoded: the run's writers are closed)
            runner._ring(1)
            g = runner.multi.graphs
            check(bool(g.programs) and g.state.nbr_idx.shape[1]
                  == runner.cfg.n_neigh, "bonded_fluid: the next window "
                  "did not replay programs captured after the regrow")
            log(f"  regrow K {cfg0.n_neigh} -> {runner.cfg.n_neigh} at the "
                f"end of the run's window; the next window replays "
                f"{len(g.programs)} programs captured over (N, "
                f"{g.state.nbr_idx.shape[1]}) lists")
    log(f"neighbor engine steps/s on {card}: argon_gas "
        f"{res['argon_gas_steps_per_s']:.1f}, bonded_fluid "
        f"{res['bonded_fluid_steps_per_s']:.1f}")

    d = load_deck_dir(GAS_DECK, device=dev)
    cfg, ff, aux = d["cfg"], d["ff"], d["aux"]
    Q, R = cfg.nb_outer, cfg.nb_rebuild
    n2 = 2 * Q * R
    phase(f"two-level schedule on argon_gas: make_multi_step over 2*Q*R = "
          f"{n2} bare steps")
    multi = step_mod.make_multi_step(cfg, aux)
    step_mod.nbr_counts.update(rebuild=0, refine=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = multi(d["state"], ff, n2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(step_mod.nbr_counts)
    log(f"  {n2} steps in {wall:.2f} s ({n2 / wall:.1f} steps/s on {card}); "
        f"full rebuilds {got['rebuild']}, refines {got['refine']} "
        f"(expected 2 and {2 * (Q - 1)})")
    check(got == {"rebuild": 2, "refine": 2 * (Q - 1)},
          "the two-level schedule ran another count of rebuilds/refines")
    viol = int(st.nbr_viol)
    log(f"  nbr_viol {viol}, nbr_over {int(st.nbr_over)} of {cfg.n_neigh}, "
        f"nbr2_over {int(st.nbr2_over)} of {cfg.n_neigh2}, nbrow_over "
        f"{int(st.nbrow_over)} of {cfg.nb_rowcap}, cell occupancy "
        f"{int(st.cell_overflow)} of {cfg.nb_grid.cap}")
    check(viol == 0 and int(st.nbr_over) <= cfg.n_neigh
          and int(st.nbr2_over) <= cfg.n_neigh2
          and int(st.nbrow_over) <= cfg.nb_rowcap
          and int(st.cell_overflow) <= cfg.nb_grid.cap,
          "a monitor of the two-level run is past its capacity")
    check(bool(torch.isfinite(st.pos).all()), "two-level run not finite")
    res["two_level_steps_per_s"] = n2 / wall

    phase("neighbor engine: 20 steps on the card vs 20 on the CPU from the "
          f"same state (positions within {TRAJ_POS_ATOL} A; the first "
          "build's lists equal as sets per row, and in order from the "
          "sorted build)")
    for nm, deck, dtype in (("argon_gas", GAS_DECK, "f64"),
                            ("bonded_fluid", BONDED_DECK, "f32"),
                            ("argon_gas", GAS_DECK, "f32")):
        sides = []
        for where in (dev, torch.device("cpu")):
            dd = load_deck_dir(deck, device=where, dtype=dtype)
            first = step_mod.rebuild_neighbors_state(dd["cfg"], dd["state"])
            s = step_mod.make_multi_step(dd["cfg"], dd["aux"])(
                dd["state"], dd["ff"], 20)
            sides.append((first, s))
        c = dd["cfg"]
        (fa, sa), (fb, sb) = sides
        for key in ("nbr_idx", "nbr2_idx"):
            a, b = getattr(fa, key).cpu(), getattr(fb, key)
            sa_ = [set(r[r < c.n_at].tolist()) for r in a]
            sb_ = [set(r[r < c.n_at].tolist()) for r in b]
            diff = sum(x != y for x, y in zip(sa_, sb_))
            order = int((a != b).any(1).sum())
            log(f"  {nm} {dtype} first build {key}: {diff} rows differ as "
                f"sets, {order} in order (of {c.n_at}; "
                f"{int((a < c.n_at).any(1).sum())} rows with a neighbor)")
            check(diff == 0, f"{nm}: the card's {key} differs as sets")
            if nbr.sorted_build_ok(c):
                check(order == 0, f"{nm}: the card's {key} differs in order")
        dpos = float((sa.pos.cpu() - sb.pos).abs().max())
        far = float(sb.pos.abs().max())
        ulp = float(torch.finfo(sb.pos.dtype).eps) * 2.0 ** int(
            math.log2(max(c.box)))
        log(f"  {nm} {dtype}: max|dpos| {dpos:.3e} A after 20 steps "
            f"(limit {TRAJ_POS_ATOL}; one {dtype} ulp at the box edge "
            f"{max(c.box):.1f} A is {ulp:.2e} A, coordinates up to "
            f"{far:.1f} A); nbr_viol {int(sa.nbr_viol)} vs {int(sb.nbr_viol)}")
        if dtype == "f32" and nm == "argon_gas":
            # positions to 1,141 A: a rounding that lands one f32 ulp
            # apart (1.2e-4 A past 1,024 A) is the format's resolution
            check(dpos <= max(TRAJ_POS_ATOL, 2 * ulp),
                  f"{nm} f32: card and CPU trajectories diverge")
        else:
            check(dpos <= TRAJ_POS_ATOL,
                  f"{nm} {dtype}: card and CPU trajectories diverge")

    phase("neighbor engine timing (CUDA events, medians) on argon_gas and "
          "bonded_fluid")
    st = step_mod.rebuild_neighbors_state(cfg, d["state"])
    ocfg = dataclasses.replace(cfg, n_neigh=cfg.n_neigh2,
                               nb_skin=cfg.nb_skin2)

    def outer_build():
        i2, k2, _, _ = nbr.build_neighbors_keys(ocfg, st.pos)
        return nbr.prefix_refine(i2, k2, cfg.r_max + cfg.nb_skin,
                                 cfg.n_neigh, cfg.n_at)

    step1 = step_mod.make_step(cfg, aux, nbr_auto_rebuild=False)
    fns = {"outer build (build_neighbors_keys + prefix_refine)": outer_build,
           "full rebuild (rebuild_neighbors_state)":
               lambda: step_mod.rebuild_neighbors_state(cfg, st),
           "refine_neighbors_rows": lambda: nbr.refine_neighbors_rows(
               cfg, st.pos, st.nbr2_idx, cfg.nb_rowcap),
           "inner refine (refine_neighbors_state)":
               lambda: step_mod.refine_neighbors_state(cfg, st),
           "pair_forces_rows": lambda: nbr.pair_forces_rows(
               cfg, ff, st.pos, st.types, st.nbrow_idx),
           "pair_forces_neighbors (dense walk)":
               lambda: nbr.pair_forces_neighbors(cfg, ff, st.pos, st.types,
                                                 st.nbr_idx),
           "bare step": lambda: step1(st, ff)}
    counts0 = dict(step_mod.nbr_counts)
    ms = dict(zip(fns, timed(torch, list(fns.values()), n=10)))
    step_mod.nbr_counts.update(counts0)
    n_rows = int((st.nbrow_idx[:, 0] < cfg.n_at).sum())
    for k, v in ms.items():
        log(f"  argon_gas {k}: {v:.4f} ms on {card}")
    log(f"  argon_gas lists: {n_rows} occupied rows of rowcap "
        f"{cfg.nb_rowcap}, outer entries "
        f"{int((st.nbr2_idx < cfg.n_at).sum())} in (N, K2) = "
        f"({cfg.n_at}, {cfg.n_neigh2}), inner entries "
        f"{int((st.nbr_idx < cfg.n_at).sum())}")
    rb, rf = ms["full rebuild (rebuild_neighbors_state)"], \
        ms["inner refine (refine_neighbors_state)"]
    sched = (rb + (Q - 1) * rf) / (Q * R)
    cli_cost = (rb + 4 * rf) / 200.0
    log(f"  list cost a step (eager pass times): the CLI's ring cadence (a "
        f"full rebuild each 200-step stat period, a refine each 50-step "
        f"RDF block) {cli_cost:.4f} ms/step (a rebuild every 50 steps, "
        f"each RDF block restarting the schedule: {rb / 50.0:.4f}); the "
        f"two-level schedule (one "
        f"rebuild and {Q - 1} refines per {Q * R} steps) {sched:.4f} "
        f"ms/step; a bare step {ms['bare step']:.4f} ms")
    res.update({k: v for k, v in ms.items()})
    res["cli_rebuild_ms_per_step"] = cli_cost
    res["schedule_list_ms_per_step"] = sched

    db = load_deck_dir(BONDED_DECK, device=dev)
    sb = step_mod.rebuild_neighbors_state(db["cfg"], db["state"])
    am = timed(torch, [lambda: angles.apply_angles(db["cfg"], db["ff"], sb),
                       lambda: step_mod.make_step(
                           db["cfg"], db["aux"], nbr_auto_rebuild=False)(
                               sb, db["ff"])], n=10)
    log(f"  bonded_fluid apply_angles ({int(sb.n_angle)} angles): "
        f"{am[0]:.4f} ms; bare step {am[1]:.4f} ms on {card}")
    res["apply_angles_ms"], res["bonded_fluid_step_ms"] = am

    phase("neighbor engine profiles: argon_gas and bonded_fluid, 50 bare "
          "steps (the call's full rebuild first), eager and replayed")
    profile(GAS_DECK, graph=False)
    by = profile(GAS_DECK)
    profile(BONDED_DECK, graph=False)
    profile(BONDED_DECK)
    if by is not None:
        n_k = sum(c for name, (_, c) in by.items()
                  if not name.startswith(("Memcpy", "Memset")))
        log(f"  argon_gas: {n_k / PROFILE_STEPS:.1f} device kernels a "
            "replayed step (torch ops; none of the port's CUDA kernels)")
        res["kernels_a_step"] = n_k / PROFILE_STEPS
    return res


def scale_phases(torch, dev, out, cli, counters, card):
    """The RDF plan's regimes, the JAX system's scale, dilute and NVE paths
    (the decks of its tools), its last pair engine and the headline
    bench, each with its gates; returns their numbers."""
    _zero(counters)
    res = {"rdf_plan": rdf_plan_phase(torch, dev, out, card)}
    _no_launch(counters, "the RDF plan's regimes")
    res["scale"] = scale_phase(torch, dev, out, cli, counters, card)
    res["dilute"] = dilute_phase(torch, dev, out, counters, card)
    res["nve"] = nve_phase(torch, dev, out, cli, card)
    res["gather"] = gather_phase(torch, dev, counters, card)
    res["bench"] = bench_phase(torch, card)
    return res


def _free(torch):
    """Release what the last phase left in the caching allocator."""
    import gc
    gc.collect()
    torch.cuda.synchronize()      # (and initialises the allocator)
    torch.cuda.empty_cache()


def _zero(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _no_launch(counters, what):
    """No pair kernel ran (the thermostat's runs on every path under the
    radiative thermostat)."""
    check(all(getattr(mod, attr) == 0 for k, (mod, attr) in counters.items()
              if k != "tstat"),
          f"{what}: a pair kernel ran on a path that has none")


def expected_launches(counters, runner, kern):
    """The launch counts a run of ``runner`` must show: its steps for its
    pair kernel ``kern`` (None: a pass in torch ops) and, under the
    radiative thermostat, for csrc/tstat.cu; 0 for every other kernel."""
    from aztotmd_tpu_torch.io.control import TSTAT_RADI
    ran = {kern, "tstat" if runner.cfg.tstat_type == TSTAT_RADI else None}
    return {k: (runner.steps_run if k in ran else 0) for k in counters}


def scale_phase(torch, dev, out, cli, counters, card):
    """The tiled argon decks of ``tools/make_bigdeck.py``
    (``systems.write_scale_argon_deck`` of examples/argon_gas: 320,000 and
    1,080,000 atoms at case study 1's density), bare replayed steps of
    the multi-step and a run through the CLI each: no pair kernel launched,
    finite stat.dat, non-zero rdf.dat from the RDF cell path, no atom
    lost, no skin violation, every list monitor within its capacity after
    any regrow, the JAX stat ring's cadence counted.  Returns the numbers
    it measured."""
    from aztotmd_tpu_torch import bench, systems
    from aztotmd_tpu_torch.runtime import graph as graph_mod
    from aztotmd_tpu_torch.runtime import step as step_mod
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    res = {}
    for tiles, steps in SCALE_STEPS.items():
        deck = os.path.join(out, f"argon_scale_x{tiles}")
        t0 = time.perf_counter()
        n = systems.write_scale_argon_deck(deck, tiles, steps=steps)
        write_s = time.perf_counter() - t0
        tag = f"argon_gas x{tiles}^3 ({n} atoms)"
        phase(f"scale: {tag}: {SCALE_BARE[tiles]} bare replayed steps, "
              f"then {steps} steps through the run CLI")
        _free(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        sysd = load_deck_dir(deck, device=dev)
        setup_s = time.perf_counter() - t0
        cfg0 = sysd["cfg"]
        g = cfg0.nb_grid
        log(f"  {tag}: box {cfg0.box[0]:.1f} A; load_deck_dir {setup_s:.1f}"
            f" s, deck written in {write_s:.1f} s; R={cfg0.nb_rebuild} "
            f"Q={cfg0.nb_outer} K={cfg0.n_neigh} K2={cfg0.n_neigh2} "
            f"rowcap={cfg0.nb_rowcap} orowcap={cfg0.nb_orowcap}; nb_grid "
            f"{g.dims} cap {g.cap}: candidate matrix {n} x "
            f"{len(g.stencil) * g.cap}")
        check(cfg0.pair_engine == "neighbor" and cfg0.n_at == n,
              f"{tag}: not the Verlet-list engine")
        _zero(counters)
        bare = bench.measure(sysd, SCALE_BARE[tiles], 1, graph=True)
        bare_peak = torch.cuda.max_memory_allocated(dev)
        bare_rate = bare["steps_per_sec"]
        _no_launch(counters, tag)
        log(f"  bare: {bare_rate:.1f} replayed steps/s over "
            f"{SCALE_BARE[tiles]} steps after {SCALE_BARE[tiles]} to warm "
            f"up and capture ({bare['warm_s']:.1f} s, capture "
            f"{bare['capture_s']:.2f} s, {bare['nodes']} graph nodes a "
            f"step); peak memory {bare_peak / 2**30:.2f} GiB")
        del sysd, bare
        _free(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        step_mod.nbr_counts.update(rebuild=0, refine=0)
        graph_mod.capture_counts.update(state=0, sample=0)
        o = os.path.join(out, f"scale_x{tiles}")
        t0 = time.perf_counter()
        runner = cli(["run", deck, "--steps", str(steps), "-o", o,
                      "--quiet"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        rate = runner.steps_run / runner.loop_seconds
        got = dict(step_mod.nbr_counts)
        caps = dict(graph_mod.capture_counts)
        cap_s = sum(p.capture_seconds
                    for p in runner.multi.graphs.programs.values())
        check(runner.steps_run == steps, f"{tag}: the run stopped early")
        _no_launch(counters, tag)
        ring_counts(runner, tag, steps, rate)
        want = SCALE_RING[tiles]
        check(runner._ring_plan["rdf_from_outer"] and got == want,
              f"{tag}: the CLI ran another cadence {got} (JAX's ring: "
              f"{want}; plan {runner._ring_plan})")
        rows = read_table(os.path.join(o, "stat.dat"), 2)
        check(len(rows) == steps // runner.p_stat and all(
            all(v == v and abs(v) < 1e30 for v in r) for r in rows),
            f"{tag}: stat.dat rows missing or not finite")
        with open(os.path.join(o, "rdf.dat")) as f:
            gr = [float(ln.split()[1]) for ln in f.readlines()[1:]]
        rc = runner.rcfg
        check(len(gr) == rc.n_bin and max(gr) > 0.0,
              f"{tag}: rdf.dat empty or zero")
        neighbor_run_checks(torch, runner, cfg0, tag)
        log(f"  run: {steps} steps in {runner.loop_seconds:.2f} s loop "
            f"({wall:.1f} s with setup and outputs): {rate:.1f} steps/s; "
            f"list rebuilds {got['rebuild']}, refines {got['refine']} "
            f"(JAX's ring: {want}); plan: {plan_words(runner)}; captures "
            f"{caps['state']} of the step programs ({cap_s:.2f} s), "
            f"{caps['sample']} of the RDF samples; stat.dat {len(rows)} "
            f"finite rows, last engTot {rows[-1][2]:.4f} eV engKin "
            f"{rows[-1][3]:.4f} eV; rdf.dat highest g {max(gr):.3f}")
        rdf = rdf_list_case(torch, tag, runner, card)
        log(f"scale {tag} on {card}: setup {setup_s:.1f} s, capture "
            f"{cap_s:.2f} s, CLI {rate:.1f} steps/s, bare replayed "
            f"{bare_rate:.1f} steps/s, rebuilds {got['rebuild']} and "
            f"refines {got['refine']} in {steps} steps, peak memory "
            f"{peak / 2**30:.2f} GiB through the CLI, {bare_peak / 2**30:.2f}"
            " GiB bare (torch.cuda.max_memory_allocated)")
        res[f"x{tiles}"] = dict(
            n_at=n, setup_s=setup_s, write_s=write_s, capture_s=cap_s,
            cli_steps_per_s=rate, bare_steps_per_s=bare_rate,
            rebuilds=got["rebuild"], refines=got["refine"],
            peak_gib=peak / 2**30, bare_peak_gib=bare_peak / 2**30,
            rdf=rdf)
        del runner
        _free(torch)
    return res


def dilute_phase(torch, dev, out, counters, card):
    """The dilute deck of ``tools/make_dilute_deck.py``
    (``systems.write_dilute_argon_deck``: examples/argon_gas scaled 3x,
    1.0e-6 atoms/A^3), whose configuration sets ``nb_orowcap``: replayed
    multi-steps with the outer-row-compacted refine and without it
    (``nb_orowcap`` 0), one after the other, their inner lists equal
    exactly after each of OROW_REFINES refines; both rates and the
    refine's ms; then a run whose ``nb_orowcap`` is forced to the row
    capacity, below the outer-occupied count: the runner warns, regrows,
    rebuilds and recaptures, and afterwards the refine over the
    outer-occupied rows still gives the lists of the refine over all
    rows.  Returns the numbers it measured."""
    import contextlib
    import io
    from aztotmd_tpu_torch import bench, systems
    from aztotmd_tpu_torch.runtime import graph as graph_mod
    from aztotmd_tpu_torch.runtime import step as step_mod
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    deck = os.path.join(out, "argon_dilute")
    systems.write_dilute_argon_deck(deck)
    d = load_deck_dir(deck, device=dev)
    cfg, ff = d["cfg"], d["ff"]
    N, R, Q = cfg.n_at, cfg.nb_rebuild, cfg.nb_outer
    phase(f"dilute and orow: the dilute deck ({N} atoms, box "
          f"{cfg.box[0]:.1f} A) with nb_orowcap {cfg.nb_orowcap} and with "
          f"0: {OROW_REFINES} refines, the inner lists equal after each")
    check(cfg.pair_engine == "neighbor" and cfg.nb_rowcap
          and cfg.nb_rowcap <= cfg.nb_orowcap < N,
          "the dilute deck does not take the outer-row-compacted refine")
    res, lists = {}, {}
    counts0 = dict(step_mod.nbr_counts)
    for oc in (cfg.nb_orowcap, 0):
        c = dataclasses.replace(cfg, nb_orowcap=oc)
        _zero(counters)
        seen = []
        run, current = step_mod.make_multi_step(c, d["aux"]).start(
            d["state"], ff)
        run("rebuild")
        for _ in range(OROW_REFINES):
            run("refine")
            run("step", R)
            s = current()
            seen.append((s.nbr_idx.clone(), s.nbrow_idx.clone(),
                         s.nbr_over.clone(), s.nbrow_over.clone(),
                         s.orow_over.clone()))
        lists[oc] = seen
        m = bench.measure(dict(d, cfg=c), Q * R, 1, graph=True)
        _no_launch(counters, f"dilute deck, nb_orowcap {oc}")
        st = step_mod.rebuild_neighbors_state(c, d["state"])
        refine = lambda s, ff_: step_mod.refine_neighbors_state(c, s)
        static, scratch = graph_mod.clone_state(st), graph_mod.clone_state(st)
        prog = graph_mod.Program(
            "refine", lambda: graph_mod.advance_in_place(refine, static, ff),
            lambda: refine(scratch, ff), dev)
        eager_ms, replay_ms = timed(torch, [lambda: refine(st, ff),
                                            prog.replay], n=10)
        res[f"orowcap_{oc}"] = dict(
            replayed_steps_per_s=m["steps_per_sec"], refine_ms=eager_ms,
            refine_replayed_ms=replay_ms,
            outer_rows=int(st.orow_over) if oc else None)
        log(f"  nb_orowcap {oc}: {m['steps_per_sec']:.1f} replayed steps/s "
            f"over Q*R = {Q * R} steps (1 rebuild, {Q - 1} refines); the "
            f"refine {eager_ms:.4f} ms eager, {replay_ms:.4f} ms replayed "
            f"(CUDA events); outer-occupied rows "
            f"{int(st.orow_over) if oc else 'not compacted'} of {N}, "
            f"outer entries {int((st.nbr2_idx < N).sum())}, inner entries "
            f"{int((st.nbr_idx < N).sum())}, occupied rows "
            f"{int((st.nbrow_idx[:, 0] < N).sum())} on {card}")
        del st, static, scratch, prog
    step_mod.nbr_counts.update(counts0)
    for k, (a, b) in enumerate(zip(lists[cfg.nb_orowcap], lists[0])):
        same = all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
        log(f"  refine {k + 1}: nbr_idx, nbrow_idx, nbr_over, nbrow_over "
            f"{'equal' if same else 'DIFFER'} ({int((a[0] < N).sum())} "
            f"inner entries, outer-occupied rows {int(a[4])})")
        check(same, f"dilute deck: refine {k + 1}'s lists differ with and "
              "without nb_orowcap")
    check(len(lists[0]) == OROW_REFINES >= 5, "too few refines compared")
    # at 1.0e-6 atoms/A^3 few rows have an inner neighbor: refine the
    # outer lists again with every atom moved up to 6 A (seeded), which
    # brings outer pairs into the inner reach
    import numpy as np
    st = step_mod.rebuild_neighbors_state(cfg, d["state"])
    rng = np.random.default_rng(4)
    moved = st.pos + torch.as_tensor(
        rng.uniform(-6.0, 6.0, tuple(st.pos.shape)), dtype=st.pos.dtype,
        device=dev)
    moved = st.replace(pos=torch.remainder(moved, torch.tensor(
        cfg.box, dtype=st.pos.dtype, device=dev)))
    a = step_mod.refine_neighbors_state(cfg, moved)
    b = step_mod.refine_neighbors_state(
        dataclasses.replace(cfg, nb_orowcap=0), moved)
    same = all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
        "nbr_idx", "nbrow_idx", "nbr_over", "nbrow_over"))
    n_in = int((a.nbr_idx < N).sum())
    log(f"  atoms moved up to 6 A: the refine over the {int(st.orow_over)}"
        f" outer-occupied rows and over all rows give "
        f"{'equal' if same else 'DIFFERENT'} lists ({n_in} inner entries, "
        f"{int((a.nbrow_idx[:, 0] < N).sum())} occupied rows)")
    check(same and n_in > 0, "dilute deck: the moved atoms' lists differ "
          "with and without nb_orowcap, or are empty")
    step_mod.nbr_counts.update(counts0)
    del st, moved, a, b

    small = cfg.nb_rowcap
    sysd = load_deck_dir(deck, device=dev)
    sysd["cfg"] = dataclasses.replace(cfg, nb_orowcap=small)
    sysd["state"] = sysd["state"].replace(orow_idx=torch.full(
        (small,), N, dtype=torch.int32, device=dev))
    graph_mod.capture_counts.update(state=0, sample=0)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        r = MDRunner(sysd, out_dir=os.path.join(out, "dilute_regrow"),
                     quiet=True)
        # the regrow comes at the end of the first window (the stat
        # ring's lag); the second run recaptures
        r.run(400)
        r.run(600)
        r.finalize()
    warn = [ln for ln in err.getvalue().splitlines()
            if ln.startswith("WARNING")]
    caps = graph_mod.capture_counts["state"]
    log(f"  forced nb_orowcap {small}: {warn}; nb_orowcap {small} -> "
        f"{r.cfg.nb_orowcap}; the step programs captured {caps} times")
    check(any(w.startswith("WARNING: outer-occupied row count") and
              f"capacity {small}; rebuilding with orowcap="
              f"{r.cfg.nb_orowcap}" in w for w in warn)
          and r.cfg.nb_orowcap > small and caps >= 2
          and int(r.state.orow_over) <= r.cfg.nb_orowcap,
          "dilute deck: no orow regrow, or no recapture after it")
    st = graph_mod.clone_state(r.state)
    a = step_mod.refine_neighbors_state(r.cfg, st)
    b = step_mod.refine_neighbors_state(
        dataclasses.replace(r.cfg, nb_orowcap=0), st)
    same = all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
        "nbr_idx", "nbrow_idx", "nbr_over", "nbrow_over"))
    step_mod.nbr_counts.update(counts0)
    log(f"  after the regrow, step {int(st.step)}: the refine over the "
        f"{int(st.orow_over)} outer-occupied rows and over all rows give "
        f"{'equal' if same else 'DIFFERENT'} lists")
    check(same, "dilute deck: the lists differ after the orow regrow")
    res["regrown_orowcap"] = r.cfg.nb_orowcap
    del d, sysd, r, st, a, b
    _free(torch)
    return res


def nve_phase(torch, dev, out, cli, card):
    """The NVE deck of ``tools/make_nve_deck.py``
    (``systems.write_argon_nve_deck``: examples/argon_gas, thermostat
    off, Gaussian velocities at 298 K): NVE_STEPS f32 steps through the
    run CLI and the relative drift of the total energy after NVE_EQUIL
    steps; the gate: NVE_GATE_STEPS f32 and f64 steps of the deck agree
    in total energy to NVE_GATE_REL.  Returns the numbers it measured."""
    from aztotmd_tpu_torch import systems
    from aztotmd_tpu_torch.drift import energy_drift
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    from aztotmd_tpu_torch.runtime.step import make_multi_step
    deck = os.path.join(out, "argon_nve")
    systems.write_argon_nve_deck(deck)
    phase(f"nve: the NVE deck, {NVE_GATE_STEPS} f32 and f64 steps (total "
          f"energy within rel {NVE_GATE_REL}), then {NVE_STEPS} f32 steps "
          "through the run CLI")
    tot = {}
    for dtype in ("f32", "f64"):
        dd = load_deck_dir(deck, device=dev, dtype=dtype)
        s = make_multi_step(dd["cfg"], dd["aux"])(dd["state"], dd["ff"],
                                                   NVE_GATE_STEPS)
        tot[dtype] = float(s.energies.tot)
        del dd, s
    rel = abs(tot["f32"] - tot["f64"]) / abs(tot["f64"])
    log(f"  after {NVE_GATE_STEPS} steps: engTot f32 {tot['f32']:.6f} "
        f"eV, f64 {tot['f64']:.6f} eV, relative difference {rel:.3e} "
        f"(limit {NVE_GATE_REL})")
    check(rel <= NVE_GATE_REL, "nve: f32 and f64 total energies differ")
    _free(torch)
    o = os.path.join(out, "nve")
    runner = cli(["run", deck, "--steps", str(NVE_STEPS), "-o", o,
                  "--quiet"])
    rate = runner.steps_run / runner.loop_seconds
    rows = read_table(os.path.join(o, "stat.dat"), 2)
    check(len(rows) == NVE_STEPS // runner.p_stat and all(
        all(v == v and abs(v) < 1e30 for v in r) for r in rows),
        "nve: stat.dat rows missing or not finite")
    dr = energy_drift(os.path.join(o, "stat.dat"), NVE_EQUIL)
    log(f"nve on {card}: {NVE_STEPS} f32 steps through run at {rate:.1f} "
        f"steps/s; engTot {dr['ref']:.6f} eV at step {dr['ref_step']}, "
        f"{dr['last']:.6f} eV at step {dr['last_step']}: relative drift "
        f"{dr['rel_drift']:.3e}, largest relative deviation "
        f"{dr['rel_max_dev']:.3e} (aztotmd_tpu_torch.drift); engKin "
        f"{rows[0][3]:.4f} -> {rows[-1][3]:.4f} eV")
    del runner
    _free(torch)
    return {"cli_steps_per_s": rate, "rel_drift": dr["rel_drift"],
            "rel_max_dev": dr["rel_max_dev"], "f32_f64_rel": rel}


def gather_phase(torch, dev, counters, card):
    """The "gather" engine (``ops/pairs.py::pair_forces``, torch ops as
    JAX's is XLA) on examples/liquid_argon: GATHER_STEPS eager steps
    against as many of the block engine from the same state (positions
    within GATHER_POS_ATOL), no pair kernel launched, and its bare replayed
    steps/s.  Returns the numbers it measured."""
    from aztotmd_tpu_torch import bench
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    from aztotmd_tpu_torch.runtime.step import make_multi_step
    phase(f"gather: {GATHER_STEPS} steps of liquid_argon on 'gather' vs "
          f"{GATHER_STEPS} on the block engine (within {GATHER_POS_ATOL} "
          "A), bare replayed steps/s")
    runs = {}
    _zero(counters)
    for eng in ("gather", "block"):
        dd = load_deck_dir(ARGON_DECK, device=dev, pair_engine=eng)
        check(dd["cfg"].pair_engine == eng, f"liquid_argon is not on {eng}")
        runs[eng] = (make_multi_step(dd["cfg"], dd["aux"], graph=False)(
            dd["state"], dd["ff"], GATHER_STEPS), dd["cfg"])
    torch.cuda.synchronize()
    (sg, cg), (sb, _) = runs["gather"], runs["block"]
    dpos = float((sg.pos - sb.pos).abs().max())
    e = {k: (float(getattr(sg.energies, k)), float(getattr(sb.energies, k)))
         for k in ("kin", "vdw", "tot")}
    log(f"  {cg.n_at} atoms, grid {cg.grid.dims} cap {cg.grid.cap}: "
        f"candidate matrix {cg.n_at} x {len(cg.grid.stencil) * cg.grid.cap};"
        f" max|dpos| {dpos:.3e} A (limit {GATHER_POS_ATOL}); " + ", ".join(
            f"E{k} {a:.6f} vs {b:.6f}" for k, (a, b) in e.items())
        + f"; fullest cell {int(sg.cell_overflow)} of {cg.grid.cap}")
    check(dpos <= GATHER_POS_ATOL and all(
        abs(a - b) <= TRAJ_ENERGY_REL * abs(b) + 1e-6 for a, b in e.values())
        and int(sg.cell_overflow) == int(sb.cell_overflow),
        "gather and block trajectories differ")
    del runs, sg, sb
    m = bench.measure(load_deck_dir(ARGON_DECK, device=dev,
                                    pair_engine="gather"), 100, 1,
                      graph=True, warm=20)
    _no_launch(counters, "gather")
    log(f"gather on {card}: liquid_argon {m['steps_per_sec']:.1f} bare "
        f"replayed steps/s ({m['nodes']} graph nodes a step)")
    _free(torch)
    return {"max_dpos": dpos, "replayed_steps_per_s": m["steps_per_sec"]}


def bench_phase(torch, card):
    """``python -m aztotmd_tpu_torch.bench`` with BENCH_ARGS in a process
    of its own: exit 0 and one four-key JSON line for each of its two
    decks.  Returns the lines."""
    cmd = [sys.executable, "-m", "aztotmd_tpu_torch.bench"] + BENCH_ARGS
    phase("bench: " + " ".join(cmd[1:]))
    _free(torch)
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    for ln in res.stderr.splitlines():
        if ln.startswith("#") or "Error" in ln or "Traceback" in ln:
            log(f"  bench stderr: {ln}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.strip()]
    for ln in lines:
        log(f"  bench on {card}: {json.dumps(ln)}")
    check(res.returncode == 0 and len(lines) == 2 and all(
        sorted(ln) == ["metric", "unit", "value", "vs_baseline"]
        and ln["value"] > 0 for ln in lines),
        f"bench exited {res.returncode} with {len(lines)} lines")
    return lines


def mesh_system(load_deck_dir, deck, n_dev, dev, **load_kw):
    """(cfg, ff, aux, comm, slab state) of a deck over n_dev slabs on the
    one card."""
    from aztotmd_tpu_torch.parallel import LocalRing, slab
    d = load_deck_dir(deck, device=dev, **load_kw)
    cfg = slab.prepare_slab_cfg(d["cfg"], n_dev)
    comm = LocalRing(n_dev, dev)
    return cfg, d["ff"], d["aux"], comm, slab.make_slab_state(
        cfg, d["state"], comm)


# the port's kernels as torch.profiler names them, and the keys of the
# launch counters (``counters`` in main) of the wrappers that launch them
PROFILED_KERNELS = {"::allpairs_kernel<": ("allpairs", "allpairs_cand"),
                    "::sparse_kernel<": ("sparse", "sparse_cand"),
                    "::cellblock_kernel(": ("cellblock",),
                    "::rect_kernel<": ("allpairs_rect",),
                    "::tstat_radiative_kernel<": ("tstat",)}
# host calls that launch a kernel, as torch.profiler names them
RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")


# device idle shares of the step profiles, by (deck tag, "graph" or
# "eager"), and their device busy time over the wall time of the same
# steps run without the profiler; None where not measured
IDLE = {}
BUSY = {}
# the stat ring's runs: name -> (CLI steps/s, windows, periods a window)
RING_RUNS = {}


def profiled(torch, counters, fn):
    """``fn()`` under torch.profiler, with every launch count set to 0
    just before it and the card synchronised after it.  Returns (wall
    seconds, {device event name: (seconds, events)}, the host's
    kernel-launch calls, the launches of each of the port's kernels that
    the counters saw, the launches of each that the profiler recorded),
    the last two keyed as PROFILED_KERNELS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, host_launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() * 1e-6, c + 1)
        elif e.name in RUNTIME_LAUNCHES:
            host_launches += 1
    ran = {fn_: sum(getattr(*counters[k]) for k in keys)
           for fn_, keys in PROFILED_KERNELS.items()}
    seen = {fn_: sum(c for name, (_, c) in by_name.items() if fn_ in name)
            for fn_ in PROFILED_KERNELS}
    return wall, by_name, host_launches, ran, seen, len(prof.events())


def ring_window(runner, steps):
    """The first ``steps`` steps (whole RDF blocks) of a period of the
    runner's stat-period plan as its loop runs one (``_ring_period``, the
    first of a superblock): the period's length set to ``steps`` for the
    call."""
    p_stat = runner.p_stat
    runner.p_stat = steps
    try:
        runner._ring_period(True)
    finally:
        runner.p_stat = p_stat


def window_plan(runner, rate):
    """[(steps, fn(steps), the loop's name)] of ``launch_window``: a
    window and its retry.  With a stat-period plan (``runner._ring_plan``)
    the window is the main path's loop (``ring_window``): a whole period
    where that takes at most a quarter second at the run's rate, else one
    RDF block.  Where the plan lists or rebuilds, the retry is one block.
    Where its period runs only the step and the cell sample, which are
    the chunk loop's programs, the retry, and the window where even a
    block takes longer, take the chunk loop (``_advance``), as a run
    without a plan does: one stat period where that takes at most a
    quarter second, else 10 steps, or 2 where 10 take over 5 s; the retry
    a fifth of the window."""
    p, quarter = runner.p_stat, rate / 4
    advance = (runner._advance, "_advance")
    ring = (lambda n: ring_window(runner, n), "_ring_period")
    if runner._ring_plan:
        block = runner.p_rdf if runner.fuse_rdf else p
        w = p if p <= quarter else block
        if runner.use_list or "rebuild" in runner.multi.fns:
            return [(w, *ring), (block, *ring)]
        if w <= quarter:
            return [(w, *ring), (max(2, w // 5), *advance)]
    w = p if 0 < p <= quarter else 10 if rate >= 2 else 2
    return [(w, *advance), (max(2, w // 5), *advance)]


def launch_window(torch, runner, counters, name, rate):
    """The launches a run counts on the graph path are worked out: a
    replay adds the launches its capture saw.  Hold them against the
    launches torch.profiler records on the card over a window of the same
    runner's main loop (``window_plan``), and again over the retry's
    window where the profiler kept fewer events than ran.  Fails where
    neither window recorded exactly the launches the counters saw.  The
    state, the histograms and every count are put back afterwards.
    Returns (window steps, launches counted, launches recorded) by
    kernel."""
    from aztotmd_tpu_torch.runtime import graph as graph_mod
    state = graph_mod.clone_state(runner.state)
    hists = [h.clone() for h in (runner.hist, runner.nhist)
             if h is not None]
    rdf_count = runner.rdf_count
    kept = [(h, k, h[k] if isinstance(h, dict) else getattr(h, k))
            for h, k in graph_mod.launch_counters()]
    caps = dict(graph_mod.capture_counts)
    try:
        for steps, window, loop in window_plan(runner, rate):
            _, _, _, ran, seen, _ = profiled(
                torch, counters, lambda: window(steps))
            short = {fn: (seen[fn], ran[fn]) for fn in ran
                     if seen[fn] != ran[fn]}
            log(f"  {name}: launches over a {steps}-step window of the same "
                f"runner ({loop}), counted / recorded by torch.profiler: "
                + ", ".join(f"{fn.strip(':<(')} {ran[fn]} / {seen[fn]}"
                            for fn in ran))
            if not short:
                break
        else:
            check(False, f"{name}: the launch counters disagree with the "
                  "kernel launches torch.profiler recorded")
    finally:
        graph_mod.copy_into(runner.state, state)
        for h, h0 in zip((x for x in (runner.hist, runner.nhist)
                          if x is not None), hists):
            h.copy_(h0)
        runner.rdf_count = rdf_count
        for h, k, v in kept:
            if isinstance(h, dict):
                h[k] = v
            else:
                setattr(h, k, v)
        graph_mod.capture_counts.update(caps)
    return steps, ran, seen


def ring_counts(runner, name, steps, rate):
    """The stat ring of a finished run: one copy of rows to the host a
    window (``HostRows.fetches``) and one decode a window
    (``runner.n_flush``), the windows covering every stat period of the
    run.  Recorded in RING_RUNS for the ring phase's summary."""
    if not runner.ring_ok:
        log(f"  {name}: the host loop (the stat ring's gate fails)")
        return
    fetches, flushes = runner._host_rows.fetches, runner.n_flush
    periods = steps // runner.p_stat
    log(f"  {name}: stat ring, {fetches} windows of {runner.n_fix} stat "
        f"periods (s_cap {runner.s_cap}), {fetches} row copies to the "
        f"host, {flushes} flushes, {runner.n_dispatch} dispatches")
    check(fetches == flushes and fetches * runner.n_fix == periods,
          f"{name}: ring windows {fetches} x {runner.n_fix}, flushes "
          f"{flushes}, stat periods {periods}")
    RING_RUNS[name] = (rate, fetches, runner.n_fix)


def host_row(runner):
    """The host loop's stat values of the runner's state
    (``MDRunner._stat_row``: the energies, momenta, pressure and x1 read
    from the state, the per-species MSD in float64 on the host as
    ``MsdDisplWriter.write_row`` computes it), cast to float32, in the
    ring's float-row layout; and its int row."""
    import numpy as np
    from aztotmd_tpu_torch.runtime import statring
    st = runner._view()
    w = runner.w_msdd
    pos = st.pos.double().cpu().numpy()
    d = pos - w.pos0
    d -= w.box * np.round(d / w.box)
    acc = np.zeros(w.n_spec)
    np.add.at(acc, w.types, np.sum(d * d, axis=1))
    msd = np.divide(acc, w.counts, out=np.zeros_like(acc),
                    where=w.counts > 0)
    f = [float(getattr(st.energies, k)) for k in statring.ENG_KEYS]
    f += st.pos_mom.tolist() + st.neg_mom.tolist()
    f += [float(st.pressure), float(pos[0, 0])] + msd.tolist()
    f += st.bt_r_mean.tolist() + st.bt_lt_mean.tolist()
    i = [int(st.step)] + st.spec_number.tolist()
    i += st.cross_pos.reshape(-1).tolist() + st.cross_neg.reshape(-1).tolist()
    i += [int(st.n_bond), int(st.n_jump), int(st.jump_pos),
          int(st.jump_neg)]
    i += [int(getattr(st, k)) for k in statring.OVER_KEYS]
    i += st.bt_count.tolist()
    return np.asarray(f, np.float32), np.asarray(i, np.int32)


def _same_rows(name, what, msd, ring, host):
    """Ring rows against host rows: int rows exactly, every float column
    within one float32 ulp, the MSD within RING_MSD_REL.  Returns (float
    values 1 ulp apart, largest MSD relative difference)."""
    import numpy as np
    check(len(ring) == len(host) > 0, f"{name}: {len(ring)} ring rows, "
          f"{len(host)} rows of {what}")
    n_diff, rel = 0, 0.0
    for (fr, ir), (fh, ih) in zip(ring, host):
        check(np.array_equal(ir, ih), f"{name}: int rows differ from "
              f"{what}: {ir} against {ih}")
        u = np.abs(fr.view(np.int32).astype(np.int64)
                   - fh.view(np.int32).astype(np.int64))
        u[msd] = 0
        check(int(u.max()) <= 1 and np.array_equal(np.sign(fr),
                                                   np.sign(fh)),
              f"{name}: float rows differ from {what} by {int(u.max())} "
              "ulps")
        n_diff += int((u > 0).sum())
        m = np.abs(fr[msd].astype(np.float64) / fh[msd] - 1.0)
        rel = max(rel, float(np.max(m, initial=0.0)))
    check(rel <= RING_MSD_REL, f"{name}: ring MSD rel {rel:.3e} against "
          f"{what}")
    return n_diff, rel


def ring_rows_case(torch, dev, out, name, deck, no_ring=False):
    """One run of ``deck`` through the ring with the host loop's row taken
    from the state after each period (the check waits for the card
    there): the ring's float32 rows, decoded a window late, against the
    host loop's float32-cast values of the same states (``_same_rows``).
    With ``no_ring`` also a run of the host loop itself
    (``AZTOTMD_NO_RING``, the chunk loop's programs in the ring's order
    on a deck without a list) against the ring's rows.  Returns {what:
    (rows, float values 1 ulp apart, largest MSD relative difference)}."""
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    steps = RING_ROW_STEPS[name]

    def runner_of(tag):
        return MDRunner(load_deck_dir(deck, device=dev), quiet=True,
                        out_dir=os.path.join(out, f"ring_rows_{name}_{tag}"))
    runner = runner_of("ring")
    check(runner.ring_ok, f"{name}: the stat ring's gate fails")
    host, ring = [], []
    period, decode = runner._ring_period, runner._decode_rows

    def period_then_host(full):
        period(full)
        torch.cuda.synchronize()
        host.append(host_row(runner))

    def keep(fr, ir):
        ring.extend(zip(fr.copy(), ir.copy()))
        decode(fr, ir)
    runner._ring_period, runner._decode_rows = period_then_host, keep
    runner.run(steps)
    msd = runner._fsl["msd"]
    res = {"same states": (len(ring),) + _same_rows(
        name, "the same states", msd, ring, host)}
    log(f"  {name}: {len(ring)} ring rows against the host loop's values "
        f"of the same states: int rows equal, {res['same states'][1]} "
        f"float values 1 ulp apart, MSD rel {res['same states'][2]:.3e} "
        f"(limit {RING_MSD_REL}); {runner.n_flush} flushes of "
        f"{runner._host_rows.fetches} windows")
    if no_ring:
        os.environ["AZTOTMD_NO_RING"] = "1"
        try:
            loop = runner_of("host")
        finally:
            os.environ.pop("AZTOTMD_NO_RING", None)
        check(not loop.ring_ok, f"{name}: AZTOTMD_NO_RING left the ring on")
        rows, stat_row = [], loop._stat_row

        def record(step):
            rows.append(host_row(loop))
            stat_row(step)
        loop._stat_row = record
        loop.run(steps)
        res["host loop"] = (len(rows),) + _same_rows(
            name, "the host loop's run", msd, ring, rows)
        log(f"  {name}: the ring's rows against a run of the host loop "
            f"(AZTOTMD_NO_RING): int rows equal, {res['host loop'][1]} "
            f"float values 1 ulp apart, MSD rel {res['host loop'][2]:.3e}")
    return res


def device_gaps(torch, fn):
    """``fn()`` under torch.profiler: (wall s, device busy s as the union
    of its kernel and copy intervals, device span s from the first
    event's start to the last's end, the largest gap between events in
    s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall, None, None, None
    busy, gap = 0, 0
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gap = max(gap, a - hi)
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    return wall, busy * 1e-6, span * 1e-6, gap * 1e-6


def ring_idle(torch, dev, out, card):
    """The card's idle share between stat periods: argon_gas
    RING_PROFILE_STEPS steps through the runner's main loop under
    torch.profiler, on the stat ring (windows of one period, ``s_cap``
    1: window k's row decoded while window k+1 runs) and on the host loop
    (``AZTOTMD_NO_RING``: one blocking stat row a period), after the same
    steps to warm up and capture.  Returns {mode: (idle share over the
    device span, largest gap ms, wall ms)}."""
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    res = {}
    for mode in ("ring", "host loop"):
        if mode == "host loop":
            os.environ["AZTOTMD_NO_RING"] = "1"
        try:
            runner = MDRunner(load_deck_dir(GAS_DECK, device=dev),
                              out_dir=os.path.join(out, "ring_idle_"
                                                   + mode.split()[0]),
                              quiet=True)
        finally:
            os.environ.pop("AZTOTMD_NO_RING", None)
        runner.s_cap = 1
        runner.run(RING_PROFILE_STEPS)
        wall, busy, span, gap = device_gaps(
            torch, lambda: runner.run(2 * RING_PROFILE_STEPS))
        if busy is None:
            log(f"  argon_gas {mode}: no device activity recorded; idle "
                "share not measured")
            res[mode] = None
            continue
        idle = 1.0 - busy / span
        windows = f", {runner._host_rows.fetches} windows so far" \
            if runner.ring_ok else ""
        log(f"  argon_gas {mode}, {RING_PROFILE_STEPS} steps profiled: "
            f"wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
            f"of its {span * 1e3:.1f} ms span: idle share {idle:.4f}, "
            f"largest gap {gap * 1e3:.3f} ms{windows} (torch.profiler, "
            f"{card})")
        res[mode] = (idle, gap * 1e3, wall * 1e3)
        del runner
    return res


def ring_phase(torch, dev, out, card):
    """The stat ring (``runtime/statring.py``): its rows against the host
    loop's on the same states (surkov_cluster, K1, and argon_gas, the
    Verlet list's plan), the card's idle share between periods on the
    ring and on the host loop, and the CLI runs' rates, windows and
    flushes (counted in ``ring_counts``) beside PR 13's rates."""
    phase("the stat ring: rows against the host loop's, the idle share "
          "between periods, the runs' windows")
    rows = {nm: ring_rows_case(torch, dev, out, nm, deck, no_ring=no_ring)
            for nm, deck, no_ring in (("surkov_cluster", SURKOV_DECK, True),
                                      ("argon_gas", GAS_DECK, False))}
    idle = ring_idle(torch, dev, out, card)
    missing = [nm for nm in RING_PR13 if nm not in RING_RUNS]
    check(not missing, f"no ring run counted for {missing}")
    log(f"stat ring CLI steps/s on {card} (this run; PR 13's final run in "
        "brackets): " + ", ".join(
            f"{nm} {RING_RUNS[nm][0]:.1f} [{RING_PR13[nm]}] in "
            f"{RING_RUNS[nm][1]} windows of {RING_RUNS[nm][2]} periods"
            for nm in RING_PR13))
    return {"rows": rows, "idle": idle,
            "runs": {nm: RING_RUNS[nm] for nm in RING_PR13}}


def profile_steps(torch, load_deck_dir, make_multi_step, counters, deck,
                  dev, n=PROFILE_STEPS, mesh=0, graph=None, **load_kw):
    """Device busy time and the kernels that take it over ``n`` bare steps
    (no output, no RDF; over ``mesh`` slabs when set), from
    torch.profiler: replays of the captured step (``graph`` None, the
    run's path) or eager steps (``graph=False``).  The profiler may keep fewer device events than ran,
    so the profile counts only when it recorded every launch of the
    port's kernels that their counters saw (set to 0 just before it); an
    incomplete profile is taken once more over n // 5 steps, and when
    that one is incomplete too, or no device activity was recorded, the
    busy time and idle share are "not measured" and None is returned.
    Each kernel's line gives the launches recorded and its mean a launch
    beside its sum over the steps; the host's kernel-launch calls are
    logged beside the kernel events recorded.  Returns (device seconds,
    launches) by kernel name."""
    if mesh:
        from aztotmd_tpu_torch.parallel import slab
        cfg, ff, aux, comm, st = mesh_system(load_deck_dir, deck, mesh, dev,
                                             **load_kw)
        multi = slab.make_slab_multi_step(cfg, aux, comm, graph=graph)
        d = {"ff": ff}
        state = multi(st, ff, 10)
    else:
        d = load_deck_dir(deck, device=dev, **load_kw)
        multi = make_multi_step(d["cfg"], d["aux"], graph=graph)
        state = multi(d["state"], d["ff"], 10)
    mode = "eager" if graph is False else "graph"
    tag = os.path.basename(deck) + (f" over {mesh} slabs" if mesh else "") \
        + (f" ({load_kw['pair_engine']})" if "pair_engine" in load_kw
           else "")
    IDLE[(tag, mode)] = BUSY[(tag, mode)] = None
    tag = f"{tag}, {mode}"
    for steps in (n, max(2, n // 5)):
        # the same steps without the profiler, which slows each launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(state, d["ff"], steps)
        torch.cuda.synchronize()
        bare = time.perf_counter() - t0
        wall, by_name, host_launches, ran, seen, events = profiled(
            torch, counters, lambda: multi(state, d["ff"], steps))
        if seen == ran:
            break
        log(f"profile {tag}, {steps} steps: incomplete, the profiler "
            "recorded " + ", ".join(f"{seen[fn]} of {ran[fn]} launches of "
                                    f"{fn.strip(':<(')}" for fn in ran
                                    if seen[fn] != ran[fn]))
    else:
        log(f"profile {tag}: no complete profile; device busy time and "
            "idle share not measured")
        return None
    busy = sum(t for t, _ in by_name.values())
    if busy <= 0.0:
        log(f"profile {tag}: no device activity recorded; device idle "
            "share not measured")
        return None
    kernels = sum(c for name, (_, c) in by_name.items()
                  if not name.startswith(("Memcpy", "Memset")))
    IDLE[(tag.rsplit(", ", 1)[0], mode)] = 1.0 - busy / wall
    BUSY[(tag.rsplit(", ", 1)[0], mode)] = busy / bare
    log(f"profile {tag}, {steps} steps: wall {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / steps:.3f} ms/step), device busy {busy * 1e3:.1f} "
        f"ms, device idle share {1.0 - busy / wall:.3f}; without the "
        f"profiler the same steps took {bare * 1e3:.1f} ms "
        f"({bare * 1e3 / steps:.3f} ms/step): busy over that "
        f"{busy / bare:.3f}; {events} events (torch.profiler); "
        "every launch of "
        f"the port's kernels recorded ({sum(ran.values())}); "
        f"{kernels} kernel events against {host_launches} host launch "
        "calls")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {t * 1e3 / steps:8.4f} ms/step  {t / busy:6.1%} of busy  "
            f"{c:5d} launches recorded, {t * 1e3 / c:.4f} ms each  "
            f"{name[:80]}")
    return by_name


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


def graph_case(torch, name, multi, state, ff, n=GRAPH_STEPS, keep=False):
    """1 + n steps eager and 1 + n replayed from CUDA graphs (the first
    call captures), from the same cloned state, with the programs of
    ``multi`` (a ``MultiStep``): every integer field exactly equal, the
    positions within GRAPH_POS_ATOL.  Logs the largest position (and
    other float) difference, the graphs' nodes, their capture time and
    both rates over the n timed steps; returns (eager steps/s, graph
    steps/s, graph nodes per step), and with ``keep`` the replayed state
    after them."""
    from aztotmd_tpu_torch.runtime.graph import clone_state, state_leaves
    from aztotmd_tpu_torch.runtime.step import MultiStep
    runs = {}
    for graph in (False, True):
        m = MultiStep(multi.fns, graph, multi.R, multi.Q)
        st = m(clone_state(state), ff, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = m(st, ff, n)
        torch.cuda.synchronize()
        runs[graph] = (m, st, n / (time.perf_counter() - t0))
    (_, se, re_), (mg, sg, rg) = runs[False], runs[True]
    a, b = dict(state_leaves(sg)), dict(state_leaves(se))
    ints = [k for k in b if not b[k].is_floating_point()]
    differ = [k for k in ints if not torch.equal(a[k], b[k])]
    dpos = float((a["pos"] - b["pos"]).abs().max())
    dfl, kfl = max((float((a[k] - b[k]).abs().max()), k) for k in b
                   if b[k].is_floating_point())
    progs = mg.graphs.programs
    nodes = {k: p.nodes for k, p in progs.items()}
    cap = sum(p.capture_seconds for p in progs.values())
    log(f"  {name:34s} {n + 1} steps: max|dpos| {dpos:.3e} A (limit "
        f"{GRAPH_POS_ATOL}), largest float difference {dfl:.3e} ({kfl}); "
        f"{len(ints)} integer fields {'equal' if not differ else differ}; "
        f"graph nodes {nodes}; capture {cap:.2f} s; eager {re_:.1f} "
        f"steps/s, graph {rg:.1f} steps/s ({rg / re_:.2f}x)")
    check(not differ and dpos <= GRAPH_POS_ATOL,
          f"{name}: graph replays and eager steps differ")
    return (re_, rg, nodes.get("step")) + ((sg,) if keep else ())


def _share(v):
    return "not measured" if v is None else f"{v:.3f}"


def atoms_mesh_phases(torch, dev, out, cli, counters, card, rates,
                      one_graph):
    """The atom-sharded mode (``parallel/mesh.py``) over ATOMS_DEV row
    shards on the one card: molten_salt (K1 + Ewald), ejump_redox
    (K1-cand) and nanoclusters (K4) through ``run --mesh 4 --mesh-mode
    atoms`` (``drive``: every pair pass a launch of the deck's kernel, the
    counts against the profiler's over a window); then from each deck's
    first state 1 + 100 atoms-mode steps eager and replayed
    (``graph_case``), and the replayed ones against the one-device
    replays of the graph phase (``one_graph``): every integer field
    exactly, positions within GRAPH_POS_ATOL.  Logs the graph nodes a
    step and the rates beside the one-device ones of this call
    (``rates``); returns the numbers by deck."""
    from aztotmd_tpu_torch.parallel import LocalRing
    from aztotmd_tpu_torch.parallel.mesh import (
        gather_state, make_sharded_multi_step, shard_state, state_shardings)
    from aztotmd_tpu_torch.runtime.graph import state_leaves
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    decks = {"molten_salt": (SALT_DECK, "allpairs"),
             "ejump_redox": (EJUMP_DECK, "allpairs_cand"),
             "nanoclusters": (NANO_DECK, "sparse")}
    phase(f"atoms mesh: run --mesh {ATOMS_DEV} --mesh-mode atoms (every "
          "pair pass a launch of the deck's kernel)")
    res = {}
    for nm, (deck, kern) in decks.items():
        runner, launches, rate = drive(
            cli, counters, f"{nm} --mesh {ATOMS_DEV} --mesh-mode atoms", deck,
            os.path.join(out, nm + "_atoms"), ATOMS_STEPS[nm],
            mesh=ATOMS_DEV, mesh_mode="atoms")
        check(launches == expected_launches(counters, runner, kern),
              f"the {nm} atoms run's pair passes did not all go through "
              f"{kern}, or its thermostat not through csrc/tstat.cu")
        res[nm] = {"cli_steps_per_s": rate, "launches": launches[kern]}
    phase(f"atoms mesh: 1 + {GRAPH_STEPS} atoms-mode steps replayed vs "
          "eager, and vs the one-device replays (integer fields exactly, "
          f"positions within {GRAPH_POS_ATOL} A)")
    for nm, (deck, _) in decks.items():
        d = load_deck_dir(deck, device=dev)
        mesh = LocalRing(ATOMS_DEV, dev)
        spec = state_shardings(mesh, d["state"], d["cfg"].n_at)
        multi = make_sharded_multi_step(d["cfg"], d["aux"], mesh, spec)
        e, g, nodes, sg = graph_case(
            torch, f"{nm} atoms over {ATOMS_DEV}", multi,
            shard_state(mesh, d["state"], spec), d["ff"], keep=True)
        a = dict(state_leaves(gather_state(mesh, sg, spec)))
        b = dict(state_leaves(one_graph[nm]))
        differ = [k for k in b if not b[k].is_floating_point()
                  and not torch.equal(a[k], b[k])]
        dpos = float((a["pos"] - b["pos"]).abs().max())
        bitwise = all(torch.equal(a[k], b[k]) for k in b)
        e1, g1, n1 = rates[nm]
        log(f"  {nm}: atoms-mode replays vs one-device replays, "
            f"{GRAPH_STEPS + 1} steps: max|dpos| {dpos:.3e} A, integer "
            f"fields {'equal' if not differ else differ}, every field "
            f"{'bitwise equal' if bitwise else 'not bitwise equal'}; graph "
            f"nodes a step {nodes} (one device {n1}); bare steps/s eager -> "
            f"replayed: atoms {e:.1f} -> {g:.1f}, one device {e1:.1f} -> "
            f"{g1:.1f} (replayed {g / g1:.3f}x); CLI "
            f"{res[nm]['cli_steps_per_s']:.1f} steps/s; on {card}")
        check(not differ and dpos <= GRAPH_POS_ATOL,
              f"{nm}: atoms-mode replays and one-device replays differ")
        res[nm].update(eager=e, replayed=g, nodes=nodes, one_eager=e1,
                       one_replayed=g1, one_nodes=n1, bitwise=bitwise)
    return res


def domain_phase(torch, dev, card):
    """``pair_forces_domain`` over a LocalRing of 4 x-slabs on the card, on
    ``build_lj_argon(DOMAIN_ATOMS)`` re-gridded as the JAX package's test
    does (ncx floored to a multiple of 4), against the port's all-pairs
    plain pass: forces within FORCE_ATOL*max|F|, energy within
    ENERGY_REL; both timed (CUDA events).  Returns (domain ms, all-pairs
    ms, max|dF|)."""
    from aztotmd_tpu_torch.core.config import make_block_grid
    from aztotmd_tpu_torch.ops.pairs import all_pairs_forces
    from aztotmd_tpu_torch.parallel import LocalRing, pair_forces_domain
    from aztotmd_tpu_torch.systems import build_lj_argon
    phase(f"domain: pair_forces_domain over 4 x-slabs vs the all-pairs "
          f"plain pass, {DOMAIN_ATOMS} argon atoms")
    n = 4
    cfg, ff, st, _ = build_lj_argon(n_atoms=DOMAIN_ATOMS, device=dev)
    grid = make_block_grid(cfg.box, cfg.r_max, cfg.n_at)
    ncx = max((grid.dims[0] // n) * n, n)
    dcfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        grid, dims=(ncx,) + grid.dims[1:],
        edge=(cfg.box[0] / ncx,) + grid.edge[1:]))
    comm = LocalRing(n, dev)
    dom = lambda: pair_forces_domain(dcfg, ff, st.pos, st.types, comm)
    ref_fn = lambda: all_pairs_forces(cfg, ff, st.pos, st.types)
    frc, ev, _ = dom()
    ref = ref_fn()
    torch.cuda.synchronize()
    err = float((frc - ref.frc).abs().max())
    scale = float(ref.frc.abs().max())
    ok = (err <= FORCE_ATOL * max(scale, 1.0) and abs(float(ev) - float(
        ref.eng_vdw)) <= ENERGY_REL * abs(float(ref.eng_vdw)) + 1e-6)
    ms_dom, ms_all = timed(torch, [dom, ref_fn], n=5)
    log(f"  grid {dcfg.grid.dims} cap {dcfg.grid.cap}: max|dF| {err:.3e} "
        f"(limit {FORCE_ATOL * max(scale, 1.0):.3e}), Evdw {float(ev):.6f} "
        f"vs {float(ref.eng_vdw):.6f}; domain pass {ms_dom:.4f} ms, "
        f"all-pairs plain pass {ms_all:.4f} ms (medians of 10, CUDA events)"
        f" on {card}  {'ok' if ok else 'FAIL'}")
    check(ok, "the domain pass disagrees with the all-pairs pass")
    return ms_dom, ms_all, err


def entry_api_phases(torch, cli, out, card):
    """``entry()`` steps once on the card; ``dryrun_multichip(4)`` passes
    on the card; ``aztotmd_tpu_torch.run`` on surkov_cluster for
    API_STEPS steps writes the stat.dat that the CLI writes for the same
    steps, byte for byte."""
    import aztotmd_tpu_torch
    from aztotmd_tpu_torch.entry import dryrun_multichip, entry
    phase("entry and API: entry(), dryrun_multichip(4), "
          "aztotmd_tpu_torch.run against the CLI")
    fn, (state, ff) = entry()
    check(state.pos.is_cuda, "entry() did not put the system on the card")
    o = fn(state, ff)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o.pos).all()) and int(o.step) == 1,
          "entry()'s step is not finite")
    log(f"  entry ok; energies.tot = {float(o.energies.tot)} "
        f"({state.pos.shape[0]} atoms, {o.pos.device})")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    torch.cuda.synchronize()
    dry = time.perf_counter() - t0
    log(f"  dryrun_multichip(4) ok in {dry:.1f} s on {card}")
    a, b = os.path.join(out, "api_run"), os.path.join(out, "api_cli")
    r = aztotmd_tpu_torch.run(SURKOV_DECK, out_dir=a, n_steps=API_STEPS,
                              quiet=True)
    check(r.state.pos.is_cuda, "aztotmd_tpu_torch.run did not run on the card")
    cli(["run", SURKOV_DECK, "--steps", str(API_STEPS), "-o", b, "--quiet"])
    with open(os.path.join(a, "stat.dat")) as f, \
            open(os.path.join(b, "stat.dat")) as g:
        text, want = f.read(), g.read()
    rows = len(text.splitlines()) - 2
    log(f"  aztotmd_tpu_torch.run on surkov_cluster, {API_STEPS} steps: "
        f"stat.dat {'equal to' if text == want else 'DIFFERS from'} the "
        f"CLI's, byte for byte ({rows} row)")
    check(text == want and rows >= 1,
          "aztotmd_tpu_torch.run and the CLI wrote different stat.dat")


def rdf_kernel_phase(torch, dev, out, card):
    """The all-pairs RDF kernel (csrc/rdf.cu) against its plain version:
    the integer counts exactly equal on ``systems.rdf_edge_deck`` (both
    setups, 1-3 species, f32 and f64), on examples/surkov_cluster's deck
    drawn at seeds 1-3 (f32 and f64) and on examples/molten_salt with the
    nuclei histogram (its two histograms equal too); ``rdf.launches`` one
    an eager call and one a replay.  Then, on surkov_cluster (N = 4,000)
    and molten_salt (1,728), CUDA-event medians of the kernel alone (200
    back-to-back launches into one table), the wrapper eager, the
    runner's sample replayed from its graph and the plain version, the
    kernel's profiler time, and the bound from the pair count.  Returns
    those by deck."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aztotmd_tpu_torch import systems
    from aztotmd_tpu_torch.ops import rdf as ops_rdf
    from aztotmd_tpu_torch.runtime.graph import GraphedSample
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir

    def same(name, cfg, rc, pos, types):
        n0 = ops_rdf.launches
        k = ops_rdf.rdf_counts_allpairs(cfg, rc, pos, types)
        p = ops_rdf.rdf_counts_allpairs_plain(cfg, rc, pos, types)
        ok = (ops_rdf.launches == n0 + 1 and k.dtype == p.dtype == pos.dtype
              and torch.equal(k, p) and float(k.sum()) > 0)
        log(f"  {name:36s} N={cfg.n_at:5d} {rc.n_bin} bins x {rc.n_pair}: "
            f"{int(k.sum())} pairs in range, counts "
            f"{'equal' if ok else 'DIFFER'}")
        check(ok, f"the RDF kernel disagrees with its plain version: {name}")
        return k

    def deck_rdf(d, **kw):
        cfg, st = d["cfg"], d["state"]
        rc = ops_rdf.make_rdf_config(d["ctl"], cfg, pos=st.pos.cpu().numpy())
        check(cfg.n_at <= len(rc.grid.stencil) * rc.grid.cap,
              "the deck does not take the all-pairs RDF branch")
        return cfg, dataclasses.replace(rc, **kw), st

    for setup in sorted(systems.RDF_EDGE_SETUPS):
        for nsp in (1, 2, 3):
            for dt in (np.float32, np.float64):
                cfg, kw, pos, types = systems.rdf_edge_deck(setup, nsp, dt)
                same(f"edges {setup}, nsp={nsp}, {np.dtype(dt).name}", cfg,
                     ops_rdf.RdfConfig(**kw), torch.as_tensor(pos, device=dev),
                     torch.as_tensor(types, device=dev))
    # finer bins: one table a block (3,500 slots), the global table (14,000)
    cfg, kw, pos, types = systems.rdf_edge_deck("exact", 1, np.float32)
    for d_rdf in (0.002, 0.0005):
        rc = ops_rdf.RdfConfig(**dict(kw, d_rdf=d_rdf, n_bin=int(7 / d_rdf)))
        same(f"edges exact, {rc.n_bin} bins, "
             f"{ops_rdf._lib().aztotmd_rdf_table_copies(rc.n_bin)} tables",
             cfg, rc, torch.as_tensor(pos, device=dev),
             torch.as_tensor(types, device=dev))
    for seed in (1, 2, 3):
        deck = os.path.join(out, f"rdf_surkov_{seed}")
        systems.write_surkov_cluster_deck(deck, seed=seed)
        cfg, rc, st = deck_rdf(load_deck_dir(deck, device=dev))
        for pos in (st.pos, st.pos.double()):
            same(f"surkov_cluster seed {seed}, {pos.dtype}", cfg, rc, pos,
                 st.types)
    cfg, rc, st = deck_rdf(load_deck_dir(SALT_DECK, device=dev), nuclei=True)
    counts = same("molten_salt, nuclei", cfg, rc, st.pos, st.types)
    snuc = torch.arange(cfg.n_spec, dtype=torch.int32, device=dev)
    nnum = torch.bincount(snuc[st.types.long()], minlength=cfg.n_nucl
                          ).to(torch.int32)
    h0, nh0 = ops_rdf.zero_hist(rc, device=dev)
    got = ops_rdf.rdf_sample(cfg, rc, st.pos, st.types, st.spec_number, snuc,
                             nnum, h0, nh0)
    want = ops_rdf._apply_weights(cfg, rc, counts, st.spec_number, snuc,
                                  nnum, h0, nh0)
    check(all(torch.equal(a, b) for a, b in zip(got, want))
          and float(got[1].sum()) > 0,
          "molten_salt: the RDF histograms differ from the plain counts'")
    log("  molten_salt rdf_sample: species and nuclei histograms equal to "
        "the plain counts' through _apply_weights")

    res = {}
    for name, deck in (("surkov_cluster", SURKOV_DECK),
                       ("molten_salt", SALT_DECK)):
        runner = MDRunner(load_deck_dir(deck, device=dev),
                          out_dir=os.path.join(out, "rdfk_" + name),
                          quiet=True)
        cfg, rc, st = runner.cfg, runner.rcfg, runner.state
        fn = runner._rdf.fn
        zero = lambda h: None if h is None else torch.zeros_like(h)
        h1, nh1 = zero(runner.hist), zero(runner.nhist)
        sample = GraphedSample(fn, "RDF sample")
        n0 = ops_rdf.launches
        for _ in range(3):
            sample(st, h1, nh1)
        check(ops_rdf.launches == n0 + 3,
              f"{name}: {ops_rdf.launches - n0} RDF kernel launches in 3 "
              "replays")
        lib = ops_rdf._lib()
        table = torch.zeros(rc.n_bin * rc.n_pair, dtype=torch.int32,
                            device=dev)
        args = (st.pos.data_ptr(), st.types.data_ptr(), cfg.n_at,
                rc.n_spec, rc.n_bin, rc.n_pair,
                *(ops_rdf.f32(b) for b in cfg.box), ops_rdf.f32(rc.r2_max),
                ops_rdf.f32(rc.d_rdf), table.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)

        def alone(n=200):
            for _ in range(n):
                lib.aztotmd_rdf_allpairs_f32(*args)
        kern, wrap, rep = timed(torch, [
            alone,
            lambda: ops_rdf.rdf_counts_allpairs(cfg, rc, st.pos, st.types),
            lambda: sample(st, h1, nh1)], n=10)
        kern /= 200
        plain = timed(torch, [lambda: ops_rdf.rdf_counts_allpairs_plain(
            cfg, rc, st.pos, st.types)], n=5)[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            alone(50)
            torch.cuda.synchronize()
        ev = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "rdf_allpairs_kernel" in e.name]
        prof_ms = sum(ev) * 1e-3 / len(ev) if ev else None
        pairs = cfg.n_at * (cfg.n_at - 1) // 2
        in_range = int(ops_rdf.rdf_counts_allpairs(cfg, rc, st.pos,
                                                   st.types).sum())
        fp32 = (pairs * OPS_RDF_PAIR + in_range * OPS_RDF_RANGE) / (
            PEAK_FP32 / 2)
        b_ms, b_by, detail = bound_of(
            fp32, in_range * MUFU_RDF_RANGE / PEAK_MUFU,
            cfg.n_at * 16 + rc.n_bin * rc.n_pair * 4)
        log(f"  {name:14s} N={cfg.n_at:5d}, {pairs} pairs, {in_range} in "
            f"range, {rc.n_bin} x {rc.n_pair} slots, "
            f"{lib.aztotmd_rdf_table_copies(rc.n_bin * rc.n_pair)} "
            f"shared-memory tables a block: kernel alone {kern:.5f} ms "
            f"(events), {prof_ms} ms (profiler), wrapper eager {wrap:.5f}, "
            f"sample replayed {rep:.5f} (every {runner.p_rdf} steps: "
            f"{rep / runner.p_rdf:.5f} a step), plain {plain:.4f} ms; bound "
            f"{b_ms:.5f} ms by {b_by} ({detail}) on {card}")
        res[name] = {"n": cfg.n_at, "pairs": pairs, "in_range": in_range,
                     "kernel_ms": kern, "kernel_profiler_ms": prof_ms,
                     "wrapper_ms": wrap, "sample_replay_ms": rep,
                     "plain_ms": plain, "bound_ms": b_ms}
        del runner, sample
        _free(torch)
    return res


def tstat_inputs(torch, n, dev, seed=0):
    """(cfg, ff, state, photons) of a synthetic radiative-thermostat
    state of ``n`` atoms and 3 species in f32 on the card: thermal
    velocities, a third of the atoms cold, internal energies of 0 to 0.3
    eV, photons drawn as the decks draw them at 500 K."""
    import types as pytypes
    import numpy as np
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    vel = rng.normal(0.0, 5.0, (n, 3))
    vel[rng.random(n) < 1 / 3] = 0.0
    ff = pytypes.SimpleNamespace(
        spec_mass=f([0.0041, 0.0020, 0.0066]), spec_mx_eng=f([1.0, 0.6, 1.4]),
        spec_rad_a=f([2.885, 1.9, 3.3]), spec_rad_b=f([5.0, 4.0, 6.5]))
    state = pytypes.SimpleNamespace(
        pos=f(np.zeros((n, 3))), vel=f(vel), engs=f(rng.uniform(0, 0.3, n)),
        types=torch.as_tensor(rng.integers(0, 3, n).astype(np.int32),
                              device=dev),
        rng=torch.tensor([7, 12345], dtype=torch.int64, device=dev),
        step=torch.tensor(1001, dtype=torch.int32, device=dev))
    photons = f(np.minimum(rng.gamma(5.0, 0.0431, n), 1.0))
    return pytypes.SimpleNamespace(n_at=n), ff, state, photons


def tstat_kernel_phase(torch, dev, out, card):
    """The radiative thermostat's kernel (csrc/tstat.cu) against its plain
    version on examples/surkov_cluster's 4,000 atoms, at the start and
    after TSTAT_STEPS steps, in f32 and f64: the rng words exactly, the
    velocities, internal energies and radii within TSTAT_TOL of the
    largest plain |v|, internal plus kinetic energy of an atom, and
    radius; ``thermostat.launches`` equal to the steps of
    an ``MDRunner.run`` of TSTAT_STEPS.  Then at 4,000, 40,000 and
    1,080,000 synthetic f32 atoms, CUDA-event medians of the kernel alone
    (200 back-to-back launches), the wrapper and the plain version each
    replayed from a graph of one call, the kernel's profiler time, and
    the byte bound (TSTAT_BYTES an atom).  Returns those by size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aztotmd_tpu_torch.ops import thermostat
    from aztotmd_tpu_torch.runtime import graph as graph_mod
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir

    def same(name, cfg, ff, st, photons):
        n0 = thermostat.launches
        k = thermostat.tstat_radiative(cfg, ff, st, photons)
        p = thermostat.tstat_radiative_plain(cfg, ff, st, photons)
        torch.cuda.synchronize()
        tol = TSTAT_TOL[str(st.vel.dtype).split(".")[-1]]
        # energies over the largest energy in an atom's sums: its
        # internal plus its kinetic energy
        m = ff.spec_mass[st.types.long()]
        e_max = (p[1].abs() + 0.5 * m * (p[0] * p[0]).sum(-1)).max()
        gaps = [float((a - b).abs().max() / s) for a, b, s in zip(
            k[:3], p[:3], (p[0].abs().max(), e_max, p[2].abs().max()))]
        ok = (thermostat.launches == n0 + 1 and torch.equal(k[4], p[4])
              and max(gaps) <= tol)
        log(f"  {name:40s} N={cfg.n_at}: rng words "
            f"{'equal' if torch.equal(k[4], p[4]) else 'DIFFER'}; vel, "
            f"engs, radii gaps {', '.join(f'{g:.3g}' for g in gaps)} of the "
            f"largest plain |v|, E + kinetic energy, radius (limit {tol:g});"
            f" eng_temp {float(k[3]):.9g} / {float(p[3]):.9g}")
        check(ok, f"the thermostat kernel disagrees with its plain version: "
              f"{name}")

    runner = MDRunner(load_deck_dir(SURKOV_DECK, device=dev),
                      out_dir=os.path.join(out, "tstat_run"), quiet=True)
    cfg, ff, aux = runner.cfg, runner.ff, runner.aux
    same("surkov_cluster at the start, f32", cfg, ff, runner.state,
         aux.photons)
    thermostat.launches = 0
    runner.run(TSTAT_STEPS)
    rec = runner.timer.calls[-1]["counters"].get("thermostat.launches")
    log(f"  surkov_cluster MDRunner.run({TSTAT_STEPS}): "
        f"{runner.steps_run} steps, thermostat.launches "
        f"{thermostat.launches} ({rec} in the call's record)")
    check(thermostat.launches == rec == runner.steps_run == TSTAT_STEPS,
          "the run's steps did not each launch csrc/tstat.cu once")
    st = runner.state
    same(f"surkov_cluster after {TSTAT_STEPS} steps, f32", cfg, ff, st,
         aux.photons)
    d64 = load_deck_dir(SURKOV_DECK, dtype="f64", device=dev)
    st64 = d64["state"].replace(vel=st.vel.double(), engs=st.engs.double(),
                                step=st.step.clone(), rng=st.rng.clone())
    same(f"surkov_cluster after {TSTAT_STEPS} steps, f64", d64["cfg"],
         d64["ff"], st64, d64["aux"].photons)
    del runner, d64, st64
    _free(torch)

    res = {}
    lib = thermostat._lib()
    for n in TSTAT_SIZES:
        cfg, ff, st, photons = tstat_inputs(torch, n, dev)
        same("synthetic, 3 species, f32", cfg, ff, st, photons)
        outs = [torch.empty_like(st.vel), torch.empty_like(st.engs),
                torch.empty_like(st.engs), torch.empty_like(st.rng)]
        args = (st.vel.data_ptr(), st.engs.data_ptr(), st.types.data_ptr(),
                photons.data_ptr(), ff.spec_mass.data_ptr(),
                ff.spec_mx_eng.data_ptr(), ff.spec_rad_a.data_ptr(),
                ff.spec_rad_b.data_ptr(), st.rng.data_ptr(),
                st.step.data_ptr(), None, None, n, n, 2,
                *(t.data_ptr() for t in outs),
                torch.cuda.current_stream(dev).cuda_stream)

        def alone(k=200):
            for _ in range(k):
                lib.aztotmd_tstat_radiative_f32(*args)
        progs = [graph_mod.Program(f"tstat {name}", fn, fn, dev)
                 for name, fn in (
                     ("kernel", lambda: thermostat.tstat_radiative(
                         cfg, ff, st, photons)),
                     ("plain", lambda: thermostat.tstat_radiative_plain(
                         cfg, ff, st, photons)))]
        kern, wrap, plain = timed(torch, [alone, progs[0].replay,
                                          progs[1].replay], n=10)
        kern /= 200
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            alone(50)
            torch.cuda.synchronize()
        ev = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "tstat_radiative_kernel" in e.name]
        prof_ms = sum(ev) * 1e-3 / len(ev) if ev else None
        b_ms = n * TSTAT_BYTES / PEAK_BYTES * 1e3
        log(f"  N={n:8d}: kernel alone {kern:.5f} ms (events), {prof_ms} ms"
            f" (profiler); wrapper replayed {wrap:.5f} ms ({progs[0].nodes}"
            f" nodes); plain replayed {plain:.5f} ms ({progs[1].nodes} "
            f"nodes); bound {b_ms:.5f} ms by bytes ({TSTAT_BYTES} B an atom)"
            f" on {card}")
        res[n] = {"kernel_ms": kern, "kernel_profiler_ms": prof_ms,
                  "wrapper_replay_ms": wrap, "plain_replay_ms": plain,
                  "wrapper_nodes": progs[0].nodes,
                  "plain_nodes": progs[1].nodes, "bound_ms": b_ms}
        del progs, outs, st, photons
        _free(torch)
    return res


def rdf_case(torch, name, runner, card):
    """One RDF sample of the deck's first state (the runner's sample
    function and histograms): its time eager and as a graph replay (CUDA
    events, medians), beside the eager sample whose counts come from
    ``torch.bincount`` (the library call, which syncs with the host and
    cannot be captured) over the torch-ops samplers (the all-pairs
    branch's plain version in place of its kernel), whose histogram it
    must equal bit for bit; returns (eager ms, replay ms, the replay's ms
    a step at the deck's RDF period)."""
    from aztotmd_tpu_torch.ops import rdf as ops_rdf
    from aztotmd_tpu_torch.runtime.graph import GraphedSample
    fn, st = runner._rdf.fn, runner.state
    zero = lambda h: None if h is None else torch.zeros_like(h)
    h0, nh0 = zero(runner.hist), zero(runner.nhist)
    got = fn(st, h0.clone(), None if nh0 is None else nh0.clone())
    ours = ops_rdf._hist_counts, ops_rdf.rdf_counts_allpairs

    def counts_bincount(flat, n_slot, dtype):
        c = torch.bincount(flat.reshape(-1).to(torch.int64),
                           minlength=n_slot + 1)
        return c[:n_slot].to(dtype)

    def with_bincount():
        ops_rdf._hist_counts = counts_bincount
        ops_rdf.rdf_counts_allpairs = ops_rdf.rdf_counts_allpairs_plain
        try:
            return fn(st, h0.clone(), None if nh0 is None else nh0.clone())
        finally:
            ops_rdf._hist_counts, ops_rdf.rdf_counts_allpairs = ours

    ref = with_bincount()
    same = all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, ref))
    sample = GraphedSample(fn, "RDF sample")
    h1, nh1 = h0.clone(), None if nh0 is None else nh0.clone()
    eager, replay, lib = timed(torch, [lambda: fn(st, h0, nh0),
                                       lambda: sample(st, h1, nh1),
                                       with_bincount], n=10)
    per = replay / runner.p_rdf
    log(f"  {name:18s} N={runner.cfg.n_at:6d} {runner.rcfg.n_bin} bins x "
        f"{runner.rcfg.n_pair}: eager {eager:.4f} ms, replayed {replay:.4f}"
        f" ms, eager with torch.bincount {lib:.4f} ms on {card}; every "
        f"{runner.p_rdf} steps: {per:.4f} ms a step; histogram "
        f"{'equal to' if same else 'DIFFERS from'} bincount's")
    check(same, f"{name}: the RDF counts differ from torch.bincount's")
    return eager, replay, per


def cli_flag_runs(cli, out, card):
    """``run --debug --timings`` (200 steps) and ``run --profile LOG_DIR``
    (50 steps; the trace goes to a temporary directory, removed after its
    size is read) on surkov_cluster and ``bench`` (its eager and graph
    lines): each must finish, the profile must write its trace."""
    import contextlib
    import io
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    for steps, flags in ((200, ["--debug", "--timings"]),
                         (50, ["--profile", log_dir])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            r = cli(["run", SURKOV_DECK, "--steps", str(steps), "-o",
                     os.path.join(out, "surkov_flags"), "--quiet"] + flags)
        text = err.getvalue()
        check(r.steps_run == steps and "loop wall:" in text
              and "steps" in text.split("loop wall:")[1],
              f"run {' '.join(flags)}: no stage report")
        log(f"  run {' '.join(flags)}: " + "; ".join(
            ln.strip() for ln in text.splitlines()
            if ln.startswith(("loop wall", "steps ", "sampling "))))
    trace = os.path.join(log_dir, "trace.json")
    size = os.path.getsize(trace)
    shutil.rmtree(log_dir, ignore_errors=True)
    check(size > 0, "run --profile wrote no trace")
    log(f"  run --profile: {size} bytes of Chrome trace")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli(["bench", SURKOV_DECK, "--steps", "200", "--warmup", "20"])
    for line in buf.getvalue().splitlines():
        log(f"  bench: {line}")
    check(res["steps_per_sec"] > 0 and res["graph_steps_per_sec"] > 0,
          "bench gave no rate")
    log(f"  bench surkov_cluster on {card}: eager "
        f"{res['steps_per_sec']:.1f}, graph {res['graph_steps_per_sec']:.1f}"
        " steps/s")


def topology_mesh_phases(torch, dev, out, cli, counters, card, tiled,
                         profile):
    """Topology on the slab mesh (constant bonds and angles through
    ``slab._bonded_pass``, reactive topology through ``slab_react``), all
    slabs batched on the one card:

    - the four paths through the run CLI (or the runner, for the engine
      switch), counts set to 0 just before each: reactive_polymer x3 over
      4 slabs and ejump_redox x3 over 3 (the stencil pass; bonds form and
      electrons jump across slab boundaries), bonded_fluid over 4 on the
      stencil pass and on "pallas" in f32 (K2 beside the bonded pass): K2
      launches equal to the pair passes there, no pair-kernel launch on
      the stencil paths, no record beyond one slab;
    - 1 + GRAPH_STEPS replays against eager slab steps (every integer
      field exactly, ``rg`` included; positions within GRAPH_POS_ATOL);
      ejump_redox x3 runs at the cut depth EJUMP_MESH_DEPTH throughout;
    - f64 mesh against f64 one device, TOPO_F64_STEPS steps:
      reactive_polymer over 4, ejump_redox over 3 (topology exactly,
      positions within TOPO_F64_ATOL, the JAX package's bounds);
    - f32 mesh against one device on the tiled decks, TOPO_F32_STEPS
      steps (positions within MESH_POS_ATOL, n_bond and n_jump equal);
    - profiles of replayed bare steps (busy time, idle share);
    - CUDA-event times of replayed programs: a step, and the parts of it
      that run once for all slabs on one card (the replicated reactive
      work: the reactive pass with its continuation, the candidate rows,
      assemble_global; the bonded pass on the constant decks).

    Returns ({path: numbers}, K2 launches of the bonded "pallas" run)."""
    from aztotmd_tpu_torch.parallel import slab, slab_react
    from aztotmd_tpu_torch.runtime.graph import Program, advance_in_place
    from aztotmd_tpu_torch.runtime.graph import clone_state
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    from aztotmd_tpu_torch.runtime.step import make_multi_step

    k2_path = "bonded_fluid --mesh 4 (pallas, K2)"
    paths = {   # name -> (deck, slabs, load keywords)
        "reactive_polymer x3 --mesh 4": (tiled["reactive_polymer"], 4, {}),
        "ejump_redox x3 --mesh 3": (tiled["ejump_redox"], 3, {}),
        "bonded_fluid --mesh 4": (BONDED_DECK, 4, {}),
        k2_path: (BONDED_DECK, 4, {"pair_engine": "pallas"})}
    # (CLI steps, graph steps, profiled replayed steps, timed calls)
    depth = {nm: (TILED_STEPS if "x3" in nm else BONDED_STEPS, GRAPH_STEPS,
                  20, 10) for nm in paths}
    depth["ejump_redox x3 --mesh 3"] = EJUMP_MESH_DEPTH
    res = {nm: {} for nm in paths}

    phase("topology on the slab mesh: the paths (counts set to 0 just "
          "before each)")
    k2_launches = 0
    for nm, (deck, n_dev, kw) in paths.items():
        steps = depth[nm][0]
        o = os.path.join(out, "topo_" + re.sub(r"\W+", "_", nm))

        def go(o, deck=deck, n_dev=n_dev, steps=steps, kw=kw):
            r = MDRunner(load_deck_dir(deck, device=dev, **kw), out_dir=o,
                         quiet=True, mesh_devices=n_dev)
            r.run(steps)
            r.finalize()
            return r
        runner, launches, rate = drive(
            cli, counters, nm, None if kw else deck, o, steps,
            runner_fn=go if kw else None, mesh=n_dev)
        cfg = runner.cfg
        k2 = nm == k2_path
        want = expected_launches(counters, runner,
                                 "allpairs_rect" if k2 else None)
        check(launches == want, f"{nm}: the pair passes did not all go "
              f"through {'K2' if k2 else 'torch ops'}, or the thermostat "
              "not through csrc/tstat.cu")
        check(cfg.pair_engine == ("pallas" if k2 else "block"),
              f"{nm}: routed to {cfg.pair_engine}")
        if k2:
            k2_launches = launches["allpairs_rect"]
        st = runner.state
        if st.rg is not None:
            log(f"  replicated topology: n_bond {int(st.rg.n_bond)}, n_jump "
                f"{int(st.rg.n_jump)}, species {st.rg.spec_number.tolist()}")
        if cfg.use_angl:
            with open(os.path.join(o, "revangles.txt")) as f:
                n_ang = int(f.readline())
            check(n_ang == int(runner._view().n_angle) > 0,
                  f"{nm}: revangles.txt not written")
        res[nm].update(cli_steps_per_s=rate, atoms=cfg.n_at, slabs=n_dev,
                       slot_capacity=st.pos.shape[1])

    phase(f"topology on the slab mesh: CUDA-graph replays vs eager slab "
          f"steps, 1 + {GRAPH_STEPS} steps each (1 + "
          f"{EJUMP_MESH_DEPTH[1]} on ejump_redox x3; integer fields, rg "
          f"included, exactly; positions within {GRAPH_POS_ATOL} A)")
    systems_ = {}
    for nm, (deck, n_dev, kw) in paths.items():
        cfg, ff, aux, comm, st = mesh_system(load_deck_dir, deck, n_dev, dev,
                                             **kw)
        multi = slab.make_slab_multi_step(cfg, aux, comm)
        e, g, nodes = graph_case(torch, nm, multi, st, ff, n=depth[nm][1])
        res[nm].update(eager_steps_per_s=e, graph_steps_per_s=g,
                       graph_nodes=nodes)
        systems_[nm] = (cfg, ff, aux, comm, st, multi)

    phase(f"topology on the slab mesh: f64 mesh vs f64 one device, "
          f"{TOPO_F64_STEPS} steps (topology exactly, positions within "
          f"{TOPO_F64_ATOL} A), and f32 on the tiled decks, "
          f"{TOPO_F32_STEPS} steps (positions within {MESH_POS_ATOL} A, "
          "n_bond and n_jump equal)")
    for nm, deck, n_dev, dtype, n, atol in (
            ("reactive_polymer", POLY_DECK, 4, "f64", TOPO_F64_STEPS,
             TOPO_F64_ATOL),
            ("ejump_redox", EJUMP_DECK, 3, "f64", TOPO_F64_STEPS,
             TOPO_F64_ATOL),
            ("reactive_polymer x3", tiled["reactive_polymer"], 4, "f32",
             TOPO_F32_STEPS, MESH_POS_ATOL),
            ("ejump_redox x3", tiled["ejump_redox"], 3, "f32",
             TOPO_F32_STEPS, MESH_POS_ATOL)):
        cfg, ff, aux, comm, st = mesh_system(load_deck_dir, deck, n_dev, dev,
                                             dtype=dtype)
        st = slab.make_slab_multi_step(cfg, aux, comm)(st, ff, n)
        g = slab.gather_state(st, cfg.n_at, comm)
        d = load_deck_dir(deck, device=dev, dtype=dtype)
        one = make_multi_step(d["cfg"], d["aux"])(d["state"], d["ff"], n)
        torch.cuda.synchronize()
        dpos = float(abs(g["pos"] - one.pos.cpu().numpy()).max())
        exact = ("n_bond", "n_jump") if dtype == "f32" else (
            "n_bond", "n_jump", "bond_at1", "bond_at2", "bond_type", "types",
            "parents", "spec_number")
        differ = [k for k in exact
                  if not torch.equal(getattr(st.rg, k), getattr(one, k))]
        log(f"  {nm} ({dtype}) over {n_dev} slabs vs one device "
            f"({d['cfg'].pair_engine} engine), {n} steps: max|dpos| "
            f"{dpos:.3e} A (limit {atol}); n_bond {int(st.rg.n_bond)} vs "
            f"{int(one.n_bond)}, n_jump {int(st.rg.n_jump)} vs "
            f"{int(one.n_jump)}; {', '.join(exact)} "
            f"{'equal' if not differ else 'DIFFER: ' + str(differ)}; "
            f"{int(st.mig_total)} migrated, {int(st.mig_lost)} lost")
        check(dpos <= atol and not differ and int(st.mig_lost) == 0,
              f"{nm} ({dtype}): mesh and one-device steps differ")
        check(int(st.rg.n_bond) > 0 or int(st.rg.n_jump) > 0,
              f"{nm}: no bond and no jump in {n} steps")

    phase("topology on the slab mesh: profiles of replayed bare steps")
    for nm, (deck, n_dev, kw) in paths.items():
        profile(deck, mesh=n_dev, n=depth[nm][2], **kw)
        tag = os.path.basename(deck) + f" over {n_dev} slabs" + (
            f" ({kw['pair_engine']})" if kw else "")
        res[nm].update(busy_graph=BUSY.get((tag, "graph")),
                       idle_graph=IDLE.get((tag, "graph")))

    phase("topology on the slab mesh: replayed programs timed with CUDA "
          "events: a step, and the work that runs once for all slabs")
    for nm, (cfg, ff, aux, comm, st, multi) in systems_.items():
        static = clone_state(multi(clone_state(st), ff, 2))
        scratch = clone_state(static)
        torch.cuda.synchronize()
        step_fn = multi.fns["step"]
        N = cfg.n_at
        parts = {"step": (lambda: advance_in_place(step_fn, static, ff),
                          lambda: step_fn(scratch, ff))}

        def per_slot(s):
            return {k: getattr(s, k) for k in slab.PER_SLOT}, s.gid >= 0

        if static.rg is not None:
            def reactive_work(s):
                sd, valid = per_slot(s)
                stage2, *_, rg = slab_react.reactive_pass(
                    cfg, ff, comm, N, sd, valid, s.rg, s.rng, s.step)
                return stage2(rg, s.rng)

            def candidate_rows(s):
                sd, valid = per_slot(s)
                pos_g = slab_react.assemble_global(comm, N, s.gid, valid,
                                                   s.pos)
                return slab_react.candidate_rows(
                    cfg, ff, comm, s.gid, valid, s.pos, pos_g, s.rg.types,
                    s.rg.parents, cfg.use_bnd == 2 and cfg.use_linkage != 0,
                    cfg.ejtype != 0)

            parts["reactive pass + continuation"] = reactive_work
            parts["candidate rows"] = candidate_rows
            parts["assemble_global (pos)"] = lambda s: \
                slab_react.assemble_global(comm, N, s.gid, s.gid >= 0, s.pos)
        else:
            parts["bonded pass"] = lambda s: slab._bonded_pass(
                cfg, ff, comm, *per_slot(s))
        progs = {}
        for key, fn in parts.items():
            body, warm = fn if key == "step" else (
                lambda fn=fn: fn(static), lambda fn=fn: fn(scratch))
            progs[key] = Program(f"{nm} {key}", body, warm, dev)
        keys = list(progs)
        n = depth[nm][3]
        ms = dict(zip(keys, timed(torch, [progs[k].replay for k in keys],
                                  n=n)))
        shares = {k: ms[k] / ms["step"] for k in keys if k != "step"}
        log(f"  {nm}: step {ms['step']:.4f} ms replayed; " + ", ".join(
            f"{k} {ms[k]:.4f} ms ({shares[k]:.3f} of a step)"
            for k in shares) + f" (CUDA events, medians of {2 * n}) on "
            f"{card}")
        res[nm].update(step_ms=ms["step"], parts_ms={
            k: ms[k] for k in shares}, parts_share=shares)
    return res, k2_launches


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
    from aztotmd_tpu_torch.ops import (allpairs, cellblock, cuda_build, sparse,
                                       thermostat)
    from aztotmd_tpu_torch.ops.elec import ewald_recip
    from aztotmd_tpu_torch.parallel import slab
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    from aztotmd_tpu_torch.runtime.step import make_multi_step

    card = card_line()
    log(card)
    toolchain(torch, cuda_build)
    build_all(cuda_build, ["allpairs", "sparse", "cellblock",
                           "allpairs_rect", "rdf", "tstat"])
    counters = {"allpairs": (allpairs, "launches"),
                "allpairs_cand": (allpairs, "cand_launches"),
                "sparse": (sparse, "launches"),
                "sparse_cand": (sparse, "cand_launches"),
                "cellblock": (cellblock, "launches"),
                "allpairs_rect": (allpairs, "rect_launches"),
                "tstat": (thermostat, "launches")}

    # --- the all-pairs RDF kernel against its plain version ---
    phase("RDF kernel (csrc/rdf.cu, all-pairs counts) vs plain (integer "
          "counts exactly equal), then timed:")
    log(f"rdf kernel on {card}: "
        + json.dumps(rdf_kernel_phase(torch, dev, out, card)))

    # --- the radiative thermostat's kernel against its plain version ---
    phase("thermostat kernel (csrc/tstat.cu) vs plain (rng words exactly, "
          "the rest within 2e-6 f32 / 1e-13 f64), launches a run step, "
          "timed:")
    log(f"thermostat kernel on {card}: "
        + json.dumps(tstat_kernel_phase(torch, dev, out, card)))

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
    d = load_deck_dir(ARGON_DECK, device=dev)
    st = d["state"]
    g = d["cfg"].grid
    check(d["cfg"].pair_engine == "pallas"
          and allpairs.pallas_branch(d["cfg"], torch.float32) == "stacked",
          'liquid_argon through "auto" does not take the stacked pass')
    nz3, smem3 = cellblock.stacked_plan(g.cap, g.dims, d["cfg"].n_at,
                                        d["cfg"].n_spec)
    log(f"  liquid_argon: grid {g.dims} cap {g.cap}, half-stencil slot "
        f"pairs {14 * g.cap * g.cap * g.n_cell}; plan: runs of {nz3} cells "
        f"a block, {g.dims[0] * g.dims[1] * -(-g.dims[2] // nz3)} blocks of "
        f"288 threads, {9 * (nz3 + 2)} staged cells and {smem3} bytes of "
        "dynamic shared memory a block")
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
    # bonded_fluid over 4 slabs on "pallas": K2 beside the bonded pass,
    # at its first step (no B-B pair in range yet) and after
    # BONDED_K2_STEPS slab steps, where its pairs are in range and atoms
    # have migrated between the slabs (timed and bounded at that state)
    cfg, ff, aux, comm, st = mesh_system(load_deck_dir, BONDED_DECK, 4, dev,
                                         pair_engine="pallas")
    check(cfg.pair_engine == "pallas" and cfg.dtype == "f32",
          f"bonded_fluid over 4 slabs routed to {cfg.pair_engine}")
    bonded_k2_first = (cfg, ff) + rect_args(slab, cfg, comm, st)
    st = slab.make_slab_multi_step(cfg, aux, comm)(st, ff, BONDED_K2_STEPS)
    log(f"  bonded_fluid over 4 slabs: slot capacity {st.pos.shape[1]}, "
        f"atoms a slab {(st.gid >= 0).sum(1).tolist()} after "
        f"{BONDED_K2_STEPS} steps ({int(st.mig_total)} migrated)")
    k2_in["bonded_fluid"] = (cfg, ff) + rect_args(slab, cfg, comm, st)
    k2_err = max(compare_rect("surkov_cluster over 2 slabs (radii)",
                              *k2_in["surkov_cluster"]),
                 compare_rect("nanoclusters over 4 slabs",
                              *k2_in["nanoclusters"]),
                 compare_rect("bonded_fluid over 4 slabs", *bonded_k2_first),
                 compare_rect(f"bonded_fluid over 4, step {BONDED_K2_STEPS}",
                              *k2_in["bonded_fluid"]))
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
    def argon_block(o):
        r = MDRunner(load_deck_dir(ARGON_DECK, device=dev,
                                   pair_engine="block"),
                     out_dir=o, quiet=True)
        r.run(TILED_STEPS)
        r.finalize()
        return r

    runs["liquid_argon"] = drive(
        cli, counters, "liquid_argon (auto: K3)", ARGON_DECK,
        os.path.join(out, "liquid_argon"), NEW_STEPS)
    check(runs["liquid_argon"][0].cfg.pair_engine == "pallas",
          'liquid_argon is not on the pallas engine through "auto"')
    runs["liquid_argon_block"] = drive(
        cli, counters, "liquid_argon (torch cell-block engine, named)",
        None, os.path.join(out, "liquid_argon_block"), TILED_STEPS,
        runner_fn=argon_block)
    check(runs["liquid_argon_block"][0].cfg.pair_engine == "block",
          'liquid_argon with pair_engine="block" is not on the block engine')
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
        check(launches == expected_launches(counters, runner, kern),
              f"the {nm} run's pair passes did not all go through "
              f"{kern or 'torch ops'}, or its thermostat not through "
              "csrc/tstat.cu")
    runner = runs["nanoclusters"][0]
    log(f"  nanoclusters sparse pair_cap: {cap} at start, "
        f"{runner.cfg.sparse_pair_cap} at end "
        f"({'regrown' if runner.cfg.sparse_pair_cap != cap else 'no regrow'}"
        f"); worklist need at the last check "
        f"{int(runner.state.cell_overflow)}")
    log(f"steps/s on {card} (CUDA-graph replays through run): " + ", ".join(
        f"{nm} {r[2]:.1f}" for nm, r in runs.items()))

    # --- CUDA-graph replays against eager steps, every deck ---
    phase(f"CUDA-graph replays vs eager steps: 1 + {GRAPH_STEPS} steps each "
          "from the same state (integer fields exactly, positions within "
          f"{GRAPH_POS_ATOL} A; rates over the {GRAPH_STEPS} timed steps)")
    rates, one_graph = {}, {}
    for nm, deck, kw in (("surkov_cluster", SURKOV_DECK, {}),
                         ("nanoclusters", NANO_DECK, {}),
                         ("reactive_polymer", POLY_DECK, {}),
                         ("ejump_redox", EJUMP_DECK, {}),
                         ("molten_salt", SALT_DECK, {}),
                         ("liquid_argon (auto, K3)", ARGON_DECK, {}),
                         ("liquid_argon (block engine)", ARGON_DECK,
                          {"pair_engine": "block"}),
                         ("argon_gas", GAS_DECK, {}),
                         ("bonded_fluid", BONDED_DECK, {})):
        d = load_deck_dir(deck, device=dev, **kw)
        res = graph_case(torch, nm, make_multi_step(d["cfg"], d["aux"]),
                         d["state"], d["ff"], keep=nm in ATOMS_STEPS)
        rates[nm] = res[:3]
        if nm in ATOMS_STEPS:
            one_graph[nm] = res[3]
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK)):
        cfg, ff, aux, comm, st = mesh_system(load_deck_dir, deck,
                                             MESH_DEV[nm], dev)
        key = f"{nm} --mesh {MESH_DEV[nm]}"
        rates[key] = graph_case(torch, key, slab.make_slab_multi_step(
            cfg, aux, comm), st, ff)
    log(f"bare steps/s on {card}, eager -> graph (nodes a step): " + ", ".join(
        f"{nm} {e:.1f} -> {g:.1f} ({n})" for nm, (e, g, n) in rates.items()))

    # --- the atom-sharded mode, the domain pass, the entry points ---
    atoms = atoms_mesh_phases(torch, dev, out, cli, counters, card, rates,
                              one_graph)
    del one_graph
    log(f"atoms mesh numbers on {card}: " + json.dumps(atoms))
    domain = domain_phase(torch, dev, card)
    entry_api_phases(torch, cli, out, card)

    phase("the RDF sample, one device: eager and replayed (CUDA events, "
          "medians of 20), counts against torch.bincount's")
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK),
                     ("reactive_polymer", POLY_DECK),
                     ("ejump_redox", EJUMP_DECK), ("molten_salt", SALT_DECK),
                     ("liquid_argon", ARGON_DECK), ("argon_gas", GAS_DECK),
                     ("bonded_fluid", BONDED_DECK)):
        rdf_case(torch, nm, MDRunner(load_deck_dir(deck, device=dev),
                                     out_dir=os.path.join(out, "rdf_" + nm),
                                     quiet=True), card)

    phase("run --debug --timings, run --profile LOG_DIR, bench")
    cli_flag_runs(cli, out, card)

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
                 lambda c, f, p, t, radii=None, **kw: k3[1](c, f, p, t, radii))
    trajectories(torch, load_deck_dir, make_multi_step, "molten_salt",
                 SALT_DECK, dev, plain_pair(k1[1]))
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK)):
        mesh_trajectory(torch, load_deck_dir, make_multi_step, nm, deck,
                        MESH_DEV[nm], dev)

    # --- where a step's time goes (the profiler adds its own cost) ---
    phase("profiles")
    def profile(deck, **kw):
        return profile_steps(torch, load_deck_dir, make_multi_step,
                             counters, deck, dev, **kw)

    # each deck replayed from its captured step (the run's path; the
    # kernels' profiler times) and eager (graph=False), for the idle share
    prof = {}
    for deck in (SURKOV_DECK, NANO_DECK, POLY_DECK, EJUMP_DECK, SALT_DECK):
        # ejump_redox's five jump passes give ~18,600 profiler events an
        # eager step, whose processing dominated this phase: 10 eager
        # steps of it (a replay has ~4,300 kernel events: 50 replays)
        n = 10 if deck == EJUMP_DECK else PROFILE_STEPS
        profile(deck, n=n, graph=False)
        prof[deck] = profile(deck)
    profile(ARGON_DECK, graph=False)         # "auto": K3
    prof[ARGON_DECK] = profile(ARGON_DECK)
    profile(ARGON_DECK, n=10, graph=False, pair_engine="block")
    profile(ARGON_DECK, n=10, pair_engine="block")
    poly_x3 = tiled["reactive_polymer"]
    profile(poly_x3, pair_engine="sparse", graph=False)
    prof[poly_x3] = profile(poly_x3, pair_engine="sparse")
    for nm, deck in (("surkov_cluster", SURKOV_DECK),
                     ("nanoclusters", NANO_DECK)):
        profile(deck, mesh=MESH_DEV[nm], graph=False)
        prof[nm + "_mesh"] = profile(deck, mesh=MESH_DEV[nm])

    # --- bonds, angles and reactive topology on the slab mesh ---
    topo, k2_topo = topology_mesh_phases(torch, dev, out, cli, counters,
                                         card, tiled, profile)
    log(f"topology mesh numbers on {card}: " + json.dumps(topo))

    # --- timing at the paths' sizes: wrapper, kernel alone, plain ---
    phase("timing")
    def replayed(name, fn):
        """``fn`` captured as a CUDA graph: a call replays it (the
        wrapper's device time, launch overhead gone)."""
        from aztotmd_tpu_torch.runtime.graph import Program
        p = Program(name, fn, fn, dev)
        return p.replay

    def timing(nm, fns, args, kw, alone):
        # the plain K4-cand passes take ~0.6 s a call: fewer calls there
        n = 10 if args[0].n_at < 9000 else 4
        wrapper = lambda: fns[0](*args, **kw)
        ms, ms_alone, ms_plain, ms_rep = timed(torch, [
            wrapper, alone, lambda: fns[1](*args, **kw),
            replayed(nm, wrapper)], n=n)
        log(f"timing {nm} N={args[0].n_at}: wrapper {ms:.4f} ms, wrapper "
            f"replayed {ms_rep:.4f} ms, kernel alone {ms_alone:.4f} ms, "
            f"plain {ms_plain:.4f} ms per call (medians of {2 * n}, CUDA "
            f"events) on {card}")
        return ms, ms_alone, ms_plain, ms_rep

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
        wrapper = lambda: allpairs.pair_forces_allpairs_rect(cfg, ff, *args,
                                                             **kw)
        ms, ms_alone, ms_rep = timed(torch, [
            wrapper, alone, replayed("K2 " + nm, wrapper)], n=n)
        ms_plain, = timed(torch, [
            lambda: allpairs.pair_forces_allpairs_rect_plain(cfg, ff, *args,
                                                             **kw)], n=2)
        L, ni = args[0].shape[:2]
        lib = allpairs._rect_lib()
        tile, groups = (lib.aztotmd_allpairs_rect_tile(),
                        lib.aztotmd_allpairs_rect_groups())
        n_split = allpairs.rect_split(L, ni, args[3].shape[1], tile, groups,
                                      allpairs.sm_count(dev))
        log(f"plan K2 {nm}: {n_split} splits x {L} slabs x "
            f"{-(-ni // tile)} i tiles = {n_split * L * -(-ni // tile)} "
            f"blocks of {groups} x {tile} threads")
        log(f"timing K2 {nm} over {args[0].shape[0]} slabs: wrapper "
            f"{ms:.4f} ms, wrapper replayed {ms_rep:.4f} ms, kernel alone "
            f"{ms_alone:.4f} ms (medians of {2 * n}), plain {ms_plain:.4f} "
            f"ms (median of 4), CUDA events, on {card}")
        alones["K2" if nm == "surkov_cluster" else "K2 " + nm] = alone
        return ms, ms_alone, ms_plain, ms_rep

    times["K2"] = k2_timing("surkov_cluster")
    times["K2 nanoclusters"] = k2_timing("nanoclusters")
    times["K2 bonded_fluid"] = k2_timing("bonded_fluid")
    kprof = {}
    for key, fn in alones.items():
        # K2 on bonded_fluid is a launch of a few microseconds, of which a
        # profile of 20 once recorded none: ALONE_LAUNCHES back to back
        n = ALONE_LAUNCHES if key == "K2 bonded_fluid" else 20
        kprof[key], seen = profile_alone(fn, n)
        log(f"profile {key}: kernel alone "
            + (f"{kprof[key]:.4f} ms a launch" if kprof[key] else
               "not measured (no device time recorded)")
            + f" (torch.profiler, mean of the {seen} of {n} launches it "
            f"recorded) on {card}")

    def graph_alone(name, fn, n=ALONE_LAUNCHES):
        """ms a launch of ``fn`` over a CUDA graph of n back-to-back
        launches, CUDA events around each replay (no host call between
        the launches; each node's own launch gap included)."""
        from aztotmd_tpu_torch.runtime.graph import Program
        p = Program(name, lambda: [fn() for _ in range(n)], fn, dev)
        ms, = timed(torch, [p.replay], n=5)
        return ms / n

    k2b_graph = graph_alone("K2 bonded_fluid alone", alones["K2 bonded_fluid"])
    log(f"timing K2 bonded_fluid: kernel alone {k2b_graph:.5f} ms a launch "
        f"over a graph of {ALONE_LAUNCHES} back-to-back launches (medians of "
        f"10 replays, CUDA events) on {card}")

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
    filled_bounds = {}

    def k2_bound(key, nm, fam):
        # the work this run's data needs: the filled slot pairs of the (i
        # sub-tile, j sub-tile) pairs that K2's warp cull keeps (the
        # kernel's own record of one launch, held exactly against
        # allpairs.rect_subtile_keep), each at the cost of the
        # displacement, min-image and cutoff test, and the pairs in range at
        # the cost of the physics; each input read once, each output written
        # once.  Every pair of filled slots (i an owned slot, j an owned or
        # halo slot, not the same slot: the count up to the culling kernel)
        # is kept beside it as bound_filled_ms
        cfg, ff, args, kw = k2_in[nm]
        L, ni = args[0].shape[:2]
        nj = args[3].shape[1]
        keep = allpairs.rect_kernel_keep(cfg, ff, *args, **kw)
        check(torch.equal(keep, allpairs.rect_subtile_keep(
            cfg, args[0], args[2], args[3], args[5])),
            f"K2 {nm}: the kernel's warp cull is not "
            "allpairs.rect_subtile_keep")
        kept = allpairs.rect_kept_slot_pairs(keep, args[2], args[5])
        slots, pairs = rect_pairs(torch, cfg, args)
        log(f"K2 {nm}: {slots} pairs of filled slots of {L * ni * nj} "
            f"padded slot pairs ({L} slabs x {ni} x {nj}); the kernel's "
            f"warps kept {int(keep.sum())} of {keep.numel()} sub-tile pairs "
            f"(equal to allpairs.rect_subtile_keep), {kept} filled slot "
            f"pairs ({kept / slots:.4f}); the bound counts these")
        nb = L * (ni + nj) * (12 + 4 + 1 + (4 if kw["radii_i"] is not None
                                            else 0)) + L * ni * 12 + 8 * L
        filled_bounds[key] = bound(slots, pairs, fam, nb)
        log(f"bound {key} over every filled slot pair: "
            f"{filled_bounds[key][0]:.4g} ms ({filled_bounds[key][2]})")
        return kept, pairs, bound(kept, pairs, fam, nb)

    bounds["K2"] = k2_bound("K2", "surkov_cluster", "surk")
    bounds["K2 nanoclusters"] = k2_bound("K2 nanoclusters", "nanoclusters",
                                         "lnjs")
    bounds["K2 bonded_fluid"] = k2_bound("K2 bonded_fluid", "bonded_fluid",
                                         "lnjs")
    for key, (slots, pairs, b) in bounds.items():
        log(f"bound {key}: {slots} slot pairs, {pairs} in range: "
            f"{b[0]:.4g} ms ({b[2]}); computed from the operation count "
            "of csrc/pair_physics.cuh, not from a counter")

    phase("NCCL DistRing")
    log(dist_phase(out))

    nbr_res = neighbor_phases(torch, dev, out, cli, counters, card, profile)
    log("neighbor engine numbers: " + json.dumps(nbr_res))
    log("scale, dilute, nve, gather and bench numbers on " + card + ": "
        + json.dumps(scale_phases(torch, dev, out, cli, counters, card)))
    log("stat ring numbers on " + card + ": "
        + json.dumps(ring_phase(torch, dev, out, card)))
    phase("every phase passed")
    log(f"device idle share on {card}, eager -> graph (torch.profiler; "
        "per profile above): " + ", ".join(
            f"{tag} {_share(IDLE.get((tag, 'eager')))} -> "
            f"{_share(IDLE.get((tag, 'graph')))}"
            for tag in dict.fromkeys(t for t, _ in IDLE)))
    log(f"device busy time (profiled) over the wall time of the same steps "
        f"without the profiler, on {card}, eager -> graph: " + ", ".join(
            f"{tag} {_share(BUSY.get((tag, 'eager')))} -> "
            f"{_share(BUSY.get((tag, 'graph')))}"
            for tag in dict.fromkeys(t for t, _ in BUSY)))

    def prof_ms(deck, kernel):
        """Profiler device ms a launch of the kernel instantiation whose
        name holds ``kernel`` over the profiled bare steps, one launch a
        step, the mean over the launches the profiler recorded (None when
        the deck's profile was incomplete or recorded none)."""
        by = [v for k, v in (prof.get(deck) or {}).items() if kernel in k]
        c = sum(n for _, n in by)
        return sum(t for t, _ in by) * 1e3 / c if c else None

    def entry(name, source, replaces, launches, err, key, extra=None):
        ms, alone, plain, rep = times[key]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "kernel_ms": alone,
               "wrapper_replay_ms": rep,
               "plain_ms": plain, "bound_ms": bounds[key][2][0],
               "bound_by": bounds[key][2][1], "library_ms": None,
               "kernel_profiler_ms": kprof[key]}
        rec.update(extra or {})
        return rec

    l = {nm: r[1] for nm, r in runs.items()}
    salt = times["K1 molten_salt"]
    k1c_launch = (l["reactive_polymer"]["allpairs_cand"]
                  + l["ejump_redox"]["allpairs_cand"]
                  + atoms["ejump_redox"]["launches"])
    k4c_launch = (l["reactive_polymer_x3"]["sparse_cand"]
                  + l["ejump_redox_x3"]["sparse_cand"])
    ej1 = times["K1-cand ejump_redox"]
    ej4 = times["K4-cand ejump_redox x3"]
    k2n = times["K2 nanoclusters"]
    k2b = times["K2 bonded_fluid"]
    return [
        entry("allpairs_rect", "aztotmd_tpu_torch/csrc/allpairs_rect.cu",
              "aztotmd_tpu/ops/pallas_pair.py:708",
              l["surkov_cluster_mesh"]["allpairs_rect"]
              + l["nanoclusters_mesh"]["allpairs_rect"] + k2_topo, k2_err,
              "K2",
              {"profiler_ms": prof_ms("surkov_cluster_mesh", "rect_kernel"),
               "bound_filled_ms": filled_bounds["K2"][0],
               "nanoclusters": {
                   "ms": k2n[0], "kernel_ms": k2n[1], "plain_ms": k2n[2],
                   "wrapper_replay_ms": k2n[3],
                   "bound_ms": bounds["K2 nanoclusters"][2][0],
                   "bound_filled_ms": filled_bounds["K2 nanoclusters"][0],
                   "kernel_profiler_ms": kprof["K2 nanoclusters"],
                   "profiler_ms": prof_ms("nanoclusters_mesh",
                                          "rect_kernel")},
               "bonded_fluid": {
                   "ms": k2b[0], "kernel_ms": k2b[1], "plain_ms": k2b[2],
                   "wrapper_replay_ms": k2b[3],
                   "bound_ms": bounds["K2 bonded_fluid"][2][0],
                   "bound_filled_ms": filled_bounds["K2 bonded_fluid"][0],
                   "kernel_profiler_ms": kprof["K2 bonded_fluid"],
                   "kernel_graph_events_ms": k2b_graph}}),
        entry("allpairs", "aztotmd_tpu_torch/csrc/allpairs.cu",
              "aztotmd_tpu/ops/pallas_pair.py:335",
              l["surkov_cluster"]["allpairs"] + l["molten_salt"]["allpairs"]
              + atoms["molten_salt"]["launches"], k1_err, "K1",
              {"profiler_ms": prof_ms(SURKOV_DECK, "allpairs_kernel<false, "
                                      "false, false>"),
               "molten_salt": {
                   "ms": salt[0], "kernel_ms": salt[1], "plain_ms": salt[2],
                   "wrapper_replay_ms": salt[3],
                   "bound_ms": bounds["K1 molten_salt"][2][0],
                   "kernel_profiler_ms": kprof["K1 molten_salt"],
                   "profiler_ms": prof_ms(SALT_DECK, "allpairs_kernel<false, "
                                          "false, false>"),
                   "ewald_recip_ms": ewald_ms},
               "domain_pass_ms": domain[0], "all_pairs_plain_ms": domain[1]}),
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
                   "wrapper_replay_ms": ej1[3],
                   "bound_ms": bounds["K1-cand ejump_redox"][2][0],
                   "kernel_profiler_ms": kprof["K1-cand ejump_redox"],
                   "profiler_ms": prof_ms(EJUMP_DECK, "allpairs_kernel<false, "
                                          "true, false>")}}),
        entry("sparse", "aztotmd_tpu_torch/csrc/sparse.cu",
              "aztotmd_tpu/ops/pallas_sparse.py:129",
              l["nanoclusters"]["sparse"] + atoms["nanoclusters"]["launches"],
              k4_err, "K4",
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
                  "wrapper_replay_ms": ej4[3],
                  "bound_ms": bounds["K4-cand ejump_redox x3"][2][0],
                  "bound_worklist_ms":
                      worklist_bounds["K4-cand ejump_redox x3"][0],
                  "kernel_profiler_ms": kprof["K4-cand ejump_redox x3"]}})]


if __name__ == "__main__":
    sys.exit(main())
