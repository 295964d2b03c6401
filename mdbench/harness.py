"""One run of one cell: the deck from the seed, set-up and warm-up through
the port's user path, one timed ``MDRunner.run`` call, the per-layer
readings of a traced run, and the check against the plain reference.

The timed window is what ``python -m aztotmd_tpu_torch run`` does to a
deck: ``load_deck_dir`` on the card, ``MDRunner`` with its outputs in a
temporary directory, ``run()``.  The warm-up runs the deck's first steps
through the same runner: one stat period, which captures every program
the window replays, then the rest of the deck's equilibration steps and at
least ``WARMUP_MIN_STEPS``.  The window is whole ring windows, those the
runner takes from the warm-up's end (``window_unit``), as many as the
cell's nominal rate fills in ``--seconds``, in one ``run()`` call, as a
user's run is: slicing it would add host events and change the ring's
window.

The check follows the program from its own state: MD is chaotic, so two
float32 trajectories of thousands of steps part and no reference can
follow the window itself.  After the window the runner's own captured
programs take one RDF sample and one step from the state the window ended
in, on the lists the window left there (on the Verlet list the inner list
of its last refine, refined from the outer list of its last rebuild), and
the reference recomputes both from that state with its own full pair
search.  What this skips is checked by itself: the start (the loaded
state against the reference's own read of the deck and draws from the
seed) and the window's stat rows (each period's row present and in
order).

On the card a cell fails at once, after the load and before any runner,
capture or warm-up, when the port says that its pair pass there is a
torch engine (``runtime.step.torch_engine_reason``): the window's steps
are fixed from the cell's nominal rate, and such an engine can run far
below it, so the run would outlast its time.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time

import torch

from . import decks, registry
from .reference import compare
from .reference.md import Reference, deck_params, initial


# a warm-up of at least this many steps (the deck's equilibration where
# longer); a traced run profiles its last PROFILE_WINDOWS ring windows
WARMUP_MIN_STEPS = 1000
PROFILE_WINDOWS = 1


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _snap(st):
    """The fields the check compares, as float64 copies on the device."""
    return {"x": st.pos.double().clone(), "v": st.vel.double().clone(),
            "f": st.frc.double().clone(), "engs": st.engs.double().clone(),
            "radii": st.radii.double().clone(),
            "chit": st.chit.double().clone(),
            "consint": st.consint.double().clone(), "step": int(st.step),
            "energies": {k: float(getattr(st.energies, k))
                         for k in compare.ENERGY_COLS}}


def read_stat(path):
    """(column names, rows as lists of floats) of stat.dat."""
    with open(path) as f:
        names = f.readline().rstrip("\n").split("\t")
        f.readline()
        rows = [[float(x) for x in ln.split("\t")] for ln in f if ln.strip()]
    return names, rows


_STAT_COLS = {"tot": "engTot", "kin": "engKin", "vdw": "engVdW",
              "coul1": "engCoul1", "coul2": "engCoul2", "temp": "engTerm"}


def row_energies(names, row):
    """The energies of a stat row, those of ``_STAT_COLS`` that stat.dat
    has (no engTerm column but under the radiative thermostat)."""
    return {k: row[names.index(c)] for k, c in _STAT_COLS.items()
            if c in names}


def rows_gap(rows, names, period, last):
    """Stat rows missing, repeated or out of order against one every
    ``period`` steps up to ``last``."""
    got = [int(r[names.index("step")]) for r in rows]
    want = list(range(period, last + 1, period))
    bad = sum(1 for a, b in zip(got, want) if a != b)
    return bad + abs(len(got) - len(want))


def window_unit(runner, start):
    """Steps of the ring window that ``runner`` takes in a ``run()`` call
    from step ``start`` to a multiple of it: the stat period times
    ``_run_loop_ring``'s ``n_fix``, the largest divisor, up to ``s_cap``,
    of the stat periods in the gcd of the host periods and ``start``; one
    stat period off the ring."""
    p = runner.p_stat
    if not (runner.ring_ok and p):
        return max(p, 1)
    w = start
    for h in runner._host_periods:
        w = math.gcd(w, int(h))
    k = w // p if w % p == 0 else 1
    return p * max(d for d in range(1, min(runner.s_cap, k) + 1)
                   if k % d == 0)


def torch_engine_guard(cfg, dtype):
    """Raise when the port's pair pass for ``cfg`` with state type
    ``dtype`` on the card is a torch engine rather than a kernel, with
    the port's reason, or when the port no longer says so."""
    try:
        from aztotmd_tpu_torch.runtime.step import torch_engine_reason
    except ImportError as e:
        raise RuntimeError(
            "mdbench: aztotmd_tpu_torch.runtime.step.torch_engine_reason, "
            "which tells whether the pair pass is a torch engine, is "
            f"gone: {e}") from e
    reason = torch_engine_reason(cfg, dtype)
    if reason:
        raise RuntimeError(
            f"mdbench: the pair pass ({cfg.pair_engine!r}) on the card is "
            f"a torch engine: {reason}; the cell's window is fixed from "
            "its nominal rate and would outlast the run's time")


class Context:
    """What a per-layer metric reader reads: the cell, the runner after the
    window, a copy of the window's final state, the harness's spans and
    counters and the profile of the traced stretch.  ``memo`` keeps a
    measurement that two readers share."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.memo = {}


def run_cell(name, seed, seconds, trace, device, t_start, root=None,
             controls=False):
    """Run cell ``name`` once; returns the result's fields (see run.py).
    ``controls``: also compute the control's readings (the reference in
    bfloat16 in the program's place) from the same state."""
    from aztotmd_tpu_torch.runtime import step as step_mod
    from aztotmd_tpu_torch.runtime.graph import clone_state
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir

    t_run = time.perf_counter()
    dev = torch.device(device)
    w = registry.workload(name, root or registry.ROOT)
    cfg, traffic = w["config"], w["traffic"]
    deck = cfg["decks"][traffic["deck"]]
    p = deck_params(deck["control"], deck["field"])
    period = p["stat"]
    tmp = tempfile.mkdtemp(prefix="mdbench_")
    try:
        deck_dir = os.path.join(tmp, "deck")
        out_dir = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        pos0, box = decks.make_deck(cfg, traffic, seed, deck_dir)
        gen_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        sysd = load_deck_dir(deck_dir, seed=seed, device=dev)
        _sync(dev)
        load_s = time.perf_counter() - t0
        st0 = sysd["state"]
        if dev.type == "cuda":
            torch_engine_guard(sysd["cfg"], st0.pos.dtype)
        start = {"x": st0.pos.double().clone(), "v": st0.vel.double().clone()}
        if p["tstat"] == "radi":
            start["photons"] = sysd["aux"].photons.double().clone()
        runner = MDRunner(sysd, out_dir=out_dir, quiet=True)

        # warm-up: the deck's first steps through the same runner, the
        # first stat period capturing the programs
        warm = max(p["n_equil"], WARMUP_MIN_STEPS)
        warm = -(-warm // period) * period
        unit = window_unit(runner, warm)
        t0 = time.perf_counter()
        runner.run(period)
        cap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner.run(warm)
        warm_rate = (warm - period) / max(time.perf_counter() - t0, 1e-9)
        # the window's work is fixed by the cell's nominal rate, not by a
        # measured one: every seed runs the same steps
        n_win = max(1, round(float(w["steps_per_second"]) * seconds / unit))
        prof_steps = PROFILE_WINDOWS * unit if trace else 0
        if trace:
            n_win = max(n_win, PROFILE_WINDOWS + 1)
        L = n_win * unit
        T0 = warm
        setup_s = time.perf_counter() - t_start
        log(f"# {name} seed={seed}: imports and device "
            f"{t_run - t_start:.3f} s, deck {gen_s:.3f} s, load {load_s:.3f}"
            f" s, first period {cap_s:.3f} s, warm-up {warm} steps at "
            f"{warm_rate:.1f} steps/s; window {L} steps ({unit} a ring "
            f"window); setup {setup_s:.3f} s")

        # the timed window: one run() call
        counts0 = dict(step_mod.nbr_counts)
        prof = None
        t0 = time.perf_counter()
        if not trace:
            runner.run(T0 + L)
            wall = time.perf_counter() - t0
            win_steps, win_wall = L, wall
        else:
            # a first stretch unprofiled for the ratios, then the last
            # whole ring windows under the profiler
            L1 = L - prof_steps
            runner.run(T0 + L1)
            win_wall = time.perf_counter() - t0
            win_steps = L1
            from . import trace as trace_mod
            prof = trace_mod.profile(lambda: runner.run(T0 + L), dev)
            log(f"# profiled {prof_steps} steps: busy {prof['busy_s']} s of"
                f" {prof['wall_s']} s, idle while in the profiler's buffer "
                f"requests {prof['profiler_idle_s']} s")
            wall = time.perf_counter() - t0
        counts1 = dict(step_mod.nbr_counts)
        steps_done = int(runner.state.step) - T0
        if (steps_done == L and runner.ring_ok
                and runner.n_fix * period != unit):
            raise RuntimeError(f"the window ran ring windows of "
                               f"{runner.n_fix} periods, not {unit} steps")
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        T = T0 + L
        ns_per_day = L * p["dt"] * 1e-3 * 86400.0 / wall
        log(f"# window: {L} steps in {wall:.4f} s: {L / wall:.2f} steps/s, "
            f"{ns_per_day:.4f} ns/day; peak {peak} bytes")

        state_a = _snap(runner.state)
        ctx = None
        if trace:
            ctx = Context(cell=name, cfg=cfg, traffic=traffic, seed=seed,
                          device=dev, runner=runner,
                          state=clone_state(runner.state), load_s=load_s,
                          win_steps=win_steps, win_wall=win_wall,
                          nbr_counts=(counts0, counts1), prof=prof,
                          params=p, box=box, unit=unit)
        layer = {}
        if trace:
            for mname, mod in registry.metrics_for(
                    name, root or registry.ROOT).items():
                v = mod.read(ctx)
                if v is not None:
                    layer[mname] = {"value": float(v),
                                    "unit": mod.META["unit"]}
                log(f"# per-layer {mname}: {v}")

        # the check: one RDF sample by the runner's own captured sampler on
        # the state the window ended in, then one step of its own captured
        # step program from that state; the window's stat rows
        hist_a = _sample(runner)
        state_c = _one_step(runner)
        names, rows = read_stat(os.path.join(out_dir, "stat.dat"))
        rows_bad = rows_gap(rows, names, period, T)
        row_t = (row_energies(names, rows[-1])
                 if rows and int(rows[-1][names.index("step")]) == T
                 else None)
        # free the program before the reference runs
        del runner, sysd, st0, ctx
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            log(f"# before the reference: {torch.cuda.memory_allocated(dev)}"
                " bytes allocated")

        t0 = time.perf_counter()
        numbers, control = check(p, box, seed, pos0, start, state_a,
                                 state_c, hist_a, row_t, rows_bad, dev,
                                 controls)
        ref_s = time.perf_counter() - t0
        log(f"# reference: {ref_s:.3f} s")
        correct, checks = compare.verdict(numbers, w["limits"])
        return {"correct": correct, "attempted": L,
                "failed": max(0, L - steps_done), "ns_per_day": ns_per_day,
                "setup_s": setup_s, "layer": layer, "peak": peak,
                "prof": prof, "checks": checks, "control": control,
                "window_steps": L, "window_s": wall, "ref_s": ref_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sample(runner):
    """One RDF sample of the runner's state by its plan's captured sampler
    (the window's): the histogram's species-pair column, or None."""
    if runner.rcfg is None:
        return None
    runner._zero_hist()
    sample = runner._rdf_plan if runner.use_list else runner._rdf
    h, _ = sample(runner.state, runner.hist, runner.nhist)
    return h[:, 0].double().clone()


def _one_step(runner):
    """One step of the runner's own captured step program from its state,
    on the lists that state holds (no rebuild, no refine: on the Verlet
    list the inner list the window's last refine left): the state's
    fields after it, with its energies."""
    run, current = runner.multi.start(runner.state, runner.ff)
    run("step", 1)
    return _snap(current())


def check(p, box, seed, pos0, start, state_a, state_c, hist_a, row_t,
          rows_bad, dev, controls=False):
    """The numbers of ``compare`` for the run, and with ``controls`` for
    the control: the reference computed in bfloat16 put in the run's
    place, stage by stage: each stage of the start, the step and the RDF
    sample in bfloat16 from the float64 inputs of that stage (the pair
    arithmetic from the minimum-image vectors).  Chained through a step,
    bfloat16 positions in these boxes put distinct atoms within 0.04 A of
    each other and the step overflows, which gives no reading.  Judged the
    same way as the run."""
    n = pos0.shape[0]
    v0, ph = initial(p, n, seed)
    ref_start = {"x": torch.as_tensor(pos0, device=dev),
                 "v": torch.as_tensor(v0, device=dev)}
    if ph is not None:
        ref_start["photons"] = torch.as_tensor(ph, device=dev)
    ref = Reference(p, box, ph, seed, dev, n=n)
    low = torch.bfloat16 if controls else None
    s_ref = ref.step(state_a, low=low)
    if controls:
        s_ref, s_low = s_ref
    if hist_a is None:
        # a run without an RDF sample fails that number
        hist_a = torch.zeros(ref.n_bin)
    numbers = {"start": compare.start_gap(start, ref_start, box),
               "rows": rows_bad,
               **compare.judge(ref, state_c, s_ref, state_c["energies"],
                               hist_a, state_a["x"], box)}
    scale = numbers.pop("scale")
    # the window's last decoded row against the state it was read from; a
    # window without it fails
    numbers["energy"] = max(numbers["energy"], float("inf") if row_t is None
                            else compare.row_gap(row_t, state_a["energies"],
                                                 scale))
    control = None
    if controls:
        c_start = {k: v.to(low).double() for k, v in ref_start.items()}
        eng = {k: float(v) for k, v in s_low["energies"].items()}
        control = {"start": compare.start_gap(c_start, ref_start, box),
                   **compare.judge(ref, s_low, s_ref, eng,
                                   ref.rdf_hist(state_a["x"], low),
                                   state_a["x"], box),
                   "rows": 0}
        control.pop("scale")
    return numbers, control
