"""The captured step (``aztotmd_tpu_torch/runtime/graph.py``) on every
path, on the CPU: small decks built in-tree, run through the runner's own
programs (``MDRunner.multi.fns``: the step and, on the neighbor engine,
the full rebuild and the inner refine; the RDF sample).  The dilute
argon deck (``systems.write_dilute_argon_deck``) refines over the
outer-occupied rows (``nb_orowcap``); "gather" is the per-atom
candidate-matrix engine.

(a) Capture safety: a call after the first builds no tensor from host
    data and makes no host sync (the stat ring's "row" program, which
    writes a period's row into the device ring at a device slot, and its
    "ring_reset" included).  A ``TorchDispatchMode`` records every
    op of the second call; none may be ``aten.lift_fresh`` (a
    ``torch.tensor`` or ``as_tensor`` of host data),
    ``aten._local_scalar_dense`` (``.item()``, ``float()``, ``int()``,
    ``bool()`` of a tensor), ``aten.nonzero``, an op that reads a size
    back from the card (``bincount``, ``masked_select``,
    ``repeat_interleave`` of a tensor, ``unique``), or an
    ``aten.index.Tensor`` / ``index_put`` whose index is a bool tensor.
(b) In place equals functional: the in-place programs that the graphs
    capture (``graph.advance_in_place``: the program, then every field
    copied back into the static state) on the multi-step's own schedule
    equal the functional multi-step bit for bit in every field after 20
    steps.

(c) The runner's stat-period plan (``MDRunner._ring_period``): its RDF
    list program ("rdf_list") and list samples pass (a), and
    two periods run as in-place programs equal two functional periods bit
    for bit, the histograms too, on argon gases that take each of JAX's
    list regimes.

The ``cuda``-marked test replays the graphs against eager steps on the
card (it skips here).
"""

import dataclasses
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.runtime.graph import (advance_in_place, clone_state,
                                             state_leaves)
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")

# ops that take host data or wait for the card
_HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
             "aten.bincount", "aten.masked_select",
             "aten.repeat_interleave.Tensor", "aten._unique",
             "aten.unique", "aten.item")


class _Recorder(TorchDispatchMode):
    """Every op's name; the ops that break a capture."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops += 1
        if name.startswith(_HOST_OPS):
            self.bad.append(name)
        elif name.startswith(("aten.index.Tensor", "aten.index_put")):
            idx = args[1] if len(args) > 1 else ()
            if any(torch.is_tensor(i) and i.dtype == torch.bool
                   for i in idx if i is not None):
                self.bad.append(name + " with a bool index")
        return func(*args, **(kwargs or {}))


def _salt_deck(d, cells=4, a=5.64):
    """examples/molten_salt's rock salt cut to cells^3 unit cells (512
    ions), its control and field, k-vectors up to 5."""
    os.makedirs(d)
    src = os.path.join(EX, "molten_salt")
    with open(os.path.join(src, "field.txt")) as f:
        field = f.read()
    with open(os.path.join(src, "control.txt")) as f:
        control = f.read().replace("\t8\t8\t8", "\t5\t5\t5")
    box = a * cells
    rows = [f"{'Na' if (i + j + k) % 2 == 0 else 'Cl'}\t{i * a / 2:.6f}\t"
            f"{j * a / 2:.6f}\t{k * a / 2:.6f}"
            for i in range(2 * cells) for j in range(2 * cells)
            for k in range(2 * cells)]
    for name, text in (("field.txt", field), ("control.txt", control),
                       ("atoms.xyz", f"{len(rows)}\n1 {box:.6f} {box:.6f} "
                        f"{box:.6f}\n" + "\n".join(rows) + "\n")):
        with open(os.path.join(d, name), "w") as f:
            f.write(text)


def _gas_src(d, n_atoms):
    """An argon gas deck of ``n_atoms`` beside ``d``, the source of a
    dilute deck."""
    src = d + "_src"
    systems.write_argon_gas_deck(src, n_atoms=n_atoms, steps=200)
    return src


# path -> (deck writer or example, load keywords, cfg overrides, runner
# keywords)
PATHS = {
    "pallas dense": (lambda d: systems.write_surkov_cluster_deck(
        d, n_atoms=300, box=20.0, steps=100, n_equil=20), {}, {}, {}),
    "pallas bind candidates": ("reactive_polymer", {}, {}, {}),
    "pallas jump candidates": ("ejump_redox", {}, {}, {}),
    "sparse": (lambda d: systems.write_nanoclusters_deck(
        d, n_clusters=3, per=128, box=50.0, min_sep=25.0, steps=40),
        {"pair_engine": "sparse"}, {}, {}),
    "block": (lambda d: systems.write_liquid_argon_deck(
        d, n_side=8, density=0.012, rcut=4.0, steps=40),
        {"pair_engine": "block"}, {}, {}),
    "neighbor single-level": (
        lambda d: systems.write_argon_gas_deck(d, n_atoms=1000, steps=200),
        {}, {"nb_outer": 1, "nb_rebuild": 6, "nb_rowcap": 0}, {}),
    "neighbor two-level rowcap": (
        lambda d: systems.write_argon_gas_deck(d, n_atoms=1000, steps=200),
        {}, {"nb_outer": 3, "nb_rebuild": 5, "nb_rowcap": 128}, {}),
    "neighbor two-level rowcap orow": (
        lambda d: systems.write_dilute_argon_deck(
            d, steps=200, src=_gas_src(d, 1000)),
        {}, {"nb_outer": 3, "nb_rebuild": 5}, {}),
    "gather": (lambda d: systems.write_liquid_argon_deck(
        d, n_side=8, density=0.012, rcut=4.0, steps=40),
        {"pair_engine": "gather"}, {}, {}),
    "ewald": (_salt_deck, {}, {}, {}),
    "angles": ("bonded_fluid", {}, {}, {}),
    "slab LocalRing 2": (lambda d: systems.write_surkov_cluster_deck(
        d, n_atoms=300, box=24.0, steps=100, n_equil=20), {}, {},
        {"mesh_devices": 2}),
    "slab bonded LocalRing 4": ("bonded_fluid", {}, {}, {"mesh_devices": 4}),
    "slab reactive LocalRing 2": ("reactive_polymer", {}, {},
                                  {"mesh_devices": 2}),
    "slab jumps LocalRing 3": ("ejump_redox", {}, {}, {"mesh_devices": 3}),
    "atoms LocalRing 4": (lambda d: systems.write_surkov_cluster_deck(
        d, n_atoms=300, box=20.0, steps=100, n_equil=20), {}, {},
        {"mesh_devices": 4, "mesh_mode": "atoms"}),
    "atoms neighbor LocalRing 2": ("bonded_fluid", {}, {},
                                   {"mesh_devices": 2, "mesh_mode": "atoms"}),
}


def _runner(name, tmp_path, device="cpu"):
    """The runner of a path (f32; eager on the CPU)."""
    deck, load_kw, cfg_kw, run_kw = PATHS[name]
    if callable(deck):
        d = str(tmp_path / "deck")
        deck(d)
    else:
        d = os.path.join(EX, deck)
    sysd = load_deck_dir(d, dtype="f32", device=device, **load_kw)
    if cfg_kw:
        c = sysd["cfg"] = dataclasses.replace(sysd["cfg"], **cfg_kw)
        N = c.n_at
        full = lambda *s: torch.full(s, N, dtype=torch.int32, device=device)
        sysd["state"] = sysd["state"].replace(
            nbr_idx=full(N, c.n_neigh), nbr2_idx=full(N, max(c.n_neigh2, 1)),
            nbrow_idx=full(max(c.nb_rowcap, 1),
                           1 + (c.n_neigh if c.nb_rowcap else 1)))
    r = MDRunner(sysd, out_dir=str(tmp_path / "out"), quiet=True, **run_kw)
    return r


def _check_path(name, r):
    cfg = r.cfg
    if name.startswith("pallas"):
        assert cfg.pair_engine == "pallas"
    if "bind" in name:
        assert cfg.use_bnd == 2 and cfg.use_linkage
    if "jump" in name:
        assert cfg.ejtype
    if name.startswith("neighbor"):
        assert cfg.pair_engine == "neighbor" and ("refine" in r.multi.fns) \
            == (cfg.nb_outer > 1)
        assert bool(cfg.nb_rowcap) == ("rowcap" in name)
        assert bool(cfg.nb_orowcap) == name.endswith("orow")
    if name == "ewald":
        assert cfg.elec_type == 2
    if name == "angles":
        assert cfg.use_angl
    if name.startswith("atoms"):
        n_dev = PATHS[name][3]["mesh_devices"]
        assert r.comm is None and r._atoms_mesh.n_dev == n_dev
        assert r.state.pos.shape == (n_dev, cfg.n_at // n_dev, 3)
        assert ("rebuild" in r.multi.fns) == ("neighbor" in name)
    elif name.startswith("slab"):
        assert r.comm is not None
        assert r.comm.n_dev == PATHS[name][3]["mesh_devices"]
        assert (r.state.rg is not None) == ("reactive" in name
                                            or "jumps" in name)
    else:
        assert cfg.pair_engine == PATHS[name][1].get("pair_engine",
                                                     cfg.pair_engine)


@pytest.mark.parametrize("name", list(PATHS))
def test_second_call_takes_no_host_data_and_no_sync(name, tmp_path):
    """(a) on every program of the path and on the RDF sample."""
    r = _runner(name, tmp_path)
    _check_path(name, r)
    st, ff = r.state, r.ff
    order = [p for p in ("rebuild", "refine", "step", "row", "ring_reset")
             if p in r.multi.fns]
    assert r.rcfg is not None and "row" in order
    calls = [(p, lambda s, p=p: r.multi.fns[p](s, ff)) for p in order]
    calls.append(("RDF sample", lambda s: (s, r._rdf.fn(s, r.hist,
                                                        r.nhist))))
    for prog, fn in calls:
        out = fn(st)
        rec = _Recorder()
        with rec:
            out = fn(st)
        assert rec.ops > 0
        assert not rec.bad, (prog, sorted(set(rec.bad)))
        if prog != "RDF sample":
            st = out


@pytest.mark.parametrize("name", list(PATHS))
def test_in_place_program_equals_functional(name, tmp_path):
    """(b) 20 steps of the in-place programs on the multi-step's schedule
    against 20 functional steps, every field bit for bit."""
    r = _runner(name, tmp_path)
    multi, ff = r.multi, r.ff
    want = multi(clone_state(r.state), ff, 20)
    static = clone_state(r.state)

    def run(prog, m=1):
        for _ in range(m):
            advance_in_place(multi.fns[prog], static, ff)

    multi.schedule(run, 20)
    got, ref = dict(state_leaves(static)), dict(state_leaves(want))
    assert sorted(got) == sorted(ref)
    assert int(got["step"]) == int(r.state.step) + 20
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pallas dense", "neighbor two-level rowcap",
                                  "neighbor two-level rowcap orow", "gather",
                                  "slab LocalRing 2", "atoms LocalRing 4"])
def test_graph_replays_equal_eager_on_the_card(name, tmp_path):
    """On the card: 30 steps replayed from CUDA graphs against 30 eager
    steps from the same state, integer fields exactly equal, positions
    within 1e-6 A; the launch counters count the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from aztotmd_tpu_torch.runtime import step as step_mod
    from aztotmd_tpu_torch.runtime.step import MultiStep
    r = _runner(name, tmp_path, torch.device("cuda", 0))
    st, ff, fns = r.state, r.ff, r.multi.fns
    eager = MultiStep(fns, False, r.multi.R, r.multi.Q)(clone_state(st), ff,
                                                         30)
    step_mod.nbr_counts.update(rebuild=0, refine=0)
    graph = MultiStep(fns, True, r.multi.R, r.multi.Q)
    got = graph(clone_state(st), ff, 30)
    torch.cuda.synchronize()
    if "rebuild" in fns:
        assert step_mod.nbr_counts["rebuild"] >= 1
    a, b = dict(state_leaves(got)), dict(state_leaves(eager))
    for k in b:
        if b[k].is_floating_point():
            assert float((a[k] - b[k]).abs().max()) <= 1e-6, k
        else:
            assert torch.equal(a[k], b[k]), k


# plan regime -> (argon gas atoms, density, load keywords)
PLANS = {
    "rdf_covers_outer": (2000, 1e-3, {}),
    "rdf_from_outer": (1000, 3e-4, {}),
    "rdf list on gather": (1000, 3e-4, {"pair_engine": "gather"}),
}


def _plan_runner(name, tmp_path):
    n_atoms, density, load_kw = PLANS[name]
    d = str(tmp_path / "deck")
    systems.write_argon_gas_deck(d, n_atoms=n_atoms, density=density,
                                 steps=400)
    r = MDRunner(load_deck_dir(d, dtype="f32", **load_kw),
                 out_dir=str(tmp_path / "out"), quiet=True)
    plan = r._ring_plan
    if name in plan:
        assert plan[name]
    else:
        assert r.rcfg.k_cap > 0 and not plan["refine_blocks"]
    return r


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_programs_take_no_host_data_and_no_sync(name, tmp_path):
    """(a) on the plan's programs and its list sample."""
    r = _plan_runner(name, tmp_path)
    st, ff = r.state, r.ff
    order = [p for p in ("rebuild", "rdf_list", "refine", "step", "row",
                         "ring_reset") if p in r.multi.fns]
    assert "row" in order
    assert "rdf_list" in order or r._ring_plan["rdf_from_outer"]
    calls = [(p, lambda s, p=p: r.multi.fns[p](s, ff)) for p in order]
    calls.append(("RDF list sample",
                  lambda s: (s, r._rdf_plan.fn(s, r.hist, r.nhist))))
    for prog, fn in calls:
        out = fn(st)
        rec = _Recorder()
        with rec:
            out = fn(st)
        assert rec.ops > 0
        assert not rec.bad, (prog, sorted(set(rec.bad)))
        if prog != "RDF list sample":
            st = out


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_periods_in_place_equal_functional(name, tmp_path):
    """(c) two stat periods of the plan (a superblock's full rebuild
    first) run as the graphs run them, each program advancing one static
    state in place, against two functional periods: every field and the
    histograms bit for bit."""
    runs = []
    for in_place in (False, True):
        r = _plan_runner(name, tmp_path / str(in_place))
        if in_place:
            static, ff = clone_state(r.state), r.ff

            def run(prog, m=1, r=r):
                for _ in range(m):
                    advance_in_place(r.multi.fns[prog], static, ff)
            r.multi.start = lambda state, ff_: (run, lambda: static)
        for full in (True, False):
            r._ring_period(full)
        runs.append(r)
    a, b = runs
    assert a.rdf_count == b.rdf_count == 8
    assert torch.equal(a.hist, b.hist) and float(a.hist.sum()) > 0
    if a.nhist is not None:
        assert torch.equal(a.nhist, b.nhist)
    got, ref = dict(state_leaves(b.state)), dict(state_leaves(a.state))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
