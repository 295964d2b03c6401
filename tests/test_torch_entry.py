"""The port's entry points and package API (aztotmd_tpu_torch/entry.py,
aztotmd_tpu_torch/__init__.py, runtime/runner.py::run_deck) and the
systems they build (systems.py::build_lj_argon, clustered_slab_system),
against the JAX package's (__graft_entry__.py, aztotmd_tpu/__init__.py,
aztotmd_tpu/systems.py), on the CPU."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import aztotmd_tpu
import aztotmd_tpu_torch
from aztotmd_tpu.systems import build_lj_argon as j_build_lj_argon
from aztotmd_tpu.systems import clustered_slab_system as j_clustered
from aztotmd_tpu_torch import convert
from aztotmd_tpu_torch.entry import dryrun_multichip, entry
from aztotmd_tpu_torch.parallel import run_domain_step_demo
from aztotmd_tpu_torch.runtime.runner import MDRunner, run_deck
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_step
from aztotmd_tpu_torch.systems import (build_lj_argon, clustered_slab_system,
                                       write_lj_deck)

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_system(p, j):
    """Every state field bit for bit (through convert.py) and the same
    cfg."""
    (cfg, ff, st, aux), (jcfg, jff, jst, jaux) = p, j
    assert cfg == convert.config_from(jcfg)
    got, want = convert.state_to_numpy(st), jst
    for k, a in got.items():
        if k == "energies":
            continue
        b = np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k, a in convert.forcefield_to_numpy(ff).items():
        assert np.array_equal(a, np.asarray(getattr(jff, k))), k


@pytest.mark.parametrize("kw", [dict(), dict(n_atoms=512, dtype="f64",
                                             seed=11, temp=60.0)])
def test_build_lj_argon_equals_jax(kw):
    """build_lj_argon gives JAX's system at the same arguments: positions,
    velocities and every other state field bit for bit, and the same cfg
    (at 4,096 atoms the "neighbor" engine on a 17^3 grid)."""
    p, j = build_lj_argon(**kw), j_build_lj_argon(**kw)
    _same_system(p, j)
    if not kw:
        assert p[0].pair_engine == "neighbor" and p[0].n_at == 4096
        assert p[0].grid.dims == (17, 17, 17)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_clustered_slab_system_equals_jax(n_dev):
    """clustered_slab_system: JAX's slab-prepared cfg on the dense pass
    ("pallas") and its state, bit for bit."""
    p = clustered_slab_system(n_dev)
    assert p[0].pair_engine == "pallas" and p[0].grid.dims[0] % n_dev == 0
    _same_system(p, j_clustered(n_dev))


def test_entry_steps_once_as_one_device_step_and_jax():
    """entry(device="cpu"): one finite step of 4,096 argon atoms, equal to
    the port's one-device step and within f32 tolerance of the JAX
    package's entry() (rel 1e-4)."""
    fn, (state, ff) = entry(device="cpu")
    assert state.pos.device.type == "cpu" and state.pos.shape == (4096, 3)
    out = fn(state, ff)
    assert bool(torch.isfinite(out.pos).all()) and int(out.step) == 1
    cfg, ff2, st2, aux = build_lj_argon(n_atoms=4096)
    ref = make_step(cfg, aux)(st2, ff2)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.frc, ref.frc)
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, jargs = graft.entry()
    jout = jfn(*jargs)
    assert float(out.energies.tot) == pytest.approx(
        float(jout.energies.tot), rel=1e-4)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=1e-4)


def test_dryrun_multichip_2_on_the_cpu():
    """dryrun_multichip(2, device="cpu") runs its phases (phase 5 needs
    three shards and runs on the card in chip_smoke.py)."""
    dryrun_multichip(2, device="cpu")


def test_run_writes_the_runners_stat_dat_and_jax_run(tmp_path):
    """aztotmd_tpu_torch.run(deck, out, device="cpu", n_steps=100) writes
    the stat.dat that MDRunner writes for the same 100 steps, byte for
    byte, and the JAX package's run's within rtol 1e-4 / atol 2e-5."""
    deck = str(tmp_path / "deck")
    os.makedirs(deck)
    write_lj_deck(deck, n_side=6, box=28.0, steps=100)
    r = aztotmd_tpu_torch.run(deck, out_dir=str(tmp_path / "api"),
                              device="cpu", n_steps=100, quiet=True)
    assert int(r.state.step) == 100 and r.state.pos.device.type == "cpu"
    m = MDRunner(load_deck_dir(deck, device="cpu"),
                 out_dir=str(tmp_path / "runner"), quiet=True)
    m.run(100)
    m.finalize()
    api = (tmp_path / "api" / "stat.dat").read_text()
    assert api.count("\n") == 3 and api == (tmp_path / "runner" /
                                            "stat.dat").read_text()
    aztotmd_tpu.run(deck, out_dir=str(tmp_path / "jax"), n_steps=100,
                    quiet=True)
    a, b = (np.loadtxt(tmp_path / k / "stat.dat", skiprows=2, ndmin=2)
            for k in ("api", "jax"))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)


def test_load_equals_jax_load_and_needs_a_device(monkeypatch):
    """load(deck, device="cpu") gives the JAX package's load: state bit
    for bit, the same cfg; with no CUDA device and no ``device`` it
    raises, as do run, run_deck, entry, dryrun_multichip and
    run_domain_step_demo."""
    deck = os.path.join(ROOT, "examples", "surkov_cluster")
    d, jd = aztotmd_tpu_torch.load(deck, device="cpu"), aztotmd_tpu.load(deck)
    _same_system(tuple(d[k] for k in ("cfg", "ff", "state", "aux")),
                 tuple(jd[k] for k in ("cfg", "ff", "state", "aux")))
    assert np.array_equal(d["aux"].photons.numpy(),
                          np.asarray(jd["aux"].photons))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: aztotmd_tpu_torch.load(deck),
                 lambda: aztotmd_tpu_torch.run(deck), lambda: run_deck(deck),
                 lambda: entry(), lambda: dryrun_multichip(2),
                 lambda: run_domain_step_demo(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
