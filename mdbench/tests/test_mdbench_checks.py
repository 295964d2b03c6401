"""The check's control and its faults, on the CPU at tiny sizes.

The control (the reference in bfloat16, the precision below the
configurations' float32, put in the run's place) fails the cells' limits
while the run itself passes them; and a whole run, with the look for a
card skipped and the timed path broken underneath, comes out not correct
for each fault a one-chip MD cell can have: a step that returns its state
unchanged; half of the atoms left out of the step, the kinetic energy
taken over the rest; an answer altered where it is produced (the step's
kinetic energy, a stat row's, an RDF sample's counts).  The exchange
between chips does not exist on one chip.  On the Verlet list the checked
step walks the inner list that the window's last refine left, so a refine
that keeps too few pairs is not correct either.  The test-only Nose-Hoover
liquid (``mdbench_tiny.LIQUID``) is held the same way.

On the card the harness fails a cell before its runner when the port's
pair pass there is a torch engine; on the CPU, where the tests run torch
engines on purpose, it never asks."""

import dataclasses
import json
import os
import time

import pytest

from mdbench import decks, harness, registry

from .mdbench_tiny import LIQUID, tiny_root


def _root(tmp_path, cell):
    return tiny_root(str(tmp_path / "root"), liquid=cell == LIQUID)


def _run(root, cell, seed=7, controls=False):
    return harness.run_cell(cell, seed, 0.1, False, "cpu",
                            time.perf_counter(), root=root,
                            controls=controls)


@pytest.mark.parametrize("cell", ["cs2_surkov_4k", "cs1_argon_40k",
                                  LIQUID])
def test_run_passes_and_control_fails(tmp_path, cell):
    root = _root(tmp_path, cell)
    res = _run(root, cell, seed=2 ** 31 + 5, controls=True)
    assert res["correct"], res["checks"]
    limits = registry.workload(cell, root)["limits"]
    failed = [k for k, v in res["control"].items() if v > limits[k]]
    assert failed, res["control"]
    # the control fails start, pos_A and rdf on every cell
    assert {"start", "pos_A", "rdf"} <= set(failed), res["control"]


def _unchanged(mp):
    from aztotmd_tpu_torch.runtime import step as step_mod
    mp.setattr(step_mod, "make_step",
               lambda cfg, aux=None, pair_fn=None, nbr_auto_rebuild=True:
               (lambda state, ff: state))


def _half(mp):
    import torch

    from aztotmd_tpu_torch.runtime import step as step_mod
    orig = step_mod.make_step

    def make_step(cfg, aux=None, pair_fn=None, nbr_auto_rebuild=True):
        real = orig(cfg, aux, pair_fn=pair_fn,
                    nbr_auto_rebuild=nbr_auto_rebuild)
        h = cfg.n_at // 2

        def step(state, ff):
            new = real(state, ff)
            keep = {k: torch.cat([getattr(new, k)[:h], getattr(state, k)[h:]])
                    for k in ("pos", "vel", "frc", "engs", "radii")}
            m = ff.spec_mass[new.types.long()][:h]
            kin = 2.0 * 0.5 * torch.sum(m * torch.sum(
                keep["vel"][:h] ** 2, -1))
            eng = dataclasses.replace(new.energies, kin=kin.to(kin.dtype))
            return new.replace(energies=eng, **keep)
        return step
    mp.setattr(step_mod, "make_step", make_step)


def _energy(mp):
    from aztotmd_tpu_torch.ops import integrate
    orig = integrate.verlet2

    def verlet2(cfg, ff, vel, frc, types):
        vel, kin = orig(cfg, ff, vel, frc, types)
        return vel, kin * 1.01
    mp.setattr(integrate, "verlet2", verlet2)


def _row(mp):
    from aztotmd_tpu_torch.runtime import statring
    orig = statring.make_stat_row

    def make_stat_row(cfg, counts):
        real = orig(cfg, counts)

        def stat_row(state):
            e = dataclasses.replace(state.energies,
                                    kin=state.energies.kin * 1.01)
            return real(state.replace(energies=e))
        return stat_row
    mp.setattr(statring, "make_stat_row", make_stat_row)


def _rdf(mp):
    from aztotmd_tpu_torch.ops import rdf as ops_rdf
    orig = ops_rdf._apply_weights

    def apply_weights(cfg, rcfg, counts, *a):
        # every pair of the sample counted twice
        return orig(cfg, rcfg, 2 * counts, *a)
    mp.setattr(ops_rdf, "_apply_weights", apply_weights)


@pytest.mark.parametrize("cell", ["cs2_surkov_4k", "cs1_argon_40k",
                                  LIQUID])
@pytest.mark.parametrize("fault", [_unchanged, _half, _energy, _row, _rdf],
                         ids=["unchanged", "half", "energy", "row", "rdf"])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = _root(tmp_path, cell)
    fault(monkeypatch)
    res = _run(root, cell)
    assert not res["correct"], res["checks"]


def _noskin(mp):
    from aztotmd_tpu_torch.runtime import step as step_mod
    orig = step_mod.refine_neighbors_state
    mp.setattr(step_mod, "refine_neighbors_state",
               lambda cfg, state: orig(dataclasses.replace(cfg, nb_skin=0.0),
                                       state))


@pytest.mark.parametrize("fault", [None, _noskin], ids=["sound", "noskin"])
def test_window_refine_is_checked(tmp_path, monkeypatch, fault):
    """A gas 75 times denser than case study 1's, so that pairs enter the
    cutoff between two refines: a refine with no skin (the inner list only
    the pairs within the cutoff at the refine) is not correct, the sound
    run is.  A step after a fresh rebuild would pass both."""
    root = tiny_root(str(tmp_path / "root"))
    path = os.path.join(root, "configs", "argon_gas_cs1.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["generator_params"]["density"] = 2e-3
    with open(path, "w") as f:
        json.dump(cfg, f)
    if fault is not None:
        fault(monkeypatch)
    res = _run(root, "cs1_argon_40k")
    assert res["correct"] == (fault is None), res["checks"]


def _cfg(tmp_path, cell, dtype="f32", n_atoms=None):
    """The port's configuration of ``cell``'s tiny deck, loaded on the
    CPU (``n_atoms``: the configuration at that size instead)."""
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    w = registry.workload(cell, _root(tmp_path, cell))
    if n_atoms:
        w["config"]["generator_params"]["n_atoms"] = n_atoms
    d = str(tmp_path / "deck")
    decks.make_deck(w["config"], w["traffic"], 7, d)
    sysd = load_deck_dir(d, dtype=dtype, seed=7, device="cpu")
    return sysd["cfg"], sysd["state"].pos.dtype


def test_guard_passes_the_kernel_and_list_cells(tmp_path):
    for cell, engine in (("cs2_surkov_4k", "pallas"),
                         ("cs1_argon_40k", "neighbor")):
        cfg, dt = _cfg(tmp_path / cell, cell)
        assert cfg.pair_engine == engine
        harness.torch_engine_guard(cfg, dt)


def test_guard_refuses_a_torch_engine(tmp_path):
    import torch
    # the Nose-Hoover liquid at examples/liquid_argon's 32,768 atoms:
    # "auto" takes the torch cell-block engine
    cfg, dt = _cfg(tmp_path, LIQUID, n_atoms=32768)
    assert cfg.pair_engine == "block" and dt == torch.float32
    with pytest.raises(RuntimeError, match='selects the "block" engine'):
        harness.torch_engine_guard(cfg, dt)
    # the kernels are f32 only
    cfg, dt = _cfg(tmp_path / "f64", "cs2_surkov_4k", dtype="f64")
    with pytest.raises(RuntimeError, match="f32 only"):
        harness.torch_engine_guard(cfg, dt)


def test_guard_fails_without_the_ports_reason(tmp_path, monkeypatch):
    from aztotmd_tpu_torch.runtime import step as step_mod
    cfg, dt = _cfg(tmp_path, "cs2_surkov_4k")
    monkeypatch.delattr(step_mod, "torch_engine_reason")
    with pytest.raises(RuntimeError, match="torch_engine_reason"):
        harness.torch_engine_guard(cfg, dt)


def test_cpu_run_never_asks_the_guard(tmp_path, monkeypatch):
    """A guard that raises whenever it is asked: a CPU run of the tiny
    liquid passes all the same."""
    def guard(cfg, dtype):
        raise AssertionError("the guard ran on the CPU")
    monkeypatch.setattr(harness, "torch_engine_guard", guard)
    res = _run(_root(tmp_path, LIQUID), LIQUID)
    assert res["correct"], res["checks"]
