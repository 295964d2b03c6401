"""Valence angles: the port's ``ops/angles.py`` against
``aztotmd_tpu/ops/angles.py`` on examples/bonded_fluid (64 B-A-A angles,
harmonic cosine) with numpy-seeded positions, forces, touched atoms and
bond tables, in f64.  Forces and energies rel 1e-12 (the same operations;
the scatter may add in another order); angle tables exactly equal."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops import angles as j_angles
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import convert
from aztotmd_tpu_torch.ops import angles
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(ROOT, "examples", "bonded_fluid")
_ANG = ("ang_central", "ang_lig1", "ang_lig2", "ang_type", "n_angle")


@pytest.fixture(scope="module")
def systems():
    """Both packages' system of the deck, with species B (the angles'
    centre) made to form angle type 1 so that the refresh appends."""
    j = j_load_deck_dir(DECK, dtype="f64")
    p = load_deck_dir(DECK, dtype="f64")
    assert [s.name for s in p["fld"].species] == ["A", "B"]
    t = np.array([0, 1], np.int32)
    j["ff"] = dataclasses.replace(j["ff"], spec_angle_type=jnp.asarray(t))
    p["ff"] = dataclasses.replace(p["ff"], spec_angle_type=torch.as_tensor(t))
    return j, p


def _states(systems, seed, **arrays):
    """The deck's state in both packages with jittered positions, random
    forces and the given arrays replaced."""
    j, p = systems
    rng = np.random.default_rng(seed)
    js = j["state"]
    N = p["cfg"].n_at
    upd = dict(pos=np.asarray(js.pos) + rng.uniform(-0.3, 0.3, (N, 3)),
               frc=rng.normal(0.0, 1.0, (N, 3)), **arrays)
    jst = js.replace(**{k: jnp.asarray(v) for k, v in upd.items()})
    pst = p["state"].replace(**{k: torch.as_tensor(np.array(v))
                                for k, v in upd.items()})
    return jst, pst


@pytest.mark.parametrize("seed", [1, 2])
def test_apply_angles_matches_jax(systems, seed):
    j, p = systems
    jst, pst = _states(systems, seed)
    assert int(pst.n_angle) == 64
    got, eng = angles.apply_angles(p["cfg"], p["ff"], pst)
    ref, jeng = j_angles.apply_angles(j["cfg"], j["ff"], jst)
    jf = np.asarray(ref.frc)
    np.testing.assert_allclose(got.frc.numpy(), jf, rtol=0,
                               atol=1e-12 * np.abs(jf).max())
    assert float(eng) == pytest.approx(float(jeng), rel=1e-12)
    assert float(eng) > 0.0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_refresh_angles_matches_jax(systems, seed):
    """Random touched atoms and a bond table with slots emptied, bonds
    added between random atoms and partners past MAX_BOND_NEI: the same
    survivors in the same order, the same appended angles, n_angle."""
    j, p = systems
    cfg = p["cfg"]
    N = cfg.n_at
    rng = np.random.default_rng(seed)
    js = j["state"]
    at1, at2 = np.asarray(js.bond_at1).copy(), np.asarray(js.bond_at2).copy()
    bt = np.asarray(js.bond_type).copy()
    nb = int(js.n_bond)
    bt[:nb][rng.uniform(size=nb) < 0.15] = 0
    extra = min(len(bt) - nb, 40)
    at1[nb:nb + extra] = rng.integers(0, N, extra)
    at2[nb:nb + extra] = rng.integers(0, N, extra)
    bt[nb:nb + extra] = 1
    # one atom with more partners than MAX_BOND_NEI keeps the first 8
    hub = int(rng.integers(0, N))
    k = min(10, len(bt) - nb - extra)
    at1[nb + extra:nb + extra + k] = hub
    at2[nb + extra:nb + extra + k] = rng.integers(0, N, k)
    bt[nb + extra:nb + extra + k] = 1
    counts = np.bincount(np.concatenate([at1[bt != 0], at2[bt != 0]]),
                         minlength=N).astype(np.int32)
    touched = rng.uniform(size=N) < 0.3
    touched[hub] = True
    arrays = dict(bond_at1=at1, bond_at2=at2, bond_type=bt, nbonds=counts,
                  touched=touched)
    jst, pst = _states(systems, seed, **arrays)
    got = convert.state_to_numpy(angles.refresh_angles(cfg, p["ff"], pst))
    ref = j_angles.refresh_angles(j["cfg"], j["ff"], jst)
    for name in _ANG:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref,
                                                                    name)),
                                      err_msg=name)
    nb_p = angles._bond_neighbors(cfg, pst).numpy()
    np.testing.assert_array_equal(nb_p, np.asarray(
        j_angles._bond_neighbors(j["cfg"], jst)))
    assert (nb_p[hub] < N).all()
    # survivors were dropped and new angles appended
    n_keep = int((~touched[np.asarray(js.ang_central)[:64]]).sum())
    assert int(got["n_angle"]) > n_keep


def test_refresh_angles_past_capacity_matches_jax(systems):
    """Every atom touched and an angle table of 40 slots for the deck's 64
    angles: the table fills to its capacity and drops the rest as JAX
    does."""
    j, p = systems
    N = p["cfg"].n_at
    js = j["state"]
    live = np.asarray(js.bond_type) != 0
    counts = np.bincount(np.concatenate([np.asarray(js.bond_at1)[live],
                                         np.asarray(js.bond_at2)[live]]),
                         minlength=N).astype(np.int32)
    arrays = {k: np.asarray(getattr(js, k))[:40] for k in _ANG[:4]}
    jst, pst = _states(systems, 6, touched=np.ones(N, bool), nbonds=counts,
                       **arrays)
    got = convert.state_to_numpy(angles.refresh_angles(p["cfg"], p["ff"],
                                                       pst))
    ref = j_angles.refresh_angles(j["cfg"], j["ff"], jst)
    assert int(got["n_angle"]) == 40 and int(got["ang_type"][-1]) == 1
    for name in _ANG:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref,
                                                                    name)),
                                      err_msg=name)
