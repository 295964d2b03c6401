"""Ewald reciprocal space: the port against the JAX package on the CPU.

``make_kvectors`` is host f64 code and must be equal exactly.
``ewald_recip`` is two matrix products and a column sum: f64 forces atol
1e-10 (eV/A, forces of order 1) and energy rel 1e-12; f32 rel 1e-4 of the
largest force (sums in another order).  ``ewald_self_energy`` rel 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops import elec as j_elec
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.ops import elec
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SALT = os.path.join(ROOT, "examples", "molten_salt")


@pytest.fixture(scope="module", params=["f32", "f64"])
def salt(request):
    dt = request.param
    return dt, j_load_deck_dir(SALT, dtype=dt), load_deck_dir(SALT, dtype=dt)


def test_kvectors_equal_and_loaded_into_aux(salt):
    dt, j, p = salt
    rk, w = elec.make_kvectors(p["cfg"])
    jrk, jw = j_elec.make_kvectors(j["cfg"])
    assert rk.shape == (1195, 3) and rk.dtype == np.float64
    np.testing.assert_array_equal(rk, jrk)
    np.testing.assert_array_equal(w, jw)
    tdt = torch.float64 if dt == "f64" else torch.float32
    assert p["aux"].rk.dtype == p["aux"].kweights.dtype == tdt
    np.testing.assert_array_equal(p["aux"].rk.numpy(),
                                  np.asarray(j["aux"].rk))
    np.testing.assert_array_equal(p["aux"].kweights.numpy(),
                                  np.asarray(j["aux"].kweights))


def test_self_energy_and_config_constant(salt):
    _, j, p = salt
    rng = np.random.default_rng(4)
    q = rng.normal(size=300)
    assert elec.ewald_self_energy(q, p["cfg"]) == pytest.approx(
        j_elec.ewald_self_energy(q, j["cfg"]), rel=1e-12)
    assert p["cfg"].eng_ewald_const != 0.0
    assert p["cfg"].eng_ewald_const == pytest.approx(
        j["cfg"].eng_ewald_const, rel=1e-12)


def test_ewald_recip_matches_jax(salt):
    """Numpy-seeded positions and charges (not neutral, so S(k) is far
    from cancelling) through both functions."""
    dt, j, p = salt
    npdt = np.float64 if dt == "f64" else np.float32
    n = 500
    rng = np.random.default_rng(9)
    pos = (rng.uniform(0.0, p["cfg"].box[0], (n, 3))).astype(npdt)
    q = rng.choice([-1.0, 1.0, 2.0], n).astype(npdt)
    jf, je = j_elec.ewald_recip(j["cfg"], jnp.asarray(pos), jnp.asarray(q),
                                j["aux"].rk, j["aux"].kweights)
    pf, pe = elec.ewald_recip(p["cfg"], torch.as_tensor(pos),
                              torch.as_tensor(q), p["aux"].rk,
                              p["aux"].kweights)
    jf = np.asarray(jf)
    assert pf.dtype == torch.as_tensor(pos).dtype
    scale = float(np.abs(jf).max())
    assert scale > 0.1 and abs(float(je)) > 1.0
    if dt == "f64":
        np.testing.assert_allclose(pf.numpy(), jf, rtol=0, atol=1e-10)
        assert float(pe) == pytest.approx(float(je), rel=1e-12)
    else:
        np.testing.assert_allclose(pf.numpy(), jf, rtol=0, atol=1e-4 * scale)
        assert float(pe) == pytest.approx(float(je), rel=1e-4)


def test_ewald_recip_on_the_deck_state(salt):
    """The deck's own ions: neutral, on lattice sites at the start."""
    dt, j, p = salt
    js, ps = j["state"], p["state"]
    jf, je = j_elec.ewald_recip(j["cfg"], js.pos,
                                j["ff"].spec_charge[js.types], j["aux"].rk,
                                j["aux"].kweights)
    pf, pe = elec.ewald_recip(p["cfg"], ps.pos,
                              p["ff"].spec_charge[ps.types.long()],
                              p["aux"].rk, p["aux"].kweights)
    rel = 1e-12 if dt == "f64" else 1e-4
    assert float(pe) == pytest.approx(float(je), rel=rel, abs=1e-6)
    scale = max(float(np.abs(np.asarray(jf)).max()), 1.0)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=0,
                               atol=(1e-10 if dt == "f64" else 1e-4) * scale)
