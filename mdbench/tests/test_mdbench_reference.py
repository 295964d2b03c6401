"""The reference agrees with the port on the CPU at tiny sizes, float64:
one step of the port's step (pair forces and energies, velocity Verlet,
the radiative thermostat and the thermal radii, or Nose-Hoover's two
passes) on LJ and on Surkov decks and on a Nose-Hoover liquid from a
lattice start, the start (velocities and, under the radiative
thermostat, the photon table from the seed), and the RDF histogram of
one sample."""

import os

import pytest
import torch

from mdbench import decks, registry
from mdbench.reference.md import Reference, deck_params, initial

from .mdbench_tiny import LIQUID, tiny_root


def _load(tmp_path, cell, seed):
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    root = tiny_root(str(tmp_path / "root"), liquid=cell == LIQUID)
    w = registry.workload(cell, root)
    deck = w["config"]["decks"][w["traffic"]["deck"]]
    p = deck_params(deck["control"], deck["field"])
    d = str(tmp_path / "deck")
    pos0, box = decks.make_deck(w["config"], w["traffic"], seed, d)
    sysd = load_deck_dir(d, dtype="f64", seed=seed, device="cpu")
    return p, pos0, box, sysd


@pytest.mark.parametrize("cell", ["cs2_surkov_4k", "cs1_argon_40k",
                                  "cs1_argon_1080k", LIQUID])
def test_step_and_start_match_the_port(tmp_path, cell):
    from aztotmd_tpu_torch.runtime.step import make_multi_step
    seed = 2 ** 31 + 17
    p, pos0, box, sysd = _load(tmp_path, cell, seed)
    st = sysd["state"]
    n = pos0.shape[0]
    v0, ph = initial(p, n, seed)
    nose = p["tstat"] == "nose"
    assert torch.allclose(st.vel, torch.as_tensor(v0), rtol=1e-12,
                          atol=1e-14)
    if nose:
        assert ph is None and sysd["aux"].photons is None
    else:
        assert torch.allclose(sysd["aux"].photons, torch.as_tensor(ph),
                              rtol=1e-14, atol=0)
    assert float((st.pos - torch.as_tensor(pos0)).abs().max()) < 1e-9
    multi = make_multi_step(sysd["cfg"], sysd["aux"], graph=False)
    # some steps in, so that forces, internal energies and radii (or the
    # Nose-Hoover friction and its integral) are set
    st = multi(st, sysd["ff"], 30)
    s = {"x": st.pos, "v": st.vel, "f": st.frc, "engs": st.engs,
         "radii": st.radii, "chit": st.chit, "consint": st.consint,
         "energies": {"kin": st.energies.kin}, "step": int(st.step)}
    ref = Reference(p, box, ph, seed, n=n)
    for _ in range(3):
        st = multi(st, sysd["ff"], 1)
        s = ref.step(s)
        e = st.energies
        assert float((st.pos - s["x"]).abs().max()) < 1e-9
        assert torch.allclose(st.vel, s["v"], rtol=1e-9, atol=1e-12)
        assert torch.allclose(st.frc, s["f"], rtol=1e-9, atol=1e-12)
        if nose:
            for k in ("chit", "consint"):
                a, b = float(getattr(st, k)), float(s[k])
                assert abs(a - b) <= 1e-9 * abs(b), (k, a, b)
        else:
            assert torch.allclose(st.engs, s["engs"], rtol=1e-9,
                                  atol=1e-14)
            assert torch.allclose(st.radii, s["radii"], rtol=1e-9,
                                  atol=1e-14)
        for k in ("kin", "vdw", "temp", "tot"):
            a, b = float(getattr(e, k)), float(s["energies"][k])
            assert abs(a - b) <= 1e-9 * max(abs(b), 1e-6), (k, a, b)
    if p["pot"] == "surk":
        assert float(s["radii"].std()) > 0     # the radii do vary
    if nose:
        # the thermostat does act
        assert float(s["chit"]) != 0 and float(s["consint"]) != 0


@pytest.mark.parametrize("cell", ["cs2_surkov_4k", "cs1_argon_40k",
                                  LIQUID])
def test_rdf_sample_matches_the_port(tmp_path, cell):
    from aztotmd_tpu_torch.ops import rdf as ops_rdf
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    seed = 11
    p, pos0, box, sysd = _load(tmp_path, cell, seed)
    r = MDRunner(sysd, out_dir=str(tmp_path / "out"), quiet=True)
    hist, nhist = ops_rdf.zero_hist(r.rcfg, dtype=torch.float64)
    hist, _ = r._rdf.fn(r.state, hist, nhist)
    n = pos0.shape[0]
    ref = Reference(p, box, initial(p, n, seed)[1], seed, n=n)
    h_ref = ref.rdf_hist(r.state.pos)
    assert hist.shape[0] == h_ref.shape[0]
    assert torch.equal(torch.round(hist[:, 0] / ref.rdf_w),
                       torch.round(h_ref / ref.rdf_w))
    assert float(h_ref.sum()) > 0
