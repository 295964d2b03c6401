"""The port's stat ring rows (``aztotmd_tpu_torch/runtime/statring.py``)
against the JAX package's (``aztotmd_tpu/runtime/statring.py``) on the
CPU.

- ``make_layout`` equals JAX's column for column.
- ``make_stat_row`` on the same states: each deck's loaded state with
  numpy-seeded positions (displaced from pos0 and wrapped across the box),
  momenta, energies, counters and every capacity monitor, converted to the
  port's tensors.  The int row is exact; each float column within one
  float32 ulp of JAX's (the rows are float32 casts of f64 values, equal
  unless a value sits on a rounding boundary: the differing columns are
  counted and printed with ``-s``); the MSD columns within rel 1e-6.
- The device ring (``RowRing``): rows land in the slots its counter
  names, the reset program restarts it, and ``HostRows`` returns a
  window's rows from alternating buffers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime import statring as j_statring
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.runtime import statring

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")


@pytest.mark.parametrize("n_spec,n_bt", [(1, 1), (2, 1), (3, 4), (6, 2)])
def test_layout_matches_jax(n_spec, n_bt):
    assert statring.make_layout(n_spec, n_bt) == j_statring.make_layout(
        n_spec, n_bt)
    assert statring.ENG_KEYS == j_statring.ENG_KEYS


def _argon_cut(d):
    systems.write_argon_gas_deck(d, n_atoms=3000, steps=200)
    return d


DECKS = {"surkov_cluster": "surkov_cluster",
         "reactive_polymer": "reactive_polymer",
         "ejump_redox": "ejump_redox",
         "argon_3000": _argon_cut}

_MONITORS = ("cell_overflow", "nbr_over", "nbr_viol", "nbrow_over",
             "nbr2_over", "rdf_over", "orow_over")


def _seeded_state(deck, tmp_path, dtype, seed):
    """(JAX cfg, JAX state, spec counts) of a deck with numpy-seeded
    values in every field the row reads."""
    import jax.numpy as jnp
    src = DECKS[deck]
    d = os.path.join(EX, src) if isinstance(src, str) else src(
        str(tmp_path / deck))
    sysd = j_load_deck_dir(d, dtype=dtype)
    cfg, st = sysd["cfg"], sysd["state"]
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == "f64" else np.float32
    N, nsp = cfg.n_at, cfg.n_spec
    box = np.asarray(cfg.box)
    pos0 = np.asarray(st.pos0, np.float64)
    # displacements up to ~0.6 box, some across the periodic boundary
    pos = (pos0 + rng.normal(0.0, 0.2, (N, 3)) * box) % box
    nbt = np.asarray(st.bt_count).shape[0]
    f = lambda *s: jnp.asarray(rng.normal(0.0, 1e3, s).astype(npdt))
    i = lambda lo, hi, *s: jnp.asarray(rng.integers(lo, hi, s).astype(
        np.int32))
    E = dataclasses.replace(st.energies, **{
        k: jnp.asarray(npdt(rng.normal(0.0, 1e4)))
        for k in j_statring.ENG_KEYS})
    st = st.replace(
        pos=jnp.asarray(pos.astype(npdt)), energies=E, pos_mom=f(3),
        neg_mom=f(3), pressure=jnp.asarray(npdt(rng.normal(0.0, 1e5))),
        bt_r_mean=f(nbt), bt_lt_mean=f(nbt), step=i(0, 10 ** 6),
        spec_number=i(0, N, nsp), cross_pos=i(-50, 50, nsp, 3),
        cross_neg=i(-50, 50, nsp, 3), n_bond=i(0, 500), n_jump=i(0, 500),
        jump_pos=i(0, 500), jump_neg=i(0, 500), bt_count=i(0, 99, nbt),
        **{k: i(1, 4000) for k in _MONITORS})
    counts = np.bincount(np.asarray(st.types), minlength=nsp)
    return cfg, st, counts


def _ulps(a, b):
    """Float32 ulps between same-signed values, elementwise."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("deck", list(DECKS))
def test_stat_row_matches_jax(deck, dtype, tmp_path):
    cfg, jst, counts = _seeded_state(deck, tmp_path, dtype, seed=11)
    jf, ji = j_statring.make_stat_row(cfg, counts)(jst)
    jf, ji = np.asarray(jf), np.asarray(ji)
    pst = convert.state_from_numpy(jst)
    pf, pi = statring.make_stat_row(convert.config_from(cfg), counts)(pst)
    assert pf.dtype == torch.float32 and pi.dtype == torch.int32
    pf, pi = pf.numpy(), pi.numpy()
    assert pf.shape == jf.shape and pi.shape == ji.shape
    fsl, nf, isl, ni = j_statring.make_layout(
        cfg.n_spec, max(cfg.n_bond_types, 1))
    assert (nf, ni) == (jf.size, ji.size)
    np.testing.assert_array_equal(pi, ji)
    assert np.all(pi[isl["over"]] > 0)
    msd = fsl["msd"]
    assert np.all(jf[msd] > 0)
    np.testing.assert_allclose(pf[msd], jf[msd], rtol=1e-6, atol=0)
    u = _ulps(pf, jf)
    u[msd] = 0
    assert np.all(np.sign(pf) == np.sign(jf))
    assert u.max() <= 1, (deck, dtype, np.flatnonzero(u > 1))
    print(f"{deck} {dtype}: {int((u > 0).sum())} of {nf} float columns "
          f"1 ulp apart; MSD rel "
          f"{float(np.max(np.abs(pf[msd] / jf[msd] - 1))):.2e}")


def test_row_ring_slots_reset_and_host_rows():
    """Rows go to the slot the device counter names, the counter wraps at
    the ring's capacity and restarts at ``reset``; ``HostRows`` hands out
    each window's rows from the other buffer than the last window's."""
    ring = statring.RowRing(2, 3, 4, "cpu")
    host = statring.HostRows(2, 3, 4, "cpu")
    box = {"k": 0}

    def stat_row(s):
        box["k"] += 1
        k = float(box["k"])
        return (torch.tensor([k, -k]), torch.tensor([box["k"], 0, 7],
                                                    dtype=torch.int32))
    row = ring.program(stat_row)
    s = object()
    assert ring.reset(s, None) is s
    for _ in range(3):
        assert row(s, None) is s
    a = host.fetch(*ring.rows(3))
    fa, ia = host.wait(a)
    np.testing.assert_array_equal(fa[:, 0], [1, 2, 3])
    np.testing.assert_array_equal(ia[:, 0], [1, 2, 3])
    ring.reset(s, None)
    for _ in range(2):
        row(s, None)
    b = host.fetch(*ring.rows(2))
    fb, ib = host.wait(b)
    np.testing.assert_array_equal(ib[:, 0], [4, 5])
    # window a's rows stay in the other buffer until its next fetch
    np.testing.assert_array_equal(host.wait(a)[1][:, 0], [1, 2, 3])
    assert host.fetches == 2
    for _ in range(5):
        row(s, None)
    assert int(ring.slot) == 7
    np.testing.assert_array_equal(ring.irows[:, 0].numpy(), [8, 9, 10, 7])
