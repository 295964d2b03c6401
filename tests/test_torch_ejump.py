"""Electron jumps: the port's ``ops/ejump.py`` against
``aztotmd_tpu/ops/ejump.py`` on numpy-seeded f64 states of the
ejump_redox example (Fe2+ donates to Fe3+), bond-free and with a bond
table, under the eq, min and Metropolis schemes.  Types, touched flags,
jump counters and the RNG words must be equal; dU rel 1e-12 (the same
f64 operations).  The Metropolis draws are ``ops/jrandom.py``'s
threefry, which must equal ``jax.random`` bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops import ejump as j_ejump
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.io.control import JUMP_EQ, JUMP_METR, JUMP_MIN
from aztotmd_tpu_torch.ops import ejump, jrandom
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EJUMP_DECK = os.path.join(ROOT, "examples", "ejump_redox")


@pytest.fixture(scope="module")
def bonded_deck(tmp_path_factory):
    """The ejump_redox atoms with an Fe3-O bond type added to its field."""
    d = str(tmp_path_factory.mktemp("ejump_bonds"))
    for name in ("atoms.xyz", "control.txt"):
        with open(os.path.join(EJUMP_DECK, name)) as f, \
                open(os.path.join(d, name), "w") as g:
            g.write(f.read())
    with open(os.path.join(d, "field.txt"), "w") as f:
        f.write(systems.EJUMP_FIELD + """bonds 1
1 Fe3 O harm 12.0 1.9 con br 3.0 Fe3 O
""")
    return d


def _states(deck, seed, bonds=False):
    j = j_load_deck_dir(deck, dtype="f64", seed=seed)
    p = load_deck_dir(deck, dtype="f64", seed=seed)
    n = p["cfg"].n_at
    rng = np.random.default_rng(seed)
    arr = dict(types=rng.integers(0, 3, n).astype(np.int32),
               rng=np.array([rng.integers(0, 2 ** 32),
                             rng.integers(0, 2 ** 32)], np.uint32),
               n_jump=np.asarray(4, np.int32))
    if bonds:
        mxB = p["cfg"].mx_bond
        nb = 80
        perm = rng.permutation(n)
        for k, v in (("bond_at1", perm[:nb]), ("bond_at2", perm[nb:2 * nb]),
                     ("bond_type", np.ones(nb))):
            a = np.zeros(mxB, np.int32)
            a[:nb] = v
            arr[k] = a
        arr["n_bond"] = np.asarray(nb, np.int32)
    js = j["state"].replace(**{k: jnp.asarray(v) for k, v in arr.items()})
    ps = p["state"].replace(**{k: convert._tensor(v, None)
                               for k, v in arr.items()})
    # random candidates (70% of rows), most of them invalid pairs
    cand = np.where(rng.uniform(size=n) < 0.7, rng.integers(0, n, n), n)
    return js, ps, j, p, cand.astype(np.int32)


def _check(ps, js):
    got = convert.state_to_numpy(ps)
    for name in ("types", "touched", "rng", "n_jump", "jump_pos",
                 "jump_neg", "spec_number"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)),
                                      err_msg=name)


_SCHEMES = [(JUMP_METR, 0.0, 0.0), (JUMP_EQ, 20.0, 0.0), (JUMP_MIN, 0.0, 0.0),
            (JUMP_METR, 0.0, 0.02)]


@pytest.mark.parametrize("bonds", [False, True])
@pytest.mark.parametrize("scheme,d_ej,ex", _SCHEMES)
def test_do_jumps_matches_jax(bonded_deck, bonds, scheme, d_ej, ex):
    deck = bonded_deck if bonds else EJUMP_DECK
    js, ps, j, p, cand = _states(deck, 3 + scheme, bonds)
    kw = dict(ejtype=scheme, d_ejump=d_ej, ext_field=(ex, 0.0, 0.0))
    jcfg = dataclasses.replace(j["cfg"], **kw)
    cfg = dataclasses.replace(p["cfg"], **kw)
    assert bool(cfg.use_bnd) == bonds
    js2 = j_ejump.do_jumps(jcfg, j["ff"], js, jnp.asarray(cand))
    ps2 = ejump.do_jumps(cfg, p["ff"], ps, torch.as_tensor(cand))
    _check(ps2, js2)
    assert int(ps2.n_jump) > 4


def test_do_jumps_active_gate(bonded_deck):
    js, ps, j, p, cand = _states(EJUMP_DECK, 9)
    for active in (False, True):
        js2 = j_ejump.do_jumps(j["cfg"], j["ff"], js, jnp.asarray(cand),
                               active=jnp.asarray(active))
        ps2 = ejump.do_jumps(p["cfg"], p["ff"], ps, torch.as_tensor(cand),
                             active=torch.tensor(active))
        _check(ps2, js2)
        assert (int(ps2.n_jump) > 4) == active


def test_mutation_energies_match_jax(bonded_deck):
    js, ps, j, p, _ = _states(bonded_deck, 5, bonds=True)
    for jf, pf in ((j_ejump._mutation_energies(j["cfg"], j["ff"], js),
                    ejump._mutation_energies(p["cfg"], p["ff"], ps)),
                   (j_ejump._env_mutation_energies(j["cfg"], j["ff"], js),
                    ejump._env_mutation_energies(p["cfg"], p["ff"], ps))):
        for a, b in zip(pf, jf):
            b = np.asarray(b)
            assert np.abs(b).max() > 0.0
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                       atol=1e-12 * np.abs(b).max())


def test_env_candidates_match_jax_and_all_pairs():
    """The cell-table candidate list equals JAX's, and the environment
    sweep over it equals the all-pairs sweep (every neighbour within
    r_max is a candidate)."""
    js, ps, j, p, _ = _states(EJUMP_DECK, 6)
    jc = np.asarray(j_ejump.env_candidates(j["cfg"], js.pos))
    pc = ejump.env_candidates(p["cfg"], ps.pos)
    np.testing.assert_array_equal(pc.numpy(), jc)
    full = ejump._env_mutation_energies(p["cfg"], p["ff"], ps)
    via = ejump._env_mutation_energies(p["cfg"], p["ff"], ps, nbr_idx=pc)
    for a, b in zip(via, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 40 + 7, 2 ** 64 - 1])
def test_threefry_split_and_uniform_equal_jax(seed):
    key = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)
    new, sub = jax.random.split(jnp.asarray(key))
    got = jrandom.split(torch.as_tensor(key.astype(np.int64)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(new))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(sub))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        for n in (1, 7, 352):
            u = jrandom.uniform(got[1], n, tdt)
            ref = np.asarray(jax.random.uniform(sub, (n,), jdt))
            assert u.dtype == tdt
            np.testing.assert_array_equal(u.numpy(), ref)
