"""Bonds: the port's ``ops/bonds.py`` against ``aztotmd_tpu/ops/bonds.py``
on numpy-seeded f64 states.

The deck has four species and three bond types whose length triggers
mutate (type 1 -> 2 when compressed, -> 3 when stretched) or break them,
and a linkage that forms bonds of two types, one reversed and one that
changes an atom's species.  Bonds are laid on random atom pairs at
lengths that straddle the triggers, with random species so that many
need repair.  Every integer array and the RNG words must be equal;
forces and energies rel 1e-12 (the same f64 operations; scatter sums may
add in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops import bonds as j_bonds
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import convert
from aztotmd_tpu_torch.ops import bonds
from aztotmd_tpu_torch.output.writers import write_atoms_xyz
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

FIELD = """spec 4
A\tA\t20.0\t0.0\t0.0
B\tB\t20.0\t0.0\t0.0
C\tC\t20.0\t0.0\t0.0
D\tD\t20.0\t0.0\t0.0
red-ox 0
vdw 1
A\tA\tlnjs\t5.0\t0.008\t2.4
bonds 3
1 A B harm 12.0 1.5 mut 1.2 2 mut 2.2 3
2 C B harm 10.0 1.3 con br 2.6 A B
3 A D mors 1.0 2.0 1.6 0.1 con br 3.0 C D
linkage 2
A B 1.8 1
D C 2.0 3
"""

CONTROL = """timestep 0.0005 ps
nstep 100
nequil 0
eqfreq 100
temperature 400.0\tnose\t0.2
init_vel\tgaus

permittivity 1.0
elec\tnone

rdf\t6.0 0.05\t100\t0\t-nucl
stat\t100
"""

N = 200
BOX = 24.0


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bond_deck"))
    rng = np.random.default_rng(21)
    pos = rng.uniform(0.0, BOX, (N, 3))
    names = list(rng.choice(["A", "B", "C", "D"], N))
    write_atoms_xyz(os.path.join(d, "atoms.xyz"), names, pos, (BOX,) * 3)
    for name, text in (("field.txt", FIELD), ("control.txt", CONTROL)):
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return d


def _bonded_state(deck, seed, n_bond=60):
    """(JAX state, port state, port cfg, JAX deck, port deck) with
    ``n_bond`` random bonds:
    the first 40 on disjoint atom pairs, the rest sharing atoms with them
    (claims), lengths in [1.0, 3.2] A, random types and start steps."""
    j = j_load_deck_dir(deck, dtype="f64", seed=seed)
    p = load_deck_dir(deck, dtype="f64", seed=seed)
    cfg = p["cfg"]
    assert cfg.use_bnd == 2 and cfg.use_linkage
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    at1 = np.concatenate([perm[:40], rng.choice(perm[:80], n_bond - 40)])
    at2 = np.concatenate([perm[40:80], perm[80:80 + n_bond - 40]])
    pos = np.asarray(p["state"].pos.numpy()).copy()
    u = rng.normal(size=(n_bond, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos[at2] = (pos[at1] + u * rng.uniform(1.0, 3.2, (n_bond, 1))) % BOX
    mxB = cfg.mx_bond
    arr = dict(
        pos=pos, frc=rng.normal(size=(N, 3)),
        vel=rng.normal(size=(N, 3)),
        types=rng.integers(0, 4, N).astype(np.int32),
        bond_at1=np.zeros(mxB, np.int32), bond_at2=np.zeros(mxB, np.int32),
        bond_type=np.zeros(mxB, np.int32), bond_start=np.zeros(mxB, np.int32),
        step=np.asarray(57, np.int32), n_bond=np.asarray(n_bond, np.int32),
        bt_count=rng.integers(0, 9, 4).astype(np.int32),
        bt_lt_sum=rng.uniform(0, 50, 4), bt_lt_count=np.full(4, 3, np.int32),
        bt_r_sum=rng.uniform(0, 9, 4), bt_r_count=np.full(4, 5, np.int32))
    arr["bond_at1"][:n_bond] = at1
    arr["bond_at2"][:n_bond] = at2
    arr["bond_type"][:n_bond] = rng.integers(1, 4, n_bond)
    arr["bond_type"][5] = 0                 # a dead slot inside the table
    arr["bond_start"][:n_bond] = rng.integers(0, 57, n_bond)
    js = j["state"].replace(**{k: jnp.asarray(v) for k, v in arr.items()})
    ps = p["state"].replace(**{k: torch.as_tensor(v)
                               for k, v in arr.items()})
    return js, ps, cfg, j, p


def _check_state(ps, js):
    got = convert.state_to_numpy(ps)
    for name, a in got.items():
        if name == "energies":
            continue
        b = np.asarray(getattr(js, name))
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("seed,hack", [(1, True), (2, False), (3, True)])
def test_apply_bonds_matches_jax(deck, seed, hack):
    import dataclasses
    js, ps, cfg, j, p = _bonded_state(deck, seed)
    jcfg = dataclasses.replace(j["cfg"], bond_equil_hack=hack)
    cfg = dataclasses.replace(cfg, bond_equil_hack=hack)
    js2, je = j_bonds.apply_bonds(jcfg, j["ff"], js)
    ps2, pe = bonds.apply_bonds(cfg, p["ff"], ps)
    assert float(pe) == pytest.approx(float(je), rel=1e-12)
    _check_state(ps2, js2)
    # the triggers fired: bonds died, mutated and were repaired
    assert int(ps2.n_bond) < 59
    assert int(ps2.bt_lt_count.sum()) > 12
    assert not torch.equal(ps2.types, ps.types)
    assert bool(ps2.touched.any())
    assert bool((ps2.parents >= 0).any())


def test_constant_bonds_match_jax(deck):
    import dataclasses
    js, ps, cfg, j, p = _bonded_state(deck, 4)
    jcfg = dataclasses.replace(j["cfg"], use_bnd=1)
    cfg = dataclasses.replace(cfg, use_bnd=1)
    js2, je = j_bonds.apply_bonds(jcfg, j["ff"], js)
    ps2, pe = bonds.apply_bonds(cfg, p["ff"], ps)
    assert float(pe) == pytest.approx(float(je), rel=1e-12)
    _check_state(ps2, js2)
    assert torch.equal(ps2.bond_type, ps.bond_type)


@pytest.mark.parametrize("seed", [5, 6])
def test_create_bonds_matches_jax(deck, seed):
    """Random candidates with conflicts and mutual proposals, after the
    table is compacted; slots run out in the second case."""
    js, ps, cfg, j, p = _bonded_state(deck, seed)
    js = j_bonds.refresh_derived(j["cfg"], j["ff"],
                                 j_bonds.compact_bonds(j["cfg"], js))
    ps = bonds.refresh_derived(cfg, p["ff"], bonds.compact_bonds(cfg, ps))
    _check_state(ps, js)
    rng = np.random.default_rng(seed)
    cand = np.where(rng.uniform(size=N) < 0.6, rng.integers(0, N, N),
                    N).astype(np.int32)
    cand[:20:2] = np.arange(1, 20, 2)       # mutual pairs (0,1), (2,3) ...
    cand[1:20:2] = np.arange(0, 20, 2)
    cand[cand == np.arange(N)] = N
    if seed == 6:
        n_live = int(ps.n_bond)
        cap = n_live + 3
        js = js.replace(**{k: getattr(js, k)[:cap] for k in
                           ("bond_at1", "bond_at2", "bond_type",
                            "bond_start")})
        ps = ps.replace(**{k: getattr(ps, k)[:cap] for k in
                           ("bond_at1", "bond_at2", "bond_type",
                            "bond_start")})
    r2 = rng.uniform(1.0, 4.0, N)
    js2 = j_bonds.create_bonds(j["cfg"], j["ff"], js, jnp.asarray(cand),
                               jnp.asarray(r2))
    ps2 = bonds.create_bonds(cfg, p["ff"], ps, torch.as_tensor(cand),
                             torch.as_tensor(r2))
    _check_state(ps2, js2)
    assert int(ps2.n_bond) > int(ps.n_bond)


def test_bond_means_and_fix_bonds_match_jax(deck):
    js, ps, cfg, j, p = _bonded_state(deck, 7)
    _check_state(bonds.bond_means(cfg, ps), j_bonds.bond_means(j["cfg"], js))
    _check_state(bonds.fix_bonds(cfg, p["ff"], ps),
                 j_bonds.fix_bonds(j["cfg"], j["ff"], js))


@pytest.mark.parametrize("fam", [1, 2, 3, 4, 5])
def test_bond_eval_every_family(fam):
    rng = np.random.default_rng(fam)
    p = np.abs(rng.normal(1.0, 0.3, (50, 5))) + 0.5
    r = rng.uniform(0.8, 3.0, 50)
    kind = np.where(rng.uniform(size=50) < 0.7, fam, 0).astype(np.int32)
    jf, je = j_bonds.bond_eval(jnp.asarray(kind), jnp.asarray(p),
                               jnp.asarray(r * r), jnp.asarray(r),
                               kinds=(fam,))
    pf, pe = bonds.bond_eval(torch.as_tensor(kind), torch.as_tensor(p),
                             torch.as_tensor(r * r), torch.as_tensor(r),
                             kinds=(fam,))
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-12)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-12)


def test_bond_energy_only_and_evol_type_match_jax(deck):
    j = j_load_deck_dir(deck, dtype="f64")
    p = load_deck_dir(deck, dtype="f64")
    rng = np.random.default_rng(3)
    bt = rng.integers(0, 4, 40).astype(np.int32)
    s1 = rng.integers(0, 4, 40).astype(np.int32)
    s2 = rng.integers(0, 4, 40).astype(np.int32)
    r = rng.uniform(1.0, 3.0, 40)
    je = j_bonds.bond_energy_only(j["ff"], j["cfg"], jnp.asarray(bt),
                                  jnp.asarray(r * r), jnp.asarray(r))
    pe = bonds.bond_energy_only(p["ff"], p["cfg"], torch.as_tensor(bt),
                                torch.as_tensor(r * r), torch.as_tensor(r))
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-12)
    jt = j_bonds._evol_bondtype(j["ff"], jnp.asarray(bt), jnp.asarray(s1),
                                jnp.asarray(s2))
    pt = bonds._evol_bondtype(p["ff"], torch.as_tensor(bt),
                              torch.as_tensor(s1), torch.as_tensor(s2))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_drop_scatters_and_parent_key_range(deck):
    """Index N drops a write (the JAX "drop" mode), and the parent key
    slot * (N + 1) + partner is refused where it would leave int32."""
    a = torch.arange(4, dtype=torch.int32)
    out = bonds._set_drop(a, torch.tensor([4, 1, 4]),
                          torch.tensor([7, 8, 9], dtype=torch.int32))
    assert out.tolist() == [0, 8, 2, 3]
    out = bonds._min_drop(a, torch.tensor([4, 3, 3]),
                          torch.tensor([-5, 1, 2], dtype=torch.int32))
    assert out.tolist() == [0, 1, 2, 1]
    import dataclasses
    p = load_deck_dir(deck, dtype="f64")
    cfg = dataclasses.replace(p["cfg"], n_at=2 ** 31 // p["cfg"].mx_bond)
    with pytest.raises(ValueError, match="int32"):
        bonds.refresh_derived(cfg, p["ff"], p["state"])
    # torch.round is half-to-even, like jnp.round (the min-image rounding)
    half = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5])
    assert torch.round(half).tolist() == np.round(half.numpy()).tolist()
