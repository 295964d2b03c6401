"""The Verlet-list engine's ops: the port's ``ops/neighbors.py`` (and
``cell_list.build_pos_table``) against ``aztotmd_tpu/ops/neighbors.py`` on
numpy-seeded positions.

Decks: a 3,000-atom cut of examples/argon_gas (the sorted build, the
row-compacted walk, the two-level list), the small argon deck of
``write_lj_deck`` (its 27 x 40-slot stencil, M = 1,080 > 1,024, takes the
two-gather build: its K = 12 list the top_k branch, its K2 = 72 outer
list the cumsum-and-scatter branch), a Surkov cluster forced to
"neighbor" (M > 1,024, radii) and the reactive examples forced to
"neighbor" (bind and jump candidates).  Integer outputs (lists, keys,
monitors) must be exactly equal; forces and energies rel 1e-4 in f32,
rel 1e-12 in f64 (the same operations; sums may add in another order).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops import cell_list as j_cl
from aztotmd_tpu.ops import neighbors as j_nbr
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.ops import cell_list as cl
from aztotmd_tpu_torch.ops import neighbors as nbr
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.systems import (write_argon_gas_deck, write_lj_deck,
                                       write_surkov_cluster_deck)

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    base = tmp_path_factory.mktemp("nbr_decks")
    gas, lj, sk = (str(base / n) for n in ("gas", "lj", "surkov"))
    write_argon_gas_deck(gas, n_atoms=3000, steps=200)
    os.makedirs(lj)
    write_lj_deck(lj)
    write_surkov_cluster_deck(sk, n_atoms=400, box=20.0, density=0.2,
                              steps=100, n_equil=0)
    return {"gas": gas, "lj": lj, "surkov": sk,
            "reactive_polymer": os.path.join(ROOT, "examples",
                                             "reactive_polymer"),
            "ejump_redox": os.path.join(ROOT, "examples", "ejump_redox")}


_CACHE = {}


def _load(decks, name, dtype="f64", **kw):
    """(JAX system, port system) of a deck; "surkov" and the reactive
    decks are forced to the neighbor engine.  Positions get a seeded
    jitter of 0.3 A so that lists are not those of the deck's file."""
    key = (name, dtype)
    if key not in _CACHE:
        if name not in ("gas", "lj"):
            kw["pair_engine"] = "neighbor"
        j = j_load_deck_dir(decks[name], dtype=dtype, **kw)
        p = load_deck_dir(decks[name], dtype=dtype, **kw)
        assert dataclasses.asdict(j["cfg"]) == dataclasses.asdict(p["cfg"])
        assert p["cfg"].pair_engine == "neighbor"
        rng = np.random.default_rng(len(name))
        box = np.asarray(p["cfg"].box)
        pos = (np.asarray(j["state"].pos, np.float64)
               + rng.uniform(-0.3, 0.3, (p["cfg"].n_at, 3))) % box
        npdt = np.float64 if dtype == "f64" else np.float32
        pos = pos.astype(npdt)
        _CACHE[key] = (j, p, pos)
    return _CACHE[key]


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def _outer(cfg):
    return dataclasses.replace(cfg, n_neigh=cfg.n_neigh2,
                               nb_skin=cfg.nb_skin2)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_pos_table_matches_jax(decks, dtype):
    j, p, pos = _load(decks, "gas", dtype)
    gcfg = dataclasses.replace(p["cfg"], grid=p["cfg"].nb_grid)
    tab, occ = cl.build_pos_table(gcfg, torch.as_tensor(pos))
    jtab, jocc = j_cl.build_pos_table(gcfg, jnp.asarray(pos))
    _eq(tab, jtab)
    assert int(occ) == int(jocc)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("outer", [False, True], ids=["inner", "outer"])
def test_sorted_build_matches_jax_in_order(decks, dtype, outer):
    """The sorted build on the 3,000-atom gas: lists in the same order,
    the f32 keys bitwise, n_real_max and max_occ equal; the prefix refine
    to the inner reach too."""
    j, p, pos = _load(decks, "gas", dtype)
    cfg = _outer(p["cfg"]) if outer else p["cfg"]
    assert nbr.sorted_build_ok(cfg) and j_nbr.sorted_build_ok(cfg)
    got = nbr.build_neighbors_keys(cfg, torch.as_tensor(pos))
    ref = j_nbr.build_neighbors_keys(cfg, jnp.asarray(pos))
    for a, b, name in zip(got, ref, ("idx", "skey", "nmax", "occ")):
        _eq(a, b, name)
    assert got[1].dtype == torch.float32
    assert int(got[2]) > 0 and (_np(got[0]) < cfg.n_at).sum() > 0
    if outer:
        c = p["cfg"]
        reach = c.r_max + c.nb_skin
        pr = nbr.prefix_refine(got[0], got[1], reach, c.n_neigh, c.n_at)
        jr = j_nbr.prefix_refine(ref[0], ref[1], reach, c.n_neigh, c.n_at)
        _eq(pr[0], jr[0], "prefix idx")
        assert int(pr[1]) == int(jr[1])
    # build_neighbors takes the same pipeline
    b = nbr.build_neighbors(cfg, torch.as_tensor(pos))
    _eq(b[0], ref[0])


def _rows_as_sets(idx, n):
    return [set(int(v) for v in row if v != n) for row in _np(idx)]


@pytest.mark.parametrize("name,outer,branch", [
    ("lj", False, "top_k"), ("lj", True, "scatter"),
    ("surkov", False, "scatter"), ("surkov", False, "top_k")])
def test_two_gather_build_matches_jax(decks, name, outer, branch):
    """The two-gather build (M > 1,024): per row the same neighbor sets,
    the same n_real_max and max_occ, on the top_k (K <= 32) and the
    scatter (K > 32) branches; the scatter branch keeps stencil order and
    the top_k branch nearest-first, so both lists are equal in order
    too."""
    j, p, pos = _load(decks, name)
    cfg = _outer(p["cfg"]) if outer else p["cfg"]
    if name == "surkov":
        # the cluster's K is in the hundreds; a K <= 32 list takes top_k
        cfg = dataclasses.replace(
            cfg, n_neigh=24 if branch == "top_k" else cfg.n_neigh)
        cfg = dataclasses.replace(
            cfg, nb_skin=1.5, nb_grid=dataclasses.replace(
                cfg.nb_grid, cap=max(cfg.nb_grid.cap, 1032 // len(
                    cfg.nb_grid.stencil) + 1)))
    M = len(cfg.nb_grid.stencil) * cfg.nb_grid.cap
    assert M > 1024 and not nbr.sorted_build_ok(cfg)
    assert (cfg.n_neigh <= 32) == (branch == "top_k")
    got = nbr.build_neighbors(cfg, torch.as_tensor(pos))
    ref = j_nbr.build_neighbors(cfg, jnp.asarray(pos))
    assert _rows_as_sets(got[0], cfg.n_at) == _rows_as_sets(ref[0], cfg.n_at)
    _eq(got[0], ref[0], "order")
    assert int(got[1]) == int(ref[1]) and int(got[2]) == int(ref[2])
    if branch == "top_k" and name == "surkov":
        assert int(got[1]) > cfg.n_neigh      # truncated rows monitored


@pytest.mark.parametrize("name", ["gas", "lj"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_refines_and_compaction_match_jax(decks, name, dtype):
    """refine_neighbors, refine_neighbors_rows and compact_rows from the
    outer list, after the atoms moved: exactly JAX's lists, rows and
    monitors.  With ``orow`` (the outer-occupied rows of
    ``compact_orows``) the port's row refine equals JAX's with the same
    ``orow``, and both equal the refine over all rows."""
    j, p, pos = _load(decks, name, dtype)
    cfg = p["cfg"]
    idx2 = j_nbr.build_outer_neighbors(cfg, jnp.asarray(pos))[0]
    rng = np.random.default_rng(21)
    moved = ((pos + rng.uniform(-0.4, 0.4, pos.shape).astype(pos.dtype))
             % np.asarray(cfg.box)).astype(pos.dtype)
    tp, t2 = torch.as_tensor(moved), torch.as_tensor(np.array(idx2))
    jp = jnp.asarray(moved)
    got = nbr.refine_neighbors(cfg, tp, t2)
    ref = j_nbr.refine_neighbors(cfg, jp, idx2)
    _eq(got[0], ref[0], "refine idx")
    assert int(got[1]) == int(ref[1])
    for r_cap in (cfg.nb_rowcap or 256, 64):
        rcfg = dataclasses.replace(cfg, nb_rowcap=r_cap)
        g = nbr.refine_neighbors_rows(rcfg, tp, t2, r_cap)
        r = j_nbr.refine_neighbors_rows(rcfg, jp, idx2, r_cap)
        orow, _ = j_nbr.compact_orows(idx2, cfg.n_at, cfg.n_at)
        ro = j_nbr.refine_neighbors_rows(rcfg, jp, idx2, r_cap, orow=orow)
        porow, _ = nbr.compact_orows(t2, cfg.n_at, cfg.n_at)
        _eq(porow, orow, "compact_orows")
        po = nbr.refine_neighbors_rows(rcfg, tp, t2, r_cap, orow=porow)
        for a, b, c_, d_, nm in zip(g, r, ro, po, ("idx", "nbrow", "nmax",
                                                   "n_rows")):
            _eq(a, b, nm)
            _eq(a, c_, nm + " (JAX's orow)")
            _eq(d_, c_, nm + " (the port's orow against JAX's)")
        cr = nbr.compact_rows(got[0], r_cap, cfg.n_at)
        jr = j_nbr.compact_rows(ref[0], r_cap, cfg.n_at)
        _eq(cr[0], jr[0], "compact")
        assert int(cr[1]) == int(jr[1])
    # the small row capacity really truncates on the gas
    if name == "gas":
        assert int(g[3]) > 64


def _pair_inputs(cfg, pos, kind):
    """JAX's list at ``pos``: compacted rows, or the (N, K) list."""
    if kind == "rows":
        idx = j_nbr.build_neighbors(cfg, jnp.asarray(pos))[0]
        r_cap = min(max(cfg.nb_rowcap, 512), cfg.n_at)
        lst = j_nbr.compact_rows(idx, r_cap, cfg.n_at)[0]
    else:
        lst = j_nbr.build_neighbors(cfg, jnp.asarray(pos))[0]
    return lst


@pytest.mark.parametrize("name,kind", [("gas", "rows"), ("gas", "dense"),
                                       ("lj", "dense"), ("surkov", "rows")])
@pytest.mark.parametrize("dtype,rel", [("f32", 1e-4), ("f64", 1e-12)])
def test_walks_match_jax(decks, name, kind, dtype, rel):
    """pair_forces_rows and pair_forces_neighbors over the same list:
    forces and energies rel 1e-4 (f32) and 1e-12 (f64) of the largest;
    the row walk equals the dense walk's per-atom result."""
    j, p, pos = _load(decks, name, dtype)
    cfg = p["cfg"]
    lst = _pair_inputs(cfg, pos, kind)
    st = p["state"]
    radii = st.radii if cfg.use_radii else None
    fn = nbr.pair_forces_rows if kind == "rows" else nbr.pair_forces_neighbors
    jfn = (j_nbr.pair_forces_rows if kind == "rows"
           else j_nbr.pair_forces_neighbors)
    got = fn(cfg, p["ff"], torch.as_tensor(pos), st.types,
             torch.as_tensor(np.array(lst)), radii=radii)
    ref = jfn(cfg, j["ff"], jnp.asarray(pos), j["state"].types, lst,
              radii=j["state"].radii if cfg.use_radii else None)
    f, jf = _np(got.frc), np.asarray(ref.frc)
    assert np.abs(jf).max() > 0
    np.testing.assert_allclose(f, jf, rtol=0, atol=rel * np.abs(jf).max())
    for k in ("eng_vdw", "eng_coul"):
        a, b = float(getattr(got, k)), float(getattr(ref, k))
        assert a == pytest.approx(b, rel=rel, abs=1e-30), k
    assert float(ref.eng_vdw) != 0.0


@pytest.mark.parametrize("name", ["reactive_polymer", "ejump_redox"])
@pytest.mark.parametrize("kind", ["rows", "dense"])
def test_walk_candidates_match_jax(decks, name, kind):
    """Bind (reactive_polymer) and jump (ejump_redox) candidates from the
    walk over the Verlet list, f64: ids exactly JAX's, r2 rel 1e-12."""
    j, p, pos = _load(decks, name)
    cfg = p["cfg"]
    want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
    want_jump = cfg.ejtype != 0
    assert want_bind or want_jump
    lst = _pair_inputs(cfg, pos, kind)
    fn = nbr.pair_forces_rows if kind == "rows" else nbr.pair_forces_neighbors
    jfn = (j_nbr.pair_forces_rows if kind == "rows"
           else j_nbr.pair_forces_neighbors)
    st, js = p["state"], j["state"]
    rng = np.random.default_rng(4)
    parents = np.where(rng.uniform(size=cfg.n_at) < 0.2,
                       rng.integers(0, cfg.n_at, cfg.n_at), -1) \
        .astype(np.int32)
    got = fn(cfg, p["ff"], torch.as_tensor(pos), st.types,
             torch.as_tensor(np.array(lst)),
             parents=torch.as_tensor(parents), want_bind=want_bind,
             want_jump=want_jump)
    ref = jfn(cfg, j["ff"], jnp.asarray(pos), js.types, lst,
              parents=jnp.asarray(parents), want_bind=want_bind,
              want_jump=want_jump)
    which = "bind" if want_bind else "jump"
    ids = _np(getattr(got, which + "_idx"))
    _eq(ids, getattr(ref, which + "_idx"), which)
    assert (ids < cfg.n_at).sum() > 0
    a, b = _np(getattr(got, which + "_r2")), np.asarray(
        getattr(ref, which + "_r2"))
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12)
