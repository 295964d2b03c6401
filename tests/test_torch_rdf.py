"""All-pairs RDF sampling of the port against the JAX package: integer
counts per bin exactly equal in f64, the normalized table to rtol 1e-10;
on a deck of crafted pairs at r_rdf, on bin edges and at half the box,
exactly equal in f32 and f64 (the arithmetic that the CUDA kernel of
``csrc/rdf.cu`` repeats, held on the card by tests/test_torch_kernels.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from aztotmd_tpu.ops import rdf as j_rdf
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.ops import rdf
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.systems import (RDF_EDGE_SETUPS, rdf_edge_deck,
                                       write_surkov_cluster_deck)

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them (these
# systems are a few hundred atoms).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rdf"))
    write_surkov_cluster_deck(d, n_atoms=300, box=20.0, steps=100)
    return d


def _inputs(deck, nsp, seed):
    j = j_load_deck_dir(deck, dtype="f64")
    p = load_deck_dir(deck, dtype="f64")
    rng = np.random.default_rng(seed)
    n = p["cfg"].n_at
    pos = np.asarray(p["atoms"].pos) + rng.normal(0.0, 0.2, (n, 3))
    types = rng.integers(0, nsp, n).astype(np.int32)
    return j, p, pos, types


@pytest.mark.parametrize("nsp,nuclei", [(1, False), (3, True)])
def test_rdf_counts_exact_and_normalized(deck, nsp, nuclei):
    import dataclasses
    j, p, pos, types = _inputs(deck, nsp, seed=nsp)
    jcfg = dataclasses.replace(j["cfg"], n_spec=nsp, n_nucl=2)
    cfg = dataclasses.replace(p["cfg"], n_spec=nsp, n_nucl=2)
    jr = j_rdf.make_rdf_config(j["ctl"], jcfg, pos=pos)
    rc = rdf.make_rdf_config(p["ctl"], cfg, pos=pos)
    jr = dataclasses.replace(jr, nuclei=nuclei)
    rc = dataclasses.replace(rc, nuclei=nuclei)
    assert dataclasses.asdict(rc) == dataclasses.asdict(jr)

    spec_number = np.bincount(types, minlength=nsp).astype(np.int32)
    spec_nuclei = (np.arange(nsp) % 2).astype(np.int32)
    nucl_number = np.bincount(spec_nuclei[types], minlength=2) \
        .astype(np.int32)
    jh, jnh = j_rdf.zero_hist(jr, jnp.float64)
    jh, jnh = j_rdf.rdf_sample_allpairs(
        jcfg, jr, jnp.asarray(pos), jnp.asarray(types),
        jnp.asarray(spec_number), jnp.asarray(spec_nuclei),
        jnp.asarray(nucl_number), jh, jnh)
    h, nh = rdf.zero_hist(rc, torch.float64)
    tpos, ttypes = torch.as_tensor(pos), torch.as_tensor(types)
    counts = rdf.rdf_counts_allpairs(cfg, rc, tpos, ttypes)
    h, nh = rdf.rdf_sample(
        cfg, rc, tpos, ttypes, torch.as_tensor(spec_number),
        torch.as_tensor(spec_nuclei), torch.as_tensor(nucl_number), h, nh)

    # exact integer counts: the JAX histogram divided by its pair weights
    iu, ju = np.triu_indices(nsp)
    w = 2.0 * cfg.volume / (spec_number[iu] * spec_number[ju])
    np.testing.assert_array_equal(counts.numpy(),
                                  np.round(np.asarray(jh) / w[None, :]))
    assert counts.sum() > 1000
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_allclose(rdf.normalize_rdf(rc, h.numpy(), 7),
                               j_rdf.normalize_rdf(jr, np.asarray(jh), 7),
                               rtol=1e-10)
    if nuclei:
        np.testing.assert_allclose(nh.numpy(), np.asarray(jnh), rtol=1e-12)
        np.testing.assert_allclose(
            rdf.normalize_rdf(rc, nh.numpy(), 7, nuclei=True),
            j_rdf.normalize_rdf(jr, np.asarray(jnh), 7, nuclei=True),
            rtol=1e-10)


def test_hist_counts_drop_slot():
    flat = torch.tensor([[0, 3, 3], [5, 1, 5]])
    np.testing.assert_array_equal(rdf._hist_counts(flat, 5, torch.int64),
                                  [1, 1, 0, 2, 0])


@pytest.mark.parametrize("nsp", [1, 2])
def test_rdf_cell_candidate_counts_exact(tmp_path, nsp):
    """A clustered system with N above stencil * cap takes the
    cell-candidate branch in both packages; counts exactly equal in f64
    (same bins, same stable sort, so the same dropped atoms)."""
    import dataclasses
    from aztotmd_tpu_torch.systems import write_nanoclusters_deck
    d = str(tmp_path)
    write_nanoclusters_deck(d, n_clusters=4, per=256, box=60.0, min_sep=25.0,
                            steps=10)
    j, p, pos, types = _inputs(d, nsp, seed=nsp)
    pos = pos % 60.0
    jcfg = dataclasses.replace(j["cfg"], n_spec=nsp)
    cfg = dataclasses.replace(p["cfg"], n_spec=nsp)
    jr = j_rdf.make_rdf_config(j["ctl"], jcfg, pos=pos)
    rc = rdf.make_rdf_config(p["ctl"], cfg, pos=pos)
    assert dataclasses.asdict(rc) == dataclasses.asdict(jr)
    assert cfg.n_at > len(rc.grid.stencil) * rc.grid.cap

    spec_number = np.bincount(types, minlength=nsp).astype(np.int32)
    spec_nuclei = np.zeros(nsp, np.int32)
    nucl_number = np.array([cfg.n_at], np.int32)
    jh, _ = j_rdf.zero_hist(jr, jnp.float64)
    jh, _ = j_rdf.rdf_sample(jcfg, jr, jnp.asarray(pos), jnp.asarray(types),
                             jnp.asarray(spec_number),
                             jnp.asarray(spec_nuclei),
                             jnp.asarray(nucl_number), jh, None)
    tpos, ttypes = torch.as_tensor(pos), torch.as_tensor(types)
    counts = rdf.rdf_counts_cells(cfg, rc, tpos, ttypes)
    h, _ = rdf.zero_hist(rc, torch.float64)
    h, _ = rdf.rdf_sample(cfg, rc, tpos, ttypes,
                          torch.as_tensor(spec_number),
                          torch.as_tensor(spec_nuclei),
                          torch.as_tensor(nucl_number), h, None)
    iu, ju = np.triu_indices(nsp)
    w = 2.0 * cfg.volume / (spec_number[iu] * spec_number[ju])
    np.testing.assert_array_equal(counts.numpy(),
                                  np.round(np.asarray(jh) / w[None, :]))
    assert counts.sum() > 1000
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    # the candidate sweep finds every in-range pair the all-pairs one does
    # (no cell overflows at this size)
    np.testing.assert_array_equal(
        counts.numpy(), rdf.rdf_counts_allpairs(cfg, rc, tpos, ttypes).numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nsp", [2, 3])
@pytest.mark.parametrize("setup", sorted(RDF_EDGE_SETUPS))
def test_allpairs_counts_on_the_edges_match_jax(setup, nsp, dtype):
    """``systems.rdf_edge_deck``'s crafted pairs: the plain all-pairs
    counts equal the JAX package's ``rdf_sample_allpairs`` counts exactly.
    The deck sits on the edges: a one-ulp move of r2_max up, or of d_rdf
    either way, changes the counts (pairs at r2 == r2_max, r == k*d_rdf)."""
    cfg, kw, pos, types = rdf_edge_deck(setup, nsp, dtype)
    jr, rc = j_rdf.RdfConfig(**kw), rdf.RdfConfig(**kw)
    spec_number = np.bincount(types, minlength=nsp).astype(np.int32)
    jh, _ = j_rdf.zero_hist(jr, dtype)
    jh, _ = j_rdf.rdf_sample_allpairs(
        cfg, jr, jnp.asarray(pos), jnp.asarray(types),
        jnp.asarray(spec_number), None, None, jh)
    tpos, ttypes = torch.as_tensor(pos), torch.as_tensor(types)
    counts = rdf.rdf_counts_allpairs(cfg, rc, tpos, ttypes)
    assert counts.dtype == tpos.dtype
    iu, ju = np.triu_indices(nsp)
    w = 2.0 * cfg.volume / (spec_number[iu] * spec_number[ju])
    np.testing.assert_array_equal(
        counts.numpy(), np.round(np.asarray(jh, np.float64) / w[None, :]))
    assert counts[-1].sum() > 0 and (counts.sum(1) > 0).all()

    f = np.dtype(dtype).type
    moves = [dict(r2_max=float(np.nextafter(f(kw["r2_max"]), f(np.inf))))]
    moves += [dict(d_rdf=float(np.nextafter(f(kw["d_rdf"]), f(to))))
              for to in (0.0, np.inf)]
    for m in moves:
        moved = rdf.rdf_counts_allpairs(cfg, dataclasses.replace(rc, **m),
                                        tpos, ttypes)
        assert not torch.equal(moved, counts), m
