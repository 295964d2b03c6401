"""The RDF list sampler of the port (``aztotmd_tpu_torch/ops/rdf.py``:
``rdf_list_cfg``, ``rdf_sample_list``) against the JAX package's, in f32
and f64, on 4,096 argon atoms at 1.4e-3 atoms/A^3 drawn from a numpy seed
(two species, the nuclei histogram on) and on an unjittered cubic
lattice, whose equal distances make the list's nearest-first order a
matter of tie order.  Histograms (integer counts times the same weights)
bitwise equal, and equal to the cell-candidate sampler's, since the list
holds every pair in range."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import make_cell_grid as j_make_cell_grid
from aztotmd_tpu.ops import neighbors as j_nbr
from aztotmd_tpu.ops import rdf as j_rdf
from aztotmd_tpu.systems import build_lj_argon as j_build_lj_argon
from aztotmd_tpu_torch.core.config import make_cell_grid
from aztotmd_tpu_torch.ops import neighbors as nbr
from aztotmd_tpu_torch.ops import rdf
from aztotmd_tpu_torch.systems import build_lj_argon

torch.set_num_threads(1)

N_AT = 4096
DENSITY = 1.4e-3
R_RDF, D_RDF = 10.0, 0.05
SKIN = 2.0          # the RDF list's skin: its reach is R_RDF + SKIN
K_LIST = 64         # holds every pair within R_RDF + SKIN on both inputs


def _inputs(dtype, kind):
    """(JAX cfg, port cfg, JAX rcfg, port rcfg, numpy pos, types,
    spec_number, spec_nuclei, nucl_number)."""
    jcfg = j_build_lj_argon(n_atoms=N_AT, density=DENSITY, dtype=dtype,
                            seed=3)[0]
    cfg = build_lj_argon(n_atoms=N_AT, density=DENSITY, dtype=dtype,
                         seed=3)[0]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jcfg = dataclasses.replace(jcfg, n_spec=2, n_nucl=2)
    cfg = dataclasses.replace(cfg, n_spec=2, n_nucl=2)
    box = cfg.box[0]
    rng = np.random.default_rng(11 if kind == "gas" else 12)
    if kind == "gas":
        pos = rng.uniform(0.0, box, (N_AT, 3))
    else:
        n = round(N_AT ** (1.0 / 3.0))
        g = (np.arange(n) + 0.25) * (box / n)
        pos = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                       axis=-1).reshape(-1, 3)
    types = rng.integers(0, 2, N_AT).astype(np.int32)
    spec_number = np.bincount(types, minlength=2).astype(np.int32)
    spec_nuclei = np.array([1, 0], np.int32)
    nucl_number = np.bincount(spec_nuclei[types], minlength=2) \
        .astype(np.int32)
    kw = dict(n_bin=int(R_RDF / D_RDF), d_rdf=D_RDF, r2_max=R_RDF * R_RDF,
              n_spec=2, n_nucl=2, nuclei=True, k_cap=K_LIST, skin=SKIN)
    # the cell sampler's grid sized from the positions (as
    # make_rdf_config sizes it), so that no cell drops an atom
    jrc = j_rdf.RdfConfig(grid=j_make_cell_grid(cfg.box, R_RDF, N_AT,
                                                pos=pos), **kw)
    rc = rdf.RdfConfig(grid=make_cell_grid(cfg.box, R_RDF, N_AT, pos=pos),
                       **kw)
    assert dataclasses.asdict(rc) == dataclasses.asdict(jrc)
    return (jcfg, cfg, jrc, rc, pos.astype(np.float32 if dtype == "f32"
                                           else np.float64),
            types, spec_number, spec_nuclei, nucl_number)


@pytest.fixture(scope="module", params=[("f32", "gas"), ("f64", "gas"),
                                        ("f64", "lattice")],
                ids=lambda p: "-".join(p))
def case(request):
    dtype, kind = request.param
    (jcfg, cfg, jrc, rc, pos, types, sn, snuc, nn) = _inputs(dtype, kind)
    lj = j_rdf.rdf_list_cfg(jcfg, jrc)
    lp = rdf.rdf_list_cfg(cfg, rc)
    # the list every sampler here reads: the JAX package's, at the RDF
    # list's reach
    jl, nmax, _ = j_nbr.build_neighbors(lj, jnp.asarray(pos))
    assert 0 < int(nmax) <= K_LIST
    return dict(dtype=dtype, kind=kind, jcfg=jcfg, cfg=cfg, jrc=jrc, rc=rc,
                lj=lj, lp=lp, pos=pos, types=types, sn=sn, snuc=snuc, nn=nn,
                nbr=np.asarray(jl))


def _jargs(c):
    return (jnp.asarray(c["pos"]), jnp.asarray(c["types"]),
            jnp.asarray(c["sn"]), jnp.asarray(c["snuc"]),
            jnp.asarray(c["nn"]))


def _pargs(c):
    return (torch.as_tensor(c["pos"]), torch.as_tensor(c["types"]),
            torch.as_tensor(c["sn"]), torch.as_tensor(c["snuc"]),
            torch.as_tensor(c["nn"]))


def _zero(c):
    dt = jnp.float32 if c["dtype"] == "f32" else jnp.float64
    tdt = torch.float32 if c["dtype"] == "f32" else torch.float64
    return j_rdf.zero_hist(c["jrc"], dt), rdf.zero_hist(c["rc"], tdt)


def _equal(jh, ph):
    for a, b in zip(jh, ph):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_rdf_list_cfg_and_list_match_jax(case):
    """``rdf_list_cfg`` is JAX's view, and the list built on it equals
    JAX's in order (the sorted build, nearest first)."""
    c = case
    assert dataclasses.asdict(c["lp"]) == dataclasses.asdict(c["lj"])
    assert nbr.sorted_build_ok(c["lp"])
    idx, nmax, _ = nbr.build_neighbors(c["lp"], torch.as_tensor(c["pos"]))
    np.testing.assert_array_equal(idx.numpy(), c["nbr"])


def test_rdf_sample_list_matches_jax(case):
    """Counts exactly JAX's (the histograms bitwise equal), and equal to
    the cell-candidate sampler's: the list holds every pair in range."""
    c = case
    (jh0, jnh0), (h0, nh0) = _zero(c)
    jh = j_rdf.rdf_sample_list(c["jcfg"], c["jrc"], *_jargs(c),
                               jnp.asarray(c["nbr"]), jh0, jnh0)
    ph = rdf.rdf_sample_list(c["cfg"], c["rc"], *_pargs(c),
                             torch.as_tensor(c["nbr"].copy()), h0.clone(),
                             nh0.clone())
    _equal(jh, ph)
    assert float(ph[0].sum()) > 0 and float(ph[1].sum()) > 0
    cells = rdf.rdf_sample(c["cfg"], c["rc"], *_pargs(c), h0.clone(),
                           nh0.clone())
    for a, b in zip(ph, cells):
        assert torch.equal(a, b)
