"""Radial distribution functions (port of the all-pairs and cell-candidate
branches of ``aztotmd_tpu/ops/rdf.py``).

Each unordered in-range pair adds 2*V/(N_i*N_j) to bin floor(r/dRDF) of
its species pair; the histogram is integer counts (``torch.histc`` over unit bins)
scaled by a per-pair weight table.  The pair ids are built in the JAX
package's order (i < j by index, r^2 summed x, y, z), so the counts are
the same.  Small or dense systems take the all-pairs branch; larger ones
gather candidates from the RDF cell grid (``ops/cell_list.py``).  The
stat-period plan of the runner samples instead from a neighbor list: an
(N, k_cap) RDF list built with ``ops/neighbors.py`` at the RDF reach plus a
skin (``rdf_list_cfg``), or the two-level Verlet list's outer list
(``rdf_sample_list``).  Every sampler gives the same integer counts when
its list covers the pairs in range.

The all-pairs counts have a hand-written CUDA kernel, ``csrc/rdf.cu``,
built and loaded by ``ops/cuda_build.py``: ``rdf_counts_allpairs`` sends a
CUDA tensor to it and a CPU tensor to ``rdf_counts_allpairs_plain`` (the
torch ops it repeats, operation for operation, so the counts are the same
bit for bit), and raises on any other device.  The cell-candidate, list
and row samplers are torch ops on both devices.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import units

from . import cell_list as cl
from . import cuda_build
from .allpairs import f32
from .consts import const
from ..core.config import (CellGrid, _max_neigh_count, _round_up,
                           make_cell_grid)

# samples taken by each sampler, and the builds of the runner's RDF list
# ("list_build": ``rdf_list_cfg``'s list), since the counts were last set
# to 0; on the card replays add their captures' counts
# (``runtime/graph.py``)
rdf_counts = {"allpairs": 0, "cells": 0, "list": 0, "list_build": 0}

# launches of csrc/rdf.cu made by rdf_counts_allpairs; a plain int that
# tools checking the main path reset and read
launches = 0


def n_pairs(n: int) -> int:
    return n * (n + 1) // 2


def pair_index(n: int, t1, t2):
    """Upper-triangle pair index i*(n-1) + i*(1-i)/2 + j, i = min, j = max."""
    mn = torch.minimum(t1, t2)
    mx = torch.maximum(t1, t2)
    return mn * (n - 1) + torch.div(mn * (1 - mn), 2,
                                    rounding_mode="floor") + mx


@dataclass(frozen=True)
class RdfConfig:
    """Static RDF sampling configuration (field names as the JAX one)."""
    n_bin: int
    d_rdf: float
    r2_max: float
    n_spec: int
    n_nucl: int
    nuclei: bool
    grid: CellGrid
    k_cap: int = 0
    skin: float = 0.0

    @property
    def n_pair(self) -> int:
        return n_pairs(self.n_spec)

    @property
    def n_npair(self) -> int:
        return n_pairs(self.n_nucl)


def make_rdf_config(ctl, cfg, max_cells: int = 1 << 20,
                    pos=None, m_min: float = 0.0) -> RdfConfig | None:
    if ctl.fr_rdf <= 0 or ctl.r_rdf <= 0.0 or ctl.d_rdf <= 0.0:
        return None
    grid = make_cell_grid(cfg.box, ctl.r_rdf, cfg.n_at, max_cells=max_cells,
                          pos=pos)
    min_r = min(ctl.r_rdf, min(cfg.box))
    k_cap = 0
    skin = 0.0
    if pos is not None and ctl.stat > 0 and ctl.fr_rdf < ctl.stat:
        # the JAX package's RDF-list sizing (kept so the configs agree)
        if ctl.tstat.temp > 0 and m_min > 0:
            v_th = math.sqrt(3.0 * units.KB * ctl.tstat.temp / m_min)
            skin = 6.0 * v_th * ctl.t_step * ctl.stat
        else:
            skin = 2.0
        skin = min(max(skin, 1.0), 0.5 * min(cfg.box))
        mx = _max_neigh_count(pos, cfg.box, ctl.r_rdf + skin)
        k_cap = _round_up(mx + mx // 2 + 8, 8)
        M = len(grid.stencil) * grid.cap
        if k_cap >= M or cfg.n_at <= M or k_cap > cfg.n_at // 4:
            k_cap = 0
            skin = 0.0
    return RdfConfig(n_bin=int(min_r / ctl.d_rdf), d_rdf=ctl.d_rdf,
                     r2_max=ctl.r_rdf * ctl.r_rdf, n_spec=cfg.n_spec,
                     n_nucl=cfg.n_nucl, nuclei=ctl.nuclei_rdf, grid=grid,
                     k_cap=k_cap, skin=skin)


def zero_hist(rcfg: RdfConfig, dtype=torch.float32, device=None):
    h = torch.zeros((rcfg.n_bin, rcfg.n_pair), dtype=dtype, device=device)
    nh = torch.zeros((rcfg.n_bin, rcfg.n_npair), dtype=dtype,
                     device=device) if rcfg.nuclei else None
    return h, nh


def _hist_counts(flat, n_slot: int, dtype):
    """Counts of the ids in [0, n_slot); ids equal to n_slot are dropped.
    ``torch.histc`` over n_slot + 1 unit bins, in f64 so that every id
    lands in its own bin and every count is exact: the counts of
    ``torch.bincount``, which on the card reads the largest id back to
    the host first (a sync that a CUDA-graph capture refuses).  An
    integer scatter-add gives them too, but its atomics contend on the
    few bins: with it the CLI ran examples/surkov_cluster (a sample every
    10 steps) at half the rate (``PERF.md`` section 6)."""
    ids = flat.reshape(-1).to(torch.float64)
    c = torch.histc(ids, bins=n_slot + 1, min=0, max=n_slot + 1)
    return c[:n_slot].to(dtype)


def _bin_counts(rcfg: RdfConfig, r2, mask, ti, tj):
    """(n_bin, n_pair) integer counts of the pairs in ``mask``; ``ti`` and
    ``tj`` broadcast against ``r2`` (unused for one species)."""
    d_rdf = torch.full((), rcfg.d_rdf, dtype=r2.dtype, device=r2.device)
    r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
    ib = torch.clamp((r / d_rdf).to(torch.int32), max=rcfg.n_bin - 1)
    ip = 0 if rcfg.n_spec == 1 else pair_index(rcfg.n_spec, ti, tj)
    B = rcfg.n_bin * rcfg.n_pair
    flat = torch.where(mask, ib * rcfg.n_pair + ip, torch.full_like(ib, B))
    return _hist_counts(flat, B, r2.dtype).reshape(rcfg.n_bin, rcfg.n_pair)


def rdf_counts_allpairs(cfg, rcfg: RdfConfig, pos, types):
    """(n_bin, n_pair) integer counts of one all-pairs sample, in the
    dtype of ``pos``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if pos.device.type == "cpu":
        return rdf_counts_allpairs_plain(cfg, rcfg, pos, types)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    return _allpairs_cuda(cfg, rcfg, pos, types)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = cuda_build.load("rdf")
    if lib.aztotmd_rdf_allpairs_f32.argtypes is None:
        for name, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, "aztotmd_rdf_allpairs_" + name)
            fn.argtypes = [_P, _P] + [_I] * 4 + [real] * 5 + [_P, _P]
            fn.restype = ctypes.c_int
        lib.aztotmd_rdf_table_copies.argtypes = [_I]
        lib.aztotmd_rdf_table_copies.restype = ctypes.c_int
    return lib


def _allpairs_cuda(cfg, rcfg: RdfConfig, pos, types):
    """Launch csrc/rdf.cu into a zeroed int32 table (a memset node of the
    capturing graph) and return its counts in the dtype of ``pos``."""
    global launches
    N = cfg.n_at
    dev = pos.device
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the RDF kernel takes f32 or f64, got {pos.dtype}")
    if tuple(pos.shape) != (N, 3) or tuple(types.shape) != (N,):
        raise ValueError(f"pos {tuple(pos.shape)} and types "
                         f"{tuple(types.shape)} for {N} atoms")
    if N * (N - 1) // 2 >= 1 << 31:
        raise ValueError(f"{N} atoms: over 2^31 pairs overflow the kernel's "
                         "int32 counts")
    pos = pos.contiguous()
    types = types.to(torch.int32).contiguous()
    counts = torch.zeros(rcfg.n_bin * rcfg.n_pair, dtype=torch.int32,
                         device=dev)
    f64 = pos.dtype == torch.float64
    real = float if f64 else f32
    lib = _lib()
    fn = lib.aztotmd_rdf_allpairs_f64 if f64 else lib.aztotmd_rdf_allpairs_f32
    err = fn(pos.data_ptr(), types.data_ptr(), N, rcfg.n_spec, rcfg.n_bin,
             rcfg.n_pair, *(real(b) for b in cfg.box), real(rcfg.r2_max),
             real(rcfg.d_rdf), counts.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"RDF kernel launch failed: CUDA error {err}")
    launches += 1
    return counts.to(pos.dtype).reshape(rcfg.n_bin, rcfg.n_pair)


def rdf_counts_allpairs_plain(cfg, rcfg: RdfConfig, pos, types):
    """What the kernel computes, in torch ops (f32 or f64): the N x N
    min-image r2, summed x, y, z, and the histogram of the bin ids of the
    pairs i < j in range."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    # true division by a box tensor, as jnp does (a CUDA tensor divided by
    # a Python scalar is multiplied by its reciprocal instead)
    box = const(cfg.box, dt, dev)
    r2 = torch.zeros((N, N), dtype=dt, device=dev)
    for k in range(3):
        d = pos[:, k, None] - pos[None, :, k]
        d = d - box[k] * torch.round(d / box[k])
        r2 = r2 + d * d
    own = torch.arange(N, device=dev)
    mask = (own[:, None] < own[None, :]) & (r2 < rcfg.r2_max)
    t = types.to(torch.int32)
    return _bin_counts(rcfg, r2, mask, t[:, None], t[None, :])


def rdf_counts_cells(cfg, rcfg: RdfConfig, pos, types):
    """(n_bin, n_pair) integer counts of one sample over the candidates of
    the RDF cell grid: each atom against the slots of its stencil cells,
    each unordered pair once (candidate id above the atom's)."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    gcfg = dataclasses.replace(cfg, grid=rcfg.grid)
    coords = cl.cell_coords(gcfg, pos)
    table, _ = cl.build_cell_table(gcfg, pos)
    cand = cl.gather_candidates(gcfg, table, coords).long()     # (N, M)
    box = const(cfg.box, dt, dev)
    pos_p = torch.cat([pos, torch.zeros((1, 3), dtype=dt, device=dev)])
    d = pos[:, None, :] - pos_p[cand]
    d = d - box * torch.round(d / box)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    own = torch.arange(N, device=dev)[:, None]
    mask = (cand != N) & (cand > own) & (r2 < rcfg.r2_max)
    t = types.to(torch.int32)
    tp = torch.cat([t, torch.zeros((1,), dtype=torch.int32, device=dev)])
    return _bin_counts(rcfg, r2, mask, t[:, None], tp[cand])


def rdf_counts_rows(cfg, rcfg: RdfConfig, row_pos, row_gid, row_types,
                    pos_g, types_g):
    """Partial all-pairs counts of a set of rows (a slab's slots) against
    the global position table, each pair counted on the row that owns the
    smaller global id (empty rows carry gid -1).  Summed over disjoint row
    sets they are ``rdf_counts_allpairs``'s counts exactly: a row's
    position is its entry of the table, bit for bit."""
    dt = pos_g.dtype
    dev = pos_g.device
    N = pos_g.shape[0]
    box = const(cfg.box, dt, dev)
    r2 = torch.zeros((row_pos.shape[0], N), dtype=dt, device=dev)
    for k in range(3):
        d = row_pos[:, k, None] - pos_g[None, :, k]
        d = d - box[k] * torch.round(d / box[k])
        r2 = r2 + d * d
    j = torch.arange(N, device=dev)[None, :]
    g = row_gid.to(torch.int64)[:, None]
    mask = (g >= 0) & (g < j) & (r2 < rcfg.r2_max)
    return _bin_counts(rcfg, r2, mask, row_types.to(torch.int32)[:, None],
                       types_g.to(torch.int32)[None, :])


def rdf_counts_rows_cells(cfg, rcfg: RdfConfig, row_pos, row_gid, row_types,
                          pos_g, types_g):
    """``rdf_counts_rows`` over the candidates of the RDF cell grid (the
    global table binned on it), for large N: O(rows * stencil * cap)
    instead of O(rows * N), the same counts."""
    dt = pos_g.dtype
    dev = pos_g.device
    N = pos_g.shape[0]
    gcfg = dataclasses.replace(cfg, grid=rcfg.grid, n_at=N)
    table, _ = cl.build_cell_table(gcfg, pos_g)
    cand = cl.gather_candidates(gcfg, table, cl.cell_coords(gcfg, row_pos)
                                ).long()                        # (R, M)
    box = const(cfg.box, dt, dev)
    pos_p = torch.cat([pos_g, torch.zeros((1, 3), dtype=dt, device=dev)])
    d = row_pos[:, None, :] - pos_p[cand]
    d = d - box * torch.round(d / box)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    g = row_gid.to(torch.int64)[:, None]
    mask = (cand != N) & (g >= 0) & (g < cand) & (r2 < rcfg.r2_max)
    tp = torch.cat([types_g.to(torch.int32),
                    torch.zeros((1,), dtype=torch.int32, device=dev)])
    return _bin_counts(rcfg, r2, mask, row_types.to(torch.int32)[:, None],
                       tp[cand])


def rdf_sample(cfg, rcfg: RdfConfig, pos, types, spec_number,
               spec_nuclei, nucl_number, hist, nhist=None):
    """One RDF sample; returns updated (hist, nhist).  Dense or small
    systems (N no larger than the RDF grid's candidate row) take the
    all-pairs branch, larger ones the cell-candidate branch, as in the
    JAX package."""
    if cfg.n_at <= len(rcfg.grid.stencil) * rcfg.grid.cap:
        rdf_counts["allpairs"] += 1
        counts = rdf_counts_allpairs(cfg, rcfg, pos, types)
    else:
        rdf_counts["cells"] += 1
        counts = rdf_counts_cells(cfg, rcfg, pos, types)
    return _apply_weights(cfg, rcfg, counts, spec_number, spec_nuclei,
                          nucl_number, hist, nhist)


def rdf_list_cfg(cfg, rcfg: RdfConfig, max_cells: int = 1 << 20):
    """A config view that points ``ops.neighbors.build_neighbors`` at the
    RDF reach: the list reach r_rdf + skin, capacity k_cap."""
    r_rdf = math.sqrt(rcfg.r2_max)
    grid = make_cell_grid(cfg.box, r_rdf + rcfg.skin, cfg.n_at,
                          max_cells=max_cells)
    return dataclasses.replace(cfg, nb_grid=grid, n_neigh=rcfg.k_cap,
                               nb_skin=rcfg.skin, r_max=r_rdf)


def rdf_counts_list(cfg, rcfg: RdfConfig, pos, types, nbr):
    """(n_bin, n_pair) integer counts of one sample over a neighbor list
    ``nbr`` (N, K) (sentinel N), each unordered pair once (the entry
    above the row's id); r^2 by minimum image, summed x, y, z as the JAX
    package's RDF does."""
    N = cfg.n_at
    dev = pos.device
    cand = nbr.long()
    pos_p = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype,
                                        device=dev)])
    types_p = torch.cat([types.to(torch.int32),
                         torch.zeros((1,), dtype=torch.int32, device=dev)])
    box = const(cfg.box, pos.dtype, dev)
    d = pos[:, None, :] - pos_p[cand]
    d = d - box * torch.round(d / box)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    own = torch.arange(N, device=dev)[:, None]
    mask = (cand != N) & (cand > own) & (r2 < rcfg.r2_max)
    return _bin_counts(rcfg, r2, mask, types_p[:N, None], types_p[cand])


def rdf_sample_list(cfg, rcfg: RdfConfig, pos, types, spec_number,
                    spec_nuclei, nucl_number, nbr, hist, nhist=None):
    """One RDF sample from a prebuilt (N, K) neighbor list: the RDF list
    of ``rdf_list_cfg`` or the outer Verlet list.  Its counts are
    ``rdf_sample``'s when the list holds every pair within r_rdf."""
    rdf_counts["list"] += 1
    counts = rdf_counts_list(cfg, rcfg, pos, types, nbr)
    return _apply_weights(cfg, rcfg, counts, spec_number, spec_nuclei,
                          nucl_number, hist, nhist)


def _apply_weights(cfg, rcfg: RdfConfig, counts, spec_number, spec_nuclei,
                   nucl_number, hist, nhist):
    """Scale per-(bin, species-pair) counts by 2V/(Ni*Nj) and fold them
    into the species (and nuclei) histograms."""
    dt = counts.dtype
    dev = counts.device
    iu, ju = (const(a.tolist(), torch.int64, dev)
              for a in np.triu_indices(rcfg.n_spec))
    # (2V) / (Ni*Nj) as a true division: a Python scalar over a tensor
    # would be computed as reciprocal-times-scalar, one rounding off
    vol2 = 2.0 * float(cfg.volume)
    num = spec_number.to(dt)
    den = num[iu] * num[ju]
    w_tab = torch.full_like(den, vol2) / den
    hist = hist + (counts * w_tab[None, :]).to(hist.dtype)
    if rcfg.nuclei and nhist is not None:
        ni = spec_nuclei[iu]
        nj = spec_nuclei[ju]
        inp = pair_index(rcfg.n_nucl, ni, nj)
        nnum = nucl_number.to(dt)
        nden = (nnum[torch.minimum(ni, nj).long()]
                * nnum[torch.maximum(ni, nj).long()])
        nw = torch.full_like(nden, vol2) / nden
        fold = (inp[:, None] == torch.arange(rcfg.n_npair, device=dev)[None, :]
                ).to(dt) * nw[:, None]
        nhist = nhist + (counts @ fold).to(nhist.dtype)
    return hist, nhist


SPHERA = 4.0 * np.pi / 3.0


def normalize_rdf(rcfg: RdfConfig, hist: np.ndarray, count: int,
                  nuclei: bool = False) -> np.ndarray:
    """Host normalization to g(r): the (n_bin, n_pair) table."""
    n = rcfg.n_nucl if nuclei else rcfg.n_spec
    c1 = 1.0 / (SPHERA * rcfg.d_rdf ** 3 * max(count, 1))
    i = np.arange(rcfg.n_bin)[:, None]
    c2 = 1.0 / (3.0 * i * (i + 1.0) + 1.0)
    c3 = np.empty(n_pairs(n))
    k = 0
    for a in range(n):
        for b in range(a, n):
            c3[k] = 1.0 if a == b else 0.5
            k += 1
    return np.asarray(hist, np.float64) * c1 * c2 * c3[None, :]
