"""Static simulation configuration (port of ``aztotmd_tpu/core/config.py``).

``SimConfig`` keeps the JAX package's field names and values, so the two
configurations can be compared field by field.  Everything here is host
code (Python and NumPy).  Besides the config itself this module carries
the NumPy host helpers that the engine auto-selection needs:
``make_block_grid`` (``aztotmd_tpu/ops/cellblock.py``) and
``morton_codes`` / ``estimate_sparse_pairs``
(``aztotmd_tpu/ops/pallas_sparse.py``).  Their cost models decide which
engine a deck gets, and that choice must agree with the JAX package on
every deck.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .. import units
from ..io.control import (ELEC_EWALD, ELEC_FENNEL, TSTAT_NOSE,
                          ControlSpec)
from ..io.field import FieldSpec


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _max_neigh_count(pos, box, reach: float, n_sample: int = 4096,
                     seed: int = 0) -> int:
    """Max per-atom neighbor count within ``reach`` (host side)."""
    return _neigh_stats(pos, box, reach, n_sample, seed)[0]


def _neigh_stats(pos, box, reach: float, n_sample: int = 4096,
                 seed: int = 0):
    """(max per-atom neighbor count, fraction of atoms with >=1 neighbor)
    within ``reach``, cell-binned over a sample of ``n_sample`` atoms."""
    p = np.asarray(pos, np.float64)
    n = len(p)
    if n == 0:
        return 0, 0.0
    bx = np.asarray([float(b) for b in box])
    dims = np.maximum((bx // max(reach, 1e-9)).astype(np.int64), 1)
    cell = np.floor(p / bx * dims).astype(np.int64) % dims
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = np.argsort(cid, kind="stable")
    scid = cid[order]
    idx = np.arange(n) if n <= n_sample else \
        np.random.default_rng(seed).choice(n, n_sample, replace=False)
    # per-axis offsets; small grids collapse aliased periodic images
    ax = [(-1, 0, 1) if d >= 3 else ((0, 1) if d == 2 else (0,))
          for d in dims]
    offs = np.array([(a, b, c) for a in ax[0] for b in ax[1]
                     for c in ax[2]], np.int64)
    # the sampled atoms' stencil cells and their runs in the sorted ids
    # (searched per cell: a table of every cell's start is 2e8 entries
    # for a 1e6-atom dilute box)
    sc = (cell[idx][:, None, :] + offs[None, :, :]) % dims
    keys = (sc[..., 0] * dims[1] + sc[..., 1]) * dims[2] + sc[..., 2]
    lo = np.searchsorted(scid, keys, side="left")
    hi = np.searchsorted(scid, keys, side="right")
    r2 = reach * reach
    mx = 0
    n_occ = 0
    for s, i in enumerate(idx):
        cand = np.concatenate([order[a:b] for a, b in zip(lo[s], hi[s])])
        d = p[cand] - p[i]
        d -= bx * np.round(d / bx)
        cnt = int(np.count_nonzero(np.sum(d * d, axis=1) <= r2)) - 1
        n_occ += cnt > 0
        if cnt > mx:
            mx = cnt
    return mx, n_occ / max(len(idx), 1)


@dataclass(frozen=True)
class CellGrid:
    """Cell-list geometry: ``dims`` cells of at most ``cap`` atoms, and the
    static ``stencil`` of cell offsets that can hold a partner in range."""
    dims: tuple                 # (ncx, ncy, ncz)
    cap: int                    # max atoms per cell
    stencil: tuple              # ((dx,dy,dz), ...) including (0,0,0)
    edge: tuple                 # cell edge lengths

    @property
    def n_cell(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def make_cell_grid(box, r_max: float, n_at: int,
                   target_occupancy: float = 4.0,
                   cap_safety: float = 4.0,
                   max_cells: int = 1 << 21,
                   pos=None) -> CellGrid:
    """Cell grid with edge ~ r_max, the total cell count capped at
    ``max_cells``; ``cap`` from the measured occupancy when ``pos`` is
    given."""
    if r_max <= 0.0:
        raise ValueError("r_max must be positive")
    dims = [max(1, int(length / r_max)) for length in box]
    n_cell = dims[0] * dims[1] * dims[2]
    if n_cell > max_cells:
        s = (max_cells / n_cell) ** (1.0 / 3.0)
        dims = [max(1, int(d * s)) for d in dims]
    dims = tuple(dims)
    n_cell = dims[0] * dims[1] * dims[2]
    edge = tuple(length / n for length, n in zip(box, dims))

    def reach(d, e):
        return max(0.0, (abs(d) - 1)) * e
    stencil = []
    sx = [int(math.ceil(r_max / e)) for e in edge]
    for dx in range(-sx[0], sx[0] + 1):
        for dy in range(-sx[1], sx[1] + 1):
            for dz in range(-sx[2], sx[2] + 1):
                d2 = (reach(dx, edge[0]) ** 2 + reach(dy, edge[1]) ** 2
                      + reach(dz, edge[2]) ** 2)
                if d2 <= r_max * r_max:
                    stencil.append((dx, dy, dz))
    # periodic wrap can alias offsets on tiny grids; deduplicate mod dims
    seen, dedup = set(), []
    for off in stencil:
        key = tuple(o % d for o, d in zip(off, dims))
        if key not in seen:
            seen.add(key)
            dedup.append(off)

    avg = n_at / n_cell
    cap = _round_up(max(4, int(math.ceil(avg * cap_safety))), 4)
    if pos is not None:
        p = np.asarray(pos, dtype=np.float64)
        c = np.floor(p / np.asarray(edge)).astype(np.int64) % np.asarray(dims)
        cid = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        occ = int(np.bincount(cid, minlength=n_cell).max())
        margin = max(2, occ // 4)
        cap = min(max(cap, _round_up(occ + margin, 4)),
                  _round_up(occ * 2, 4))
    cap = min(cap, _round_up(n_at, 4))
    return CellGrid(dims=dims, cap=cap, stencil=tuple(dedup), edge=edge)


def _block_grid_candidate(box, r_max, n_at, k, max_cells, min_occupancy,
                          pos):
    """One block-grid candidate with cell edge ~ r_max/k: (cost, CellGrid),
    or None when over budget (``aztotmd_tpu/ops/cellblock.py``)."""
    dims = [max(1, int(length * k / r_max)) for length in box]
    n_cell = dims[0] * dims[1] * dims[2]
    budget = min(max_cells, max(1, int(n_at * k ** 3 / min_occupancy)))
    if n_cell > budget:
        if k > 1:
            return None
        s = (budget / n_cell) ** (1.0 / 3.0)
        dims = [max(1, int(d * s)) for d in dims]
    dims = tuple(dims)
    n_cell = dims[0] * dims[1] * dims[2]
    edge = tuple(length / n for length, n in zip(box, dims))

    def reach(d, e):
        return max(0.0, (abs(d) - 1)) * e
    sx = [int(math.ceil(r_max / e)) for e in edge]
    # offsets that alias mod dims keep their smallest representative
    classes = {}
    for dx in range(-sx[0], sx[0] + 1):
        for dy in range(-sx[1], sx[1] + 1):
            for dz in range(-sx[2], sx[2] + 1):
                d2 = (reach(dx, edge[0]) ** 2 + reach(dy, edge[1]) ** 2
                      + reach(dz, edge[2]) ** 2)
                if d2 <= r_max * r_max:
                    off = (dx, dy, dz)
                    key = tuple(o % d for o, d in zip(off, dims))
                    cur = classes.get(key)
                    if cur is None or (sum(map(abs, off))
                                       < sum(map(abs, cur))):
                        classes[key] = off
    stencil = sorted(classes.values(), key=lambda o: sum(map(abs, o)))

    avg = n_at / n_cell
    cap = _round_up(max(2, int(math.ceil(avg * 3.0))), 2)
    if pos is not None:
        p = np.asarray(pos, dtype=np.float64)
        c = np.floor(p / np.asarray(edge)).astype(np.int64) % np.asarray(dims)
        cid = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        occ = int(np.bincount(cid, minlength=n_cell).max())
        cap = max(cap, _round_up(occ + max(2, occ // 4), 2))
    cap = min(cap, _round_up(n_at, 2))
    if len(stencil) > 32 and k > 1:
        return None
    cost = len(stencil) * cap * cap * n_cell
    return cost, CellGrid(dims=dims, cap=cap, stencil=tuple(stencil),
                          edge=edge)


def make_block_grid(box, r_max: float, n_at: int,
                    min_occupancy: float = 1.0,
                    max_cells: int = 1 << 20,
                    pos=None, hint_edge: float = 0.0) -> CellGrid:
    """Block grid of least modeled cost stencil * cap^2 * n_cell over cell
    edges ~ r_max/k, k = 1..4 (k = 1 only without ``pos``), plus the deck's
    ``cell_list`` edge when given."""
    if r_max <= 0.0:
        raise ValueError("r_max must be positive")
    ks = [1, 2, 3, 4] if pos is not None else [1]
    if hint_edge and hint_edge > 0:
        ks.append(r_max / hint_edge)
    best = None
    for k in ks:
        cand = _block_grid_candidate(box, r_max, n_at, k, max_cells,
                                     min_occupancy, pos)
        if cand is not None and (best is None or cand[0] < best[0]):
            best = cand
    return best[1]


def _part1by2(x):
    """Spread the low 10 bits of x to every third bit (Morton helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_dims(box, r_max):
    dims = []
    for b in box:
        want = max(1.0, 2.0 * float(b) / max(float(r_max), 1e-6))
        dims.append(int(min(1024, 1 << max(0, math.ceil(math.log2(want))))))
    return tuple(dims)


def morton_codes(box, r_max, pos) -> np.ndarray:
    """Morton (Z-order) code per atom from NumPy positions."""
    dims = _morton_dims(box, r_max)
    code = None
    for k in range(3):
        b = float(box[k])
        w = pos[:, k] - b * np.floor(pos[:, k] / b)
        c = np.clip((w * (dims[k] / b)).astype(np.int32), 0, dims[k] - 1)
        s = _part1by2(c.astype(np.int64)).astype(np.int64) << k
        code = s if code is None else code | s
    return np.asarray(code, np.int64)


def estimate_sparse_pairs(box, r_max, pos, tile: int) -> int:
    """Count of AABB-interacting ordered tile pairs of the Morton-sorted
    positions (the block-sparse engine's worklist length)."""
    pos = np.asarray(pos, np.float64)
    n = len(pos)
    code = morton_codes(box, r_max, pos)
    order = np.argsort(code, kind="stable")
    T = int(tile)
    n_pad = _round_up(n, T)
    n_t = n_pad // T
    r2m = float(r_max) * float(r_max)
    gap2 = np.zeros((n_t, n_t))
    for k in range(3):
        b = float(box[k])
        w = pos[order, k] - b * np.floor(pos[order, k] / b)
        w = np.concatenate([w, np.full(n_pad - n, np.nan)])
        wt = w.reshape(n_t, T)
        lo = np.nanmin(wt, axis=1)
        hi = np.nanmax(wt, axis=1)
        c, h = (lo + hi) * 0.5, (hi - lo) * 0.5
        d = c[:, None] - c[None, :]
        d -= b * np.round(d / b)
        g = np.maximum(np.abs(d) - h[:, None] - h[None, :], 0.0)
        gap2 += g * g
    return int(np.sum(gap2 <= r2m))


@dataclass(frozen=True)
class SimConfig:
    """Hashable static configuration (field names and meanings as in
    ``aztotmd_tpu.core.config.SimConfig``)."""
    n_at: int
    n_spec: int
    n_nucl: int
    box: tuple                  # (la, lb, lc)
    dt: float

    # feature flags
    tstat_type: int = 0
    elec_type: int = 0
    ejtype: int = 0
    ejump_freq: int = 0
    use_bnd: int = 0            # 0 none / 1 constant / 2 variable
    use_angl: int = 0
    use_linkage: int = 0
    vdw_families: tuple = ()    # sorted tuple of VDW_* ids present
    vdw_kind_table: tuple = ()  # (nsp, nsp) potential kinds
    bond_kinds: tuple = ()
    use_radii: bool = False     # any radius-dependent potential present
    n_bond_types: int = 0
    n_angle_types: int = 0
    bond_equil_hack: bool = True

    # cutoffs
    r_max: float = 0.0
    r2_max: float = 0.0
    r2_elec: float = 0.0
    d_ejump: float = 0.0

    # electrostatics constants
    alpha: float = 0.0
    eps: float = 1.0
    coul_scale: float = units.FCOUL_SCALE
    fennel_c1: float = 0.0
    fennel_c2: float = 0.0
    daipi2: float = 0.0
    r_real: float = 0.0
    kmax: tuple = (0, 0, 0)
    rkcut2: float = 0.0
    ewald_scale: float = 0.0
    eng_ewald_const: float = 0.0

    # thermostat constants
    temp: float = 0.0
    te_kin: float = 0.0
    deg_free: int = 0
    rqmass: float = 0.0
    qmass_tau2: float = 0.0
    tstat_step: int = 0
    n_equil: int = 0
    freq_equil: int = 0
    reset_vels: int = 0

    # external field and shiftX directive
    ext_field: tuple = (0.0, 0.0, 0.0)
    shift_x: float = 0.0
    shift_val: float = 0.0

    # cell grid and pair engine ("neighbor", "block", "pallas", "sparse",
    # "gather"; the port runs the dense all-pairs branch of "pallas")
    grid: CellGrid | None = None
    pair_engine: str = "neighbor"
    nb_grid: CellGrid | None = None
    nb_skin: float = 1.5
    nb_rebuild: int = 40
    n_neigh: int = 4
    n_neigh2: int = 0
    nb_skin2: float = 0.0
    nb_outer: int = 1
    nb_rowcap: int = 0
    nb_orowcap: int = 0
    sparse_tile: int = 256
    sparse_pair_cap: int = 0

    # capacities
    mx_bond: int = 0
    mx_angle: int = 0
    n_free_el: int = 0
    max_neigh: int = 50

    # pressure ring buffer length
    n_mom: int = 20

    # compute dtype: "f32" or "f64"
    dtype: str = "f32"

    @property
    def torch_dtype(self):
        import torch
        return torch.float64 if self.dtype == "f64" else torch.float32

    @property
    def volume(self) -> float:
        return self.box[0] * self.box[1] * self.box[2]


def build_sim_config(ctl: ControlSpec, fld: FieldSpec, box, n_at: int,
                     n_bonds_init: int = 0, dtype: str = "f32",
                     target_occupancy: float = 4.0,
                     max_cells: int = 1 << 21,
                     mx_bond: int | None = None,
                     mx_angle: int | None = None,
                     pair_engine: str = "auto",
                     pos=None) -> SimConfig:
    """Derive the static config from parsed decks, with the JAX package's
    engine auto-selection and cost models."""
    use_bnd = fld.use_bnd
    if ctl.ejump != 0 and use_bnd == 1:
        use_bnd = 2             # bonds may mutate during e-transfer

    r_max = 0.0
    if ctl.elec.type:
        r_max = ctl.elec.r_real
    else:
        if fld.pairpots:
            r_max = fld.maxRvdw
        if use_bnd == 2:
            r_max = max(r_max, fld.maxRbind)
        if ctl.ejump != 0:
            r_max = max(r_max, ctl.r_elec)
    if r_max <= 0.0:
        raise ValueError("no interactions: r_max is zero")

    # engine auto-selection: Verlet list for small per-atom neighbor
    # counts, a cell or dense engine otherwise
    if pair_engine == "auto":
        mx_cnt = 0
        if pos is not None:
            mx_cnt = _max_neigh_count(pos, box, r_max + 1.5,
                                      n_sample=2048)
        pair_engine = "neighbor" if mx_cnt <= 64 else "block"

    sparse_tile = 256
    sparse_pair_cap = 0
    if pair_engine in ("block", "pallas", "sparse"):
        grid = make_block_grid(box, r_max, n_at, max_cells=max_cells,
                               pos=pos,
                               hint_edge=ctl.cell_size
                               if ctl.use_clist else 0.0)
        block_cost = (len(grid.stencil) * grid.cap * grid.cap
                      * grid.dims[0] * grid.dims[1] * grid.dims[2])
        if pair_engine == "block":
            # the cheapest of the modeled slot-pair costs: cell blocks,
            # dense padded N^2, Morton block-sparse tiles (weighted 2x)
            n_pad = _round_up(n_at, 512)
            cost = block_cost
            if n_pad * n_pad < cost:
                pair_engine, cost = "pallas", n_pad * n_pad
            p0 = None
            if pos is not None and n_at > 4096:
                p0 = estimate_sparse_pairs(box, r_max, pos, sparse_tile)
                if 2 * p0 * sparse_tile * sparse_tile < cost:
                    pair_engine = "sparse"
        else:
            p0 = None
        if pair_engine == "sparse":
            n_t = _round_up(n_at, sparse_tile) // sparse_tile
            if p0 is None:
                if pos is not None:
                    p0 = estimate_sparse_pairs(box, r_max, pos,
                                               sparse_tile)
                else:
                    p0 = n_t * n_t
            sparse_pair_cap = min(_round_up(p0 + p0 // 2 + 4 * n_t, 64),
                                  n_t * n_t)
    else:
        grid = make_cell_grid(box, r_max, n_at,
                              target_occupancy=target_occupancy,
                              max_cells=max_cells, pos=pos)

    nb_skin = 1.5
    nb_grid = None
    n_neigh = 4
    nb_rebuild = 40
    nb_rowcap = 0
    nb_orowcap = 0
    nb_outer = 1
    nb_skin2 = 0.0
    n_neigh2 = 0
    if pair_engine == "neighbor":

        def count_k(reach):
            if pos is None:
                return 4
            return _max_neigh_count(pos, box, reach, n_sample=4096)

        # rebuild interval from the thermal speed at the target temperature
        if ctl.tstat.temp > 0 and fld.species:
            m_min = min(sp.mass for sp in fld.species if sp.mass > 0)
            v_th = math.sqrt(3.0 * units.KB * ctl.tstat.temp / m_min)
            nb_rebuild = int(nb_skin / (6.0 * v_th * ctl.t_step))
        nb_rebuild = max(10, min(nb_rebuild, 200))

        r_nb = r_max + nb_skin
        mx = count_k(r_nb)
        n_neigh = _round_up(max(4, mx + max(2, mx // 4)), 4)
        n_neigh = min(n_neigh, n_at)

        # two-level list: the deepest outer window whose capacity stays
        # small
        for q in (24, 16, 12, 8, 6, 4, 3, 2):
            skin2 = nb_skin * q
            mx2 = count_k(r_max + skin2)
            k2 = _round_up(max(8, mx2 + max(4, mx2 // 4)), 8)
            if k2 <= max(32, 6 * n_neigh) and k2 < n_at:
                nb_outer, nb_skin2, n_neigh2 = q, skin2, k2
                break
        grid_reach = r_nb if nb_outer == 1 else r_max + nb_skin2
        nb_grid = make_cell_grid(box, grid_reach, n_at,
                                 target_occupancy=target_occupancy,
                                 max_cells=max_cells, pos=pos)

        # row-compacted walk for decks where few rows have neighbors
        if pos is not None:
            _, frac_occ = _neigh_stats(pos, box, r_nb)
            if frac_occ <= 0.15:
                est = int(frac_occ * n_at)
                nb_rowcap = min(_round_up(2 * est + 256, 128), n_at)

        if nb_rowcap and nb_outer > 1 and pos is not None:
            _, frac2 = _neigh_stats(pos, box, r_max + nb_skin2)
            if frac2 <= 0.6:
                est2 = int(frac2 * n_at)
                nb_orowcap = max(
                    min(_round_up(2 * est2 + 256, 128), n_at),
                    nb_rowcap)

    # degrees of freedom and thermostat constants
    deg_free = 3 * n_at - n_bonds_init
    if ctl.tstat.type:
        deg_free -= 1
    te_kin = 0.5 * ctl.tstat.temp * units.KB * deg_free
    rqmass = qmass_tau2 = 0.0
    if ctl.tstat.type == TSTAT_NOSE:
        rqmass = 0.5 / te_kin / ctl.tstat.tau / ctl.tstat.tau
        qmass_tau2 = 2.0 * te_kin

    # electrostatics constants
    alpha = ctl.elec.alpha
    fennel_c1 = fennel_c2 = daipi2 = 0.0
    rkcut2 = ewald_scale = 0.0
    kmax = (0, 0, 0)
    if ctl.elec.type == ELEC_FENNEL:
        a_rc = alpha * ctl.elec.r_real
        daipi2 = 2.0 * alpha / units.SQRTPI
        fennel_c1 = math.erfc(a_rc) / ctl.elec.r_real
        fennel_c2 = (math.erfc(a_rc) / ctl.elec.r_real ** 2
                     + daipi2 * math.exp(-a_rc * a_rc) / ctl.elec.r_real)
    elif ctl.elec.type == ELEC_EWALD:
        daipi2 = 2.0 * alpha / units.SQRTPI
        kmax = (ctl.elec.kx, ctl.elec.ky, ctl.elec.kz)
        vol = box[0] * box[1] * box[2]
        ewald_scale = (2.0 * units.TWOPI / vol * units.FCOUL_SCALE
                       / ctl.elec.eps)
        rkcut = min(kmax[0] / box[0], kmax[1] / box[1], kmax[2] / box[2])
        rkcut *= units.TWOPI * 1.05
        rkcut2 = rkcut * rkcut

    n_free_el = 0
    if ctl.ejump != 0:
        n_free_el = sum(s.nFreeEl for s in fld.species) and n_at or 0

    families = tuple(sorted({p.type for p in fld.pairpots}))
    from .ffield import vdw_tables
    vkind, _, _ = vdw_tables(fld)
    vdw_kind_table = tuple(tuple(int(x) for x in row) for row in vkind)
    bond_kinds = tuple(sorted({b.type for b in fld.bonds[1:]}))

    if mx_bond is None:
        mx_bond = _round_up(max(16, 2 * n_bonds_init
                                + (4096 if use_bnd == 2 else 0)), 16) \
            if use_bnd else 0
    if mx_angle is None:
        mx_angle = _round_up(max(16, 4096), 16) if fld.use_angl else 0

    nbr = pair_engine == "neighbor"
    return SimConfig(
        n_at=n_at, n_spec=fld.nSpec, n_nucl=len(fld.nnames),
        box=tuple(map(float, box)), dt=ctl.t_step,
        tstat_type=ctl.tstat.type, elec_type=ctl.elec.type,
        ejtype=ctl.ejtype, ejump_freq=ctl.ejump,
        use_bnd=use_bnd, use_angl=fld.use_angl,
        use_linkage=fld.use_linkage,
        vdw_families=families, vdw_kind_table=vdw_kind_table,
        bond_kinds=bond_kinds,
        use_radii=any(p.use_radii for p in fld.pairpots),
        n_bond_types=len(fld.bonds), n_angle_types=len(fld.angles),
        r_max=r_max, r2_max=r_max * r_max,
        r2_elec=ctl.r2_elec, d_ejump=ctl.d_ejump,
        alpha=alpha, eps=ctl.elec.eps,
        fennel_c1=fennel_c1, fennel_c2=fennel_c2, daipi2=daipi2,
        r_real=ctl.elec.r_real, kmax=kmax, rkcut2=rkcut2,
        ewald_scale=ewald_scale,
        temp=ctl.tstat.temp, te_kin=te_kin, deg_free=deg_free,
        rqmass=rqmass, qmass_tau2=qmass_tau2, tstat_step=ctl.tstat.step,
        n_equil=ctl.n_equil, freq_equil=ctl.freq_equil,
        reset_vels=ctl.reset_vels,
        ext_field=(ctl.ux, ctl.uy, ctl.uz),
        shift_x=ctl.shift_x, shift_val=ctl.shift_val,
        grid=grid, pair_engine=pair_engine,
        sparse_tile=sparse_tile, sparse_pair_cap=sparse_pair_cap,
        nb_grid=nb_grid, nb_skin=nb_skin, n_neigh=n_neigh,
        nb_rebuild=nb_rebuild,
        n_neigh2=n_neigh2 if nbr else 0,
        nb_skin2=nb_skin2 if nbr else 0.0,
        nb_outer=nb_outer if nbr else 1,
        nb_rowcap=nb_rowcap if nbr else 0,
        nb_orowcap=nb_orowcap if nbr else 0,
        mx_bond=mx_bond, mx_angle=mx_angle,
        n_free_el=n_free_el, max_neigh=ctl.max_neigh,
        dtype=dtype,
    )


def device_pair_engine(cfg: SimConfig, device_type: str,
                       requested: str = "auto") -> str:
    """The engine a deck runs on a ``device_type`` device, from ``cfg``,
    whose ``pair_engine`` is ``build_sim_config``'s for the ``requested``
    engine.  An engine the user named stands.  For ``"auto"`` the cost
    model's choice (the JAX package's) stands but in one case: on a CUDA
    device a ``"block"`` choice goes to ``"pallas"`` where that engine's
    pass is the stacked one (``ops/allpairs.py::pallas_branch``
    "stacked", the kernel K3): f32, no bind/jump candidates, a grid of at
    least three cells a side with every stencil offset within +-1
    (``ops/cellblock.py::stacked_ok``), and a ``cap`` whose neighbor
    cells fit a K3 block (``stacked_plan``).  The block engine is torch
    ops, thousands of small launches a pass on the card; the CPU keeps
    the JAX package's choice.  Host code: it launches nothing."""
    if (requested != "auto" or cfg.pair_engine != "block"
            or device_type != "cuda" or cfg.dtype != "f32"):
        return cfg.pair_engine
    import torch

    from ..ops.allpairs import pallas_branch
    from ..ops.cellblock import stacked_plan
    want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
    want_jump = cfg.ejtype != 0
    if pallas_branch(cfg, torch.float32, want_bind, want_jump) != "stacked":
        return cfg.pair_engine
    try:
        stacked_plan(cfg.grid.cap, cfg.grid.dims, cfg.n_at, cfg.n_spec)
    except ValueError:
        return cfg.pair_engine
    return "pallas"
