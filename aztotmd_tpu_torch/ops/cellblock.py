"""The cell-block pair engine and the stacked cell-block pass (port of
``aztotmd_tpu/ops/cellblock.py``: ``bin_atoms``, ``_roll3``,
``pair_forces_block`` with its bind/jump candidates; and of the stacked
branch of ``aztotmd_tpu/ops/pallas_pair.py::pair_forces_pallas`` with its
kernel ``_pair_kernel``).

``pair_forces_block`` is the ``"block"`` engine: atoms are binned into
cells of at most ``cap`` slots and every cell meets the cells of the
grid's stencil as (n_cell, cap, cap) tiles, through ``torch.roll`` of the
binned table.  The table is cell-major, ``slot = cid * cap + rank``, for
the engine and for the kernel alike; the reference's lane-friendly
transpose ``rank * n_cell + cid`` is a TPU layout and is not kept (same
ranks, same drop rule, same ``max_occ``).  It is plain tensor code in the reference (XLA) and here,
on the CPU and on the card, in f32 and f64, and it is where the
``"pallas"`` and ``"sparse"`` engines send f64.  ``make_block_grid`` lives
in ``core/config.py``.

``pair_forces_stacked`` is the stacked pass of the ``"pallas"`` engine
for grids with at least three cells a side and a stencil within +-1 cell
(the dispatcher in ``ops/allpairs.py`` guarantees both).  Kernel:
``csrc/cellblock.cu``, CUDA C++ for sm_90a, bound through a plain C
interface and ``ctypes``.  It replaces the TPU kernel
``aztotmd_tpu/ops/pallas_pair.py::_pair_kernel``.  The TPU kernel reads
14 stacked, rolled copies of the table (the Newton half stencil) and
emits j-side partial forces that are rolled back outside; on the H100 a
block takes a short run of cells along z (``stacked_plan``), stages the
filled slots of the 9 columns of cells their stencils cover straight
from the cell-major table in one parallel pass, walks the full stencil
(every energy weighted 0.5) and writes only its own cells' forces, so
there are no partial buffers and no atomics.  The work follows the
occupancy and not cap^2.  A neighbor across the periodic boundary is
shifted by one box length (no min-image rounding), the arithmetic is
``rsqrt`` and the rational erfc of ``csrc/pair_physics.cuh``.  The pass
is bound by the FP32 work over the visited pairs, not by memory; see
the note at the top of the source.

Routing: a CPU tensor goes to ``pair_forces_stacked_plain``; a CUDA
tensor launches the kernel or raises.  The kernel is f32 only.
"""

from __future__ import annotations

import ctypes

import torch

from ..io.control import ELEC_NONE
from . import cuda_build
from .consts import const
from .allpairs import (check_tensor, kernel_consts, kernel_tables,
                       pair_terms, plain_tables)
from .elec import coul_eval
from .pairs import MX_FRC, PairResult, jump_roles, no_candidates
from .vdw import vdw_eval

# launches of csrc/cellblock.cu made by pair_forces_stacked (K3); a plain
# int that tools checking the main path reset and read
launches = 0

# dynamic shared memory a block can ask for on sm_90: 232,448 bytes less
# K3's static arrays
_MAX_SMEM = 232448 - 7168
K3_ROWS = 64     # own atoms a K3 block aims at: two rows of each column warp
K3_NZ_MAX = 8    # cells a K3 block may take along z (NZ_MAX in the source)


def bin_atoms(cfg, pos, extra=()):
    """Bin atoms into the (n_cell * cap,) block table.

    The slot of an atom is ``cid * cap + rank`` (views are (n_cell, cap);
    the reference's table is the transpose, ``rank * n_cell + cid``);
    ``rank`` is the atom's place among the atoms of its cell in index
    order.  An atom whose rank is ``cap`` or more is dropped.

    Returns a dict of per-slot tensors x, y, z, valid (bool), aid (int32
    atom id, N on empty slots), one per item of ``extra`` ((name, (N,)
    tensor, fill)), and slot_of_atom ((N,) int32, ``n_cell * cap`` for a
    dropped atom) and max_occ (int32, the fullest cell's occupancy).
    """
    N = cfg.n_at
    grid = cfg.grid
    cap = grid.cap
    n_cell = grid.n_cell
    dt = pos.dtype
    dev = pos.device

    dims = const(grid.dims, torch.int32, dev)
    # the scale is divided on the host in f64 and then rounded, as JAX does
    scale = const([grid.dims[k] / cfg.box[k] for k in range(3)], dt, dev)
    c = torch.floor(pos * scale).to(torch.int32) % dims
    cid = (c[:, 0] * grid.dims[1] + c[:, 1]) * grid.dims[2] + c[:, 2]

    # jnp.argsort is stable: the rank decides which atoms a full cell drops
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, right=False)
    rank = torch.arange(N, dtype=torch.int32, device=dev) \
        - first.to(torch.int32)
    slot = sorted_cid * cap + rank
    slot = torch.where(rank < cap, slot, n_cell * cap)      # drop overflow
    slot_l = slot.long()
    max_occ = (torch.max(rank) + 1).to(torch.int32)

    def blk(vals, fill, dtype=None):
        # one slot more than the table takes the dropped atoms
        out = torch.full((n_cell * cap + 1,), fill,
                         dtype=dtype or vals.dtype, device=dev)
        out[slot_l] = vals[order]
        return out[:-1]

    out = dict(
        x=blk(pos[:, 0], 0.0),
        y=blk(pos[:, 1], 0.0),
        z=blk(pos[:, 2], 0.0),
        valid=blk(torch.ones(N, dtype=torch.bool, device=dev), False),
        aid=blk(torch.arange(N, dtype=torch.int32, device=dev), N),
        max_occ=max_occ,
    )
    soa = torch.empty(N, dtype=torch.int32, device=dev)
    soa[order] = slot
    out["slot_of_atom"] = soa
    for name, vals, fill in extra:
        out[name] = blk(vals, fill)
    return out


def _roll3(a, off, dims):
    """Roll the flat (n_cell * cap,) table by a cell offset: cell c of
    the result is cell c + off of ``a``, periodically."""
    ncx, ncy, ncz = dims
    a4 = a.reshape(ncx, ncy, ncz, -1)
    shifts = [(-o, k) for k, o in enumerate(off) if o]
    if shifts:
        a4 = torch.roll(a4, [s for s, _ in shifts], [d for _, d in shifts])
    return a4.reshape(a.shape)


def _unsort(a, soa, fill):
    """Per-atom values of a slot table; ``fill`` for dropped atoms."""
    flat = torch.cat([a.reshape(-1), torch.full((1,), fill, dtype=a.dtype,
                                                device=a.device)])
    return flat[soa.long()]


def pair_forces_block(cfg, ff, pos, types, radii=None, parents=None,
                      want_bind: bool = False,
                      want_jump: bool = False) -> PairResult:
    """The cell-block pair pass with min-image rounding, the exact sqrt
    and erfc, over the grid's whole stencil (any width, any grid size),
    with the bind and jump candidates.  ``max_occ`` is the fullest
    cell's occupancy; atoms past ``cap`` in a cell get no force."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    nsp = cfg.n_spec
    grid = cfg.grid
    cap = grid.cap
    n_cell = grid.n_cell
    dims = grid.dims

    extra = [("types", types, 0)]
    if cfg.use_radii and radii is not None:
        extra.append(("radii", radii, 1.0))
    if want_bind and parents is not None:
        extra.append(("parents", parents, -1))
    B = bin_atoms(cfg, pos, extra=extra)

    def v(a):
        return a.reshape(n_cell, cap)

    xi, yi, zi = v(B["x"]), v(B["y"]), v(B["z"])
    vi = v(B["valid"])
    ti = v(B["types"])
    aidi = v(B["aid"])
    radi = v(B["radii"]) if "radii" in B else None
    pari = v(B["parents"]) if "parents" in B else None

    box = const(cfg.box, dt, dev)
    zero = torch.zeros((n_cell, cap), dtype=dt, device=dev)
    fx, fy, fz = zero, zero, zero
    eng_vdw = torch.zeros((), dtype=dt, device=dev)
    eng_coul = torch.zeros((), dtype=dt, device=dev)

    big = float("inf")
    none_r2 = torch.full((n_cell, cap), big, dtype=dt, device=dev)
    none_id = torch.full((n_cell, cap), N, dtype=torch.int32, device=dev)
    bind_r2b, bind_idb = none_r2, none_id
    jump_r2b, jump_idb = none_r2, none_id
    jmpa_r2b, jmpa_idb = none_r2, none_id

    if want_jump:
        don_i, acc_i = jump_roles(ff, ti)
        don_i = don_i & vi
        # a pure-acceptor row keeps its nearest donor
        accrow_i = acc_i & vi & ~don_i

    def tile_min(can, r2, aidj, r2b, idb):
        """Merge the tile's nearest masked j (first slot on ties) into
        the running minimum with a strict <."""
        r2m = torch.where(can, r2, torch.full_like(r2, big))
        j = torch.argmin(r2m, dim=2, keepdim=True)
        best = torch.gather(r2m, 2, j)[:, :, 0]
        jid = torch.gather(aidj[:, None, :].expand_as(r2m), 2, j)[:, :, 0]
        better = best < r2b
        return torch.where(better, best, r2b), torch.where(better, jid, idb)

    for off in grid.stencil:
        # own-cell class: an offset that is 0 mod dims (tiny grids alias)
        same = all(o % d == 0 for o, d in zip(off, dims))
        r = (lambda a: v(a)) if same else (lambda a: v(_roll3(a, off, dims)))
        xj, yj, zj = r(B["x"]), r(B["y"]), r(B["z"])
        vj = r(B["valid"])
        tj = r(B["types"])
        aidj = r(B["aid"])

        # pair tiles are (n_cell, cap_i, cap_j)
        dx = xi[:, :, None] - xj[:, None, :]
        dy = yi[:, :, None] - yj[:, None, :]
        dz = zi[:, :, None] - zj[:, None, :]
        dx = dx - box[0] * torch.round(dx / box[0])
        dy = dy - box[1] * torch.round(dy / box[1])
        dz = dz - box[2] * torch.round(dz / box[2])
        r2 = dx * dx + dy * dy + dz * dz

        mask = vi[:, :, None] & vj[:, None, :] & (r2 <= cfg.r2_max)
        if same:
            eye = torch.eye(cap, dtype=torch.bool, device=dev)
            mask = mask & ~eye[None, :, :]

        r2s = torch.where(mask, r2, torch.ones_like(r2))
        rr = torch.sqrt(r2s)
        zeros = torch.zeros_like(r2s)

        tpair = (ti[:, :, None] * nsp + tj[:, None, :]).long()

        if cfg.elec_type != ELEC_NONE:
            chp = ff.chprod.reshape(-1)[tpair]
            fc, ec = coul_eval(cfg, r2s, rr, chp)
            fc = torch.where(mask, fc, zeros)
            ec = torch.where(mask, ec, zeros)
        else:
            fc = ec = zeros

        if cfg.vdw_families:
            if nsp == 1:
                kind = ff.vdw_kind[0, 0].expand(r2s.shape)
                vp = ff.vdw_p[0, 0].expand(r2s.shape + (5,))
                r2cut = ff.vdw_r2cut[0, 0]
            else:
                kind = ff.vdw_kind.reshape(-1)[tpair]
                vp = ff.vdw_p.reshape(-1, 5)[tpair]
                r2cut = ff.vdw_r2cut.reshape(-1)[tpair]
            vmask = mask & (r2 <= r2cut)
            if cfg.use_radii and radi is not None:
                ra = radi[:, :, None].expand_as(r2s)
                rb = r(B["radii"])[:, None, :].expand_as(r2s)
            else:
                ra = rb = None
            kind = torch.where(vmask, kind, torch.zeros_like(kind))
            fv, ev = vdw_eval(kind, vp, r2s, rr, ra, rb,
                              families=cfg.vdw_families)
            fv = torch.where(vmask, fv, zeros)
            ev = torch.where(vmask, ev, zeros)
        else:
            fv = ev = zeros

        f = torch.clamp(fc + fv, -MX_FRC, MX_FRC)
        fx = fx + torch.sum(f * dx, dim=2)
        fy = fy + torch.sum(f * dy, dim=2)
        fz = fz + torch.sum(f * dz, dim=2)
        eng_vdw = eng_vdw + 0.5 * torch.sum(ev)
        eng_coul = eng_coul + 0.5 * torch.sum(ec)

        if want_bind:
            can = ((ff.bonding_matr.reshape(-1)[tpair] != 0) & mask
                   & (r2 <= ff.bind_r2.reshape(-1)[tpair]))
            if pari is not None:
                parj = r(B["parents"])
                can = (can & (pari[:, :, None] != aidj[:, None, :])
                       & (parj[:, None, :] != aidi[:, :, None]))
            bind_r2b, bind_idb = tile_min(can, r2, aidj, bind_r2b, bind_idb)

        if want_jump:
            don_j, acc_j = jump_roles(ff, tj)
            don_j, acc_j = don_j & vj, acc_j & vj
            in_rng = mask & (r2 <= cfg.r2_elec)
            jump_r2b, jump_idb = tile_min(
                don_i[:, :, None] & acc_j[:, None, :] & in_rng, r2, aidj,
                jump_r2b, jump_idb)
            jmpa_r2b, jmpa_idb = tile_min(
                accrow_i[:, :, None] & don_j[:, None, :] & in_rng, r2, aidj,
                jmpa_r2b, jmpa_idb)

    soa = B["slot_of_atom"]
    frc = torch.stack([_unsort(fx, soa, 0.0), _unsort(fy, soa, 0.0),
                       _unsort(fz, soa, 0.0)], dim=1)
    bind_idx, bind_r2 = no_candidates(N, dt, dev)
    jump_idx, jump_r2 = bind_idx.clone(), bind_r2.clone()
    if want_bind:
        bind_idx = _unsort(bind_idb, soa, N)
        bind_r2 = _unsort(bind_r2b, soa, big)
    if want_jump:
        # donor rows and pure-acceptor rows are disjoint: a min merges them
        jump_idb = torch.where(jmpa_r2b < jump_r2b, jmpa_idb, jump_idb)
        jump_r2b = torch.minimum(jump_r2b, jmpa_r2b)
        jump_idx = _unsort(jump_idb, soa, N)
        jump_r2 = _unsort(jump_r2b, soa, big)
    return PairResult(frc=frc, eng_vdw=eng_vdw, eng_coul=eng_coul,
                      max_occ=B["max_occ"], bind_idx=bind_idx,
                      bind_r2=bind_r2, jump_idx=jump_idx, jump_r2=jump_r2)


# --------------------------------------------------------------------------
# the stacked pass: what the kernel and its plain version share


def stacked_ok(grid) -> bool:
    """Whether the stacked pass takes this grid: at least three cells a
    side and every stencil offset within +-1 cell, so that a neighbor
    cell is another cell and its periodic image is one box shift away."""
    return (min(grid.dims) >= 3
            and all(abs(o) <= 1 for off in grid.stencil for o in off))


def half_stencil(grid) -> list:
    """The Newton half stencil of the TPU kernel: the own cell, then one
    of each +-offset pair in lexicographic order."""
    return [(0, 0, 0)] + sorted(o for o in grid.stencil if o > (0, 0, 0))


def full_stencil(grid) -> list:
    """The offsets the Hopper pass walks: the half stencil and the
    negatives of its neighbor offsets, own cell first."""
    half = half_stencil(grid)
    return half + [tuple(-o for o in off) for off in half[1:]]


def cell_table(cfg, pos, types, radii=None):
    """The (n_cell, cap) table of the stacked pass: x, y, z, int32 types,
    radii (None without), the int32 count of filled slots of each cell
    (they are its first), slot_of_atom and max_occ, from ``bin_atoms``."""
    extra = [("types", types.to(torch.int32), 0)]
    if radii is not None:
        extra.append(("radii", radii, 1.0))
    B = bin_atoms(cfg, pos, extra=extra)
    shape = (cfg.grid.n_cell, cfg.grid.cap)
    B["cnt"] = B["valid"].reshape(shape).sum(1, dtype=torch.int32)
    for k in ("x", "y", "z", "types", "radii"):
        if k in B:
            B[k] = B[k].reshape(shape)
    return B


def _stacked_result(T, frc_slots, ev, ec, n, dt) -> PairResult:
    """PairResult of the (n_cell * cap, 3) slot forces of a cell table."""
    dev = frc_slots.device
    flat = torch.cat([frc_slots, torch.zeros((1, 3), dtype=frc_slots.dtype,
                                             device=dev)])
    idx, r2n = no_candidates(n, dt, dev)
    return PairResult(frc=flat[T["slot_of_atom"].long()].to(dt),
                      eng_vdw=ev.to(dt), eng_coul=ec.to(dt),
                      max_occ=T["max_occ"], bind_idx=idx, bind_r2=r2n,
                      jump_idx=idx.clone(), jump_r2=r2n.clone())


def _check_stacked(cfg):
    if not stacked_ok(cfg.grid):
        raise ValueError(
            "the stacked cell-block pass needs at least 3 cells a side and "
            f"a stencil within +-1 cell; got dims {cfg.grid.dims} with "
            f"{len(cfg.grid.stencil)} offsets (the block engine takes it)")


# --------------------------------------------------------------------------
# plain PyTorch version


def pair_forces_stacked_plain(cfg, ff, pos, types, radii=None) -> PairResult:
    """What the kernel computes, in plain PyTorch: every cell against the
    cells of the full stencil as (n_cell, cap, cap) tiles, the neighbor's
    positions shifted by the periodic image instead of a min-image
    rounding, with ``allpairs.pair_terms`` (rsqrt and the rational erfc
    in f32), every energy weighted 0.5.  Forces, the two energies and
    ``max_occ`` as the TPU kernel's half-stencil pass gives them."""
    _check_stacked(cfg)
    dt = pos.dtype
    dev = pos.device
    grid = cfg.grid
    cap, n_cell = grid.cap, grid.n_cell
    use_radii = bool(cfg.use_radii and radii is not None)
    T = cell_table(cfg, pos, types, radii if use_radii else None)
    tabs = plain_tables(cfg, ff, dt)

    cells = torch.arange(n_cell, device=dev)
    coord = [torch.div(cells, grid.dims[1] * grid.dims[2],
                       rounding_mode="floor"),
             torch.div(cells, grid.dims[2], rounding_mode="floor")
             % grid.dims[1], cells % grid.dims[2]]
    slots = torch.arange(cap, device=dev)
    vi = slots[None, :] < T["cnt"][:, None]                 # (n_cell, cap)
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    ti = T["types"][:, :, None]
    rai = T["radii"][:, :, None] if use_radii else None
    acc = torch.zeros((3, n_cell, cap), dtype=dt, device=dev)
    ev = torch.zeros((), dtype=dt, device=dev)
    ec = torch.zeros((), dtype=dt, device=dev)
    for off in full_stencil(grid):
        ncell = 0
        d = []
        for k, name in enumerate("xyz"):
            nk = coord[k] + off[k]
            wrap = torch.div(nk, grid.dims[k], rounding_mode="floor")
            shift = (wrap * cfg.box[k]).to(dt)       # -box, 0 or +box
            ncell = ncell * grid.dims[k] + (nk - wrap * grid.dims[k])
            d.append((k, name, shift))
        disp = []
        for k, name, shift in d:
            aj = T[name][ncell] + shift[:, None]
            disp.append(T[name][:, :, None] - aj[:, None, :])
        dx, dy, dz = disp
        r2 = dx * dx + dy * dy + dz * dz
        valid = vi[:, :, None] & vi[ncell][:, None, :]
        if off == (0, 0, 0):
            valid = valid & ~eye[None, :, :]
        inr = valid & (r2 <= cfg.r2_max)
        fsum, e_v, e_c = pair_terms(
            cfg, tabs, r2, inr, ti, T["types"][ncell][:, None, :], rai,
            T["radii"][ncell][:, None, :] if use_radii else None)
        acc[0] += torch.sum(fsum * dx, -1)
        acc[1] += torch.sum(fsum * dy, -1)
        acc[2] += torch.sum(fsum * dz, -1)
        ev = ev + e_v.sum()
        ec = ec + e_c.sum()
    return _stacked_result(T, acc.reshape(3, -1).T, ev, ec, cfg.n_at, dt)


# --------------------------------------------------------------------------
# the kernel


def pair_forces_stacked(cfg, ff, pos, types, radii=None) -> PairResult:
    """The stacked cell-block pass: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if pos.device.type == "cpu":
        return pair_forces_stacked_plain(cfg, ff, pos, types, radii)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    return _stacked_cuda(cfg, ff, pos, types, radii)


def stacked_smem(nsp: int, cap: int, nz: int) -> int:
    """Dynamic shared-memory bytes of a K3 block taking ``nz`` cells: x,
    y, z, radius and type of 9 columns of nz + 2 cells of ``cap`` slots,
    and the (nsp*nsp, 9) parameter tables (``smem_bytes`` in
    csrc/cellblock.cu)."""
    return 9 * (nz + 2) * cap * 20 + nsp * nsp * 9 * 4


def stacked_plan(cap: int, dims, n_at: int, nsp: int) -> tuple[int, int]:
    """K3's launch plan: (nz, dynamic shared bytes), a block taking nz
    consecutive cells along z.  nz is the number of average cells
    (``n_at`` atoms over the grid) that hold about K3_ROWS atoms, at
    least 1 and at most K3_NZ_MAX and the grid's side, less while the
    staged cells of ``cap`` slots do not fit a block's shared memory.
    Raises when even one cell's stencil does not fit."""
    n_cell = dims[0] * dims[1] * dims[2]
    avg = n_at / n_cell
    nz = max(1, min(K3_NZ_MAX, dims[2],
                    int(K3_ROWS // avg) if avg > 0 else K3_NZ_MAX))
    while nz > 1 and stacked_smem(nsp, cap, nz) > _MAX_SMEM:
        nz -= 1
    smem = stacked_smem(nsp, cap, nz)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"the cell-block kernel cannot hold cap={cap}: it stages 27 "
            f"neighbor cells in {smem} bytes of shared memory (limit "
            f"{_MAX_SMEM}); use the block engine for this grid")
    return nz, smem


def _lib():
    lib = cuda_build.load("cellblock")
    fn = lib.aztotmd_cellblock_f32
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 8 + [I] * 8 + [F] * 12 + [P] * 4)
        fn.restype = ctypes.c_int
        lib.aztotmd_cellblock_smem_bytes.argtypes = [I, I, I]
        lib.aztotmd_cellblock_smem_bytes.restype = ctypes.c_long
    return lib


def _stacked_cuda(cfg, ff, pos, types, radii) -> PairResult:
    N = cfg.n_at
    dev = pos.device
    if pos.dtype != torch.float32:
        raise TypeError("the cell-block CUDA kernel is f32 only; got "
                        f"{pos.dtype} (f64 takes the block engine)")
    if cfg.n_spec > 32:
        raise ValueError(f"the cell-block kernel takes at most 32 species "
                         f"(shared-memory table), got {cfg.n_spec}")
    _check_stacked(cfg)
    use_radii = bool(cfg.use_radii and radii is not None)
    check_tensor("pos", pos, torch.float32, (N, 3), dev)
    check_tensor("types", types, torch.int32, (N,), dev)
    if use_radii:
        check_tensor("radii", radii, torch.float32, (N,), dev)
    T = cell_table(cfg, pos, types, radii if use_radii else None)
    frc, ev, ec = launch(cfg, *kernel_tables(cfg, ff, dev), T)
    return _stacked_result(T, frc, ev.sum(), ec.sum(), N, torch.float32)


def launch(cfg, prm, kinds, T):
    """Launch csrc/cellblock.cu on a cell table (``cell_table``) and
    return its (n_cell * cap, 3) slot forces and (n_cell,) energies of
    each cell.  Counts the launch as K3.  Raises for a ``cap`` whose
    neighbor cells do not fit a block's shared memory
    (``stacked_plan``)."""
    global launches
    grid = cfg.grid
    cap, n_cell = grid.cap, grid.n_cell
    dev = T["x"].device
    n_off = len(full_stencil(grid))
    if n_off != 27:
        raise ValueError(f"the cell-block kernel walks the 27 cells within "
                         f"+-1; got a stencil of {n_off}")
    nz, _ = stacked_plan(cap, grid.dims, cfg.n_at, cfg.n_spec)
    lib = _lib()
    frc = torch.empty((n_cell * cap, 3), dtype=torch.float32, device=dev)
    ev = torch.empty(n_cell, dtype=torch.float32, device=dev)
    ec = torch.empty(n_cell, dtype=torch.float32, device=dev)
    radii = T.get("radii")
    err = lib.aztotmd_cellblock_f32(
        T["x"].data_ptr(), T["y"].data_ptr(), T["z"].data_ptr(),
        T["types"].data_ptr(),
        radii.data_ptr() if radii is not None else None,
        T["cnt"].data_ptr(), prm.data_ptr(), kinds.data_ptr(), cfg.n_spec,
        cap, nz, grid.dims[0], grid.dims[1], grid.dims[2],
        int(radii is not None), int(cfg.elec_type), *kernel_consts(cfg),
        frc.data_ptr(), ev.data_ptr(), ec.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cellblock kernel launch failed: CUDA error {err}")
    launches += 1
    return frc, ev, ec
