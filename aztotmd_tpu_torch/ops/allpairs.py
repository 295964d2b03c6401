"""Dense O(N^2) pair pass: the hand-written CUDA kernel and its plain
PyTorch version (port of ``aztotmd_tpu/ops/pallas_pair.py``:
``pair_forces_allpairs`` with ``_allpairs_kernel`` and ``_tile_physics``,
its fused bind/jump candidates included, and the dispatcher
``pair_forces_pallas``, which sends a pass to this kernel, to the stacked
cell-block kernel or to the cell-block engine of ``ops/cellblock.py``).

Kernel: ``csrc/allpairs.cu``, CUDA C++ for sm_90a, bound through a plain
C interface and ``ctypes``.  It replaces the TPU kernel
``aztotmd_tpu/ops/pallas_pair.py::_allpairs_kernel``.  On the H100 the
pass is bound by FP32/SFU issue over the N^2 pairs (an rsqrt per pair,
an exp for the exponential families and Ewald/Fennel), not by memory:
it reads O(N) bytes.  The design keeps everything per pair in registers
(one thread per i atom, one-sided accumulation, no atomics), splits the j
range over enough blocks for eight an SM (``allpairs_split``, from the
device's SM count), stages each split's range in shared memory once with
cp.async, and tests 32 j atoms at a time before it runs the physics of
those in range; see the note at the top of the source.

Bind/jump candidates (``want_bind``, ``want_jump``) are running row
minima of r2 kept beside the forces: the nearest bonding partner (a
bonding species pair within its bind radius, not each other's parent)
and the nearest jump partner of each role within ``r2_elec``.  Ties go
as in the TPU kernel, which visits j tiles of ``cand_tile`` atoms in
order and the species pairs in order within a tile: to the earliest
tile, then the lowest species, then the lowest id.  Every minimum
carries that order as an int64 key ``(tile * nsp + species) * N + id``,
so the kernel's per-split minima merge exactly.

Routing of ``pair_forces_allpairs``: a CPU tensor goes to the plain
version, in f32 or f64; a CUDA tensor launches the kernel or raises.  The
kernel is f32 only.  The dispatcher sends f64 to the cell-block engine on
either device, as the JAX package does (``pallas_pair.py:732``).

``pair_forces_allpairs_rect`` is the rectangular pass of the
slab-decomposed step (``pallas_pair.py::pair_forces_allpairs_rect``):
forces on the Ni owned slots of each slab from its Nj slots [owned;
halos], every local slab in one launch of ``csrc/allpairs_rect.cu``,
routed by device like the square pass.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..io.control import (ELEC_DIRECT, ELEC_EWALD, ELEC_FENNEL,
                          ELEC_NONE)
from ..io.field import (VDW_746, VDW_BHM, VDW_BUCK, VDW_EINV,
                        VDW_ELIN, VDW_LJ, VDW_SURK)

from . import cuda_build
from .consts import const
from .pairs import (MX_FRC, PairResult, jump_roles, keyed_row_min,
                    pair_result)

# launches of csrc/allpairs.cu made by pair_forces_allpairs, without
# candidates (K1) and with them (K1-cand), and of csrc/allpairs_rect.cu made
# by pair_forces_allpairs_rect (K2); plain ints that tools checking the main
# path reset and read
launches = 0
cand_launches = 0
rect_launches = 0

BLOCKS_PER_SM = 8        # blocks K1 and K4 aim at for each SM
J_UNIT = 32              # fewest j atoms of a K1 split (a warp's chunk)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_sm_counts: dict = {}


def sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (cached)."""
    idx = torch.device(dev).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def allpairs_split(n: int, tile: int, sm_count: int,
                   max_range: int = 4096) -> int:
    """Splits of K1's j range: enough (i block, split) blocks of ``tile``
    i atoms for BLOCKS_PER_SM an SM, no split under J_UNIT j atoms (so
    never more splits than the range has units, and 1 for tiny N), and
    none over ``max_range`` j atoms (the kernel's shared-memory stage)."""
    n_blk = max(1, -(-n // tile))
    units = max(1, -(-n // J_UNIT))
    fill = -(-BLOCKS_PER_SM * sm_count // n_blk)
    return max(min(units, fill), -(-n // max_range), 1)


def allpairs_cost(cfg) -> int:
    """Modeled slot-pair count of the dense pass (the JAX package's
    padded-N^2 model, compared against stencil * cap^2 * n_cell)."""
    n_pad = _round_up(cfg.n_at, 512)
    return n_pad * n_pad


def block_cost(cfg) -> int:
    g = cfg.grid
    return len(g.stencil) * g.cap * g.cap * g.n_cell


def cand_tile(n: int) -> int:
    """j-tile width of the TPU kernel's candidate pass, which sets the
    order of ties (``pair_forces_allpairs``: T = min(512, round_up(N,
    128)), capped at 256 with candidates)."""
    return min(256, _round_up(max(n, 1), 128))


def pallas_branch(cfg, dtype, want_bind=False, want_jump=False) -> str:
    """The pass the ``pallas`` engine takes, in ``pair_forces_pallas``'s
    order of tests: "block" for f64; "allpairs" (K1) when the padded N^2
    undercuts the modeled cell-block cost; "block" for bind/jump
    candidates, a grid under three cells a side or a stencil beyond +-1
    cell; else "stacked" (K3)."""
    from .cellblock import stacked_ok
    if dtype == torch.float64:
        return "block"
    if allpairs_cost(cfg) < block_cost(cfg):
        return "allpairs"
    if want_bind or want_jump or not stacked_ok(cfg.grid):
        return "block"
    return "stacked"


def pair_forces_pallas(cfg, ff, pos, types, radii=None, parents=None,
                       want_bind=False, want_jump=False) -> PairResult:
    """The ``pallas`` engine's pair pass (``pair_forces_pallas`` of the JAX
    package): the dense all-pairs pass, the stacked cell-block pass or the
    cell-block engine, as ``pallas_branch`` picks."""
    from . import cellblock
    branch = pallas_branch(cfg, pos.dtype, want_bind, want_jump)
    if branch == "allpairs":
        return pair_forces_allpairs(cfg, ff, pos, types, radii, parents,
                                    want_bind, want_jump)
    if branch == "stacked":
        return cellblock.pair_forces_stacked(cfg, ff, pos, types, radii)
    return cellblock.pair_forces_block(cfg, ff, pos, types, radii, parents,
                                       want_bind, want_jump)


# --------------------------------------------------------------------------
# plain PyTorch version


def erfc_as(x):
    """erfc by Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7), as the kernels."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return poly * torch.exp(-x * x)


def _vdw_pair(kind, r2i, ri, rr, p, ra=None, rb=None):
    """Force-over-r and energy of one family with scalar params p[0..4]."""
    p0, p1, p2, p3, p4 = p
    if kind == VDW_LJ:
        s = p1 * r2i
        sr6 = s * s * s
        return p2 * r2i * sr6 * (2.0 * sr6 - 1.0), p0 * sr6 * (sr6 - 1.0)
    if kind == VDW_BUCK:
        ip1 = 1.0 / p1
        r6i = r2i * r2i * r2i
        ex = torch.exp(-rr * ip1)
        return (p0 * ex * ri * ip1 - 6.0 * p2 * r6i * r2i,
                p0 * ex - p2 * r6i)
    if kind == VDW_746:
        r4i = r2i * r2i
        return (r4i * r2i * (7.0 * p0 * r2i * ri - 4.0 * p1 - 6.0 * p2 * r2i),
                r4i * (p0 * r2i * ri - p1 - p2 * r2i))
    if kind == VDW_BHM:
        r6i = r2i * r2i * r2i
        ex = torch.exp(p1 * (p2 - rr))
        return (p0 * p1 * ex * ri - 6.0 * p3 * r6i * r2i
                - 8.0 * p4 * r6i * r2i * r2i,
                p0 * ex - p3 * r6i - p4 * r6i * r2i)
    if kind == VDW_ELIN:
        ip1 = 1.0 / p1
        ex = torch.exp(-rr * ip1)
        return p0 * ex * ri * ip1 - p2 * ri, p0 * ex + p2 * rr
    if kind == VDW_EINV:
        ip1 = 1.0 / p1
        ex = torch.exp(-rr * ip1)
        return p0 * ex * ri * ip1 - p2 * ri * r2i, p0 * ex - p2 * ri
    if kind == VDW_SURK:
        r6i = r2i * r2i * r2i
        c2sum = p1 / (p2 * ra + p3 * rb)
        rprod = ra * rb
        c1ab2 = rprod * rprod * p0
        return (rprod * r6i * r2i * (7.0 * c1ab2 * ri - 6.0 * c2sum),
                rprod * r6i * (c1ab2 * ri - c2sum))
    raise ValueError(f"unknown vdw kind {kind}")


def _coul_pair(cfg, r2i, ri, rr, kqq, erfc):
    if cfg.elec_type == ELEC_DIRECT:
        return kqq * ri * r2i, kqq * ri
    ar = cfg.alpha * rr
    ec = erfc(ar)
    if cfg.elec_type == ELEC_EWALD:
        return (kqq * ri * r2i * (ec + cfg.daipi2 * rr * torch.exp(-ar * ar)),
                kqq * ec * ri)
    if cfg.elec_type == ELEC_FENNEL:
        return (kqq * ri * ((ec * r2i + cfg.daipi2 * torch.exp(-ar * ar) * ri)
                            - cfg.fennel_c2),
                kqq * (ec * ri - cfg.fennel_c1
                       + cfg.fennel_c2 * (rr - cfg.r_real)))
    raise ValueError(f"unknown elec type {cfg.elec_type}")


def plain_tables(cfg, ff, dt):
    """(nsp*nsp, 5) VdW parameters, r2cut and kqq rows in dtype ``dt``."""
    return (ff.vdw_p.reshape(-1, 5).to(dt), ff.vdw_r2cut.reshape(-1).to(dt),
            (ff.chprod.reshape(-1) * cfg.coul_scale).to(dt))


def pair_terms(cfg, tabs, r2, inr, ti, tj, rai, raj):
    """Plain physics of a block of ordered pairs (``_tile_physics``).

    ``r2`` holds the min-image squared distances, ``inr`` the pairs in
    range (self pairs and padding already masked out); ``ti``/``tj`` and
    the radii ``rai``/``raj`` (None without radii) broadcast against them.
    Returns the clipped force-over-r, and the VdW and Coulomb energies of
    each row summed over the last axis with weight 0.5 per ordered pair.
    In f32 it follows the kernels operation by operation, with the A&S
    erfc; in f64 it is the JAX package's f64 route, with the exact erfc.
    """
    vp, r2cut, kqq = tabs
    nsp = cfg.n_spec
    erfc = torch.special.erfc if r2.dtype == torch.float64 else erfc_as
    use_coul = cfg.elec_type != ELEC_NONE
    r2s = torch.where(inr, r2, torch.ones_like(r2))
    ri = torch.rsqrt(r2s)
    r2i = ri * ri
    rr = r2s * ri
    zero = torch.zeros_like(r2)
    fsum = zero
    ev = torch.zeros(r2.shape[:-1], dtype=r2.dtype, device=r2.device)
    ec = ev.clone()
    for a in range(nsp):
        for b in range(nsp):
            kind = cfg.vdw_kind_table[a][b]
            row = a * nsp + b
            if not (kind or use_coul):
                continue
            pm = inr if nsp == 1 else inr & (ti == a) & (tj == b)
            if kind:
                vm = pm & (r2 <= r2cut[row])
                fv, e_v = _vdw_pair(kind, r2i, ri, rr,
                                    [vp[row, k] for k in range(5)],
                                    ra=rai, rb=raj)
                fsum = fsum + torch.where(vm, fv, zero)
                ev = ev + 0.5 * torch.sum(torch.where(vm, e_v, zero), -1)
            if use_coul:
                fc, e_c = _coul_pair(cfg, r2i, ri, rr, kqq[row], erfc)
                fsum = fsum + torch.where(pm, fc, zero)
                ec = ec + 0.5 * torch.sum(torch.where(pm, e_c, zero), -1)
    return torch.clamp(fsum, -MX_FRC, MX_FRC), ev, ec


def bind_table(ff, dt):
    """(nsp*nsp,) squared bind radius of each species pair, 0 where the
    pair does not bond (column 7 of the kernel's parameter rows)."""
    return (ff.bind_r2 * (ff.bonding_matr != 0)).reshape(-1).to(dt)


def plain_candidates(cfg, ff, r2, inr, ti, tj, gi, gj, key, pari, parj,
                     want_bind, want_jump):
    """Row minima over the last axis of the bind and per-role jump
    candidates of a block of ordered pairs, as ``_tile_physics``.

    ``inr`` marks the pairs in range; ``ti``/``tj``, the global ids
    ``gi``/``gj``, the tie ``key`` and the parents ``pari``/``parj``
    (None without) broadcast against ``r2``.  Returns (bind, jump):
    bind a (min r2, key) pair, jump its (donor-row, acceptor-row) pair,
    None where not wanted."""
    bind = jump = None
    if want_bind:
        can = inr & (r2 <= bind_table(ff, r2.dtype)[(ti * cfg.n_spec
                                                       + tj).long()])
        if pari is not None:
            can = can & (pari != gj) & (parj != gi)
        bind = keyed_row_min(r2, can, key)
    if want_jump:
        don_i, acc_i = jump_roles(ff, ti)
        don_j, acc_j = jump_roles(ff, tj)
        ej = inr & (r2 <= cfg.r2_elec)
        jump = (keyed_row_min(r2, ej & don_i & acc_j, key),
                keyed_row_min(r2, ej & acc_i & don_j, key))
    return bind, jump


def _cat_minima(parts):
    """Join per-chunk (m, k) row minima, or pairs of them."""
    if parts[0] is None:
        return None
    if isinstance(parts[0][0], tuple):
        return tuple(_cat_minima([p[q] for p in parts]) for q in range(2))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def pair_forces_allpairs_plain(cfg, ff, pos, types, radii=None,
                               parents=None, want_bind=False,
                               want_jump=False,
                               rows: int | None = None) -> PairResult:
    """What the kernel computes, in plain PyTorch, ``rows`` i atoms at a
    time so a 4k x 4k pass fits in memory (f32 or f64, see
    ``pair_terms``)."""
    N = cfg.n_at
    dt = pos.dtype
    dev = pos.device
    use_radii = bool(cfg.use_radii and radii is not None)
    use_par = bool(want_bind and parents is not None)
    tabs = plain_tables(cfg, ff, dt)
    box = const(cfg.box, dt, dev)
    ibox = const([1.0 / b for b in cfg.box], dt, dev)
    if rows is None:
        rows = max(1, (1 << 22) // max(N, 1))
    gj = torch.arange(N, device=dev)
    key = ((gj // cand_tile(N)) * cfg.n_spec + types.long()) * N + gj
    frc = torch.zeros((N, 3), dtype=dt, device=dev)
    ev_sum = torch.zeros((), dtype=dt, device=dev)
    ec_sum = torch.zeros((), dtype=dt, device=dev)
    binds, jumps = [], []
    for i0 in range(0, N, rows):
        i1 = min(N, i0 + rows)
        d = []
        for k in range(3):
            dk = pos[i0:i1, k, None] - pos[None, :, k]
            d.append(dk - box[k] * torch.round(dk * ibox[k]))
        dx, dy, dz = d
        r2 = dx * dx + dy * dy + dz * dz
        gi = torch.arange(i0, i1, device=dev)[:, None]
        inr = (r2 <= cfg.r2_max) & (gi != gj[None, :])
        ti, tj = types[i0:i1, None], types[None, :]
        fsum, ev, ec = pair_terms(
            cfg, tabs, r2, inr, ti, tj,
            radii[i0:i1, None] if use_radii else None,
            radii[None, :] if use_radii else None)
        ev_sum = ev_sum + ev.sum()
        ec_sum = ec_sum + ec.sum()
        frc[i0:i1, 0] = torch.sum(fsum * dx, dim=1)
        frc[i0:i1, 1] = torch.sum(fsum * dy, dim=1)
        frc[i0:i1, 2] = torch.sum(fsum * dz, dim=1)
        b, j = plain_candidates(
            cfg, ff, r2, inr, ti, tj, gi, gj[None, :], key[None, :],
            parents[i0:i1, None] if use_par else None,
            parents[None, :] if use_par else None, want_bind, want_jump)
        binds.append(b)
        jumps.append(j)
    return pair_result(frc, ev_sum, ec_sum, _zero_occ(dev), ff, types,
                       _cat_minima(binds), _cat_minima(jumps))


def _zero_occ(dev):
    return torch.zeros((), dtype=torch.int32, device=dev)


# --------------------------------------------------------------------------
# the kernel


def pair_forces_allpairs(cfg, ff, pos, types, radii=None, parents=None,
                         want_bind=False, want_jump=False) -> PairResult:
    """Dense pair pass: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if pos.device.type == "cpu":
        return pair_forces_allpairs_plain(cfg, ff, pos, types, radii,
                                          parents, want_bind, want_jump)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    return _allpairs_cuda(cfg, ff, pos, types, radii, parents, want_bind,
                          want_jump)


def kernel_tables(cfg, ff, device, want_bind=False):
    """(nsp*nsp, 8) f32 parameter rows [p0..p4, kqq, r2cut, bind r2 (0
    without ``want_bind``)] and the (nsp*nsp,) int32 kind table, as the
    kernels read them."""
    nsp = cfg.n_spec
    prm = torch.zeros((nsp * nsp, 8), dtype=torch.float32, device=device)
    prm[:, 0:5] = ff.vdw_p.reshape(-1, 5).to(torch.float32)
    prm[:, 5] = (ff.chprod.reshape(-1) * cfg.coul_scale).to(torch.float32)
    prm[:, 6] = ff.vdw_r2cut.reshape(-1).to(torch.float32)
    if want_bind:
        prm[:, 7] = bind_table(ff, torch.float32)
    kinds = const([k for row in cfg.vdw_kind_table for k in row],
                  torch.int32, device)
    return prm, kinds


def kernel_consts(cfg) -> list:
    """The f32 scalars of ``PairConsts`` (csrc/pair_physics.cuh): box,
    its reciprocal rounded to f32 as the JAX kernels do, r2_max and the
    Coulomb constants."""
    return ([f32(b) for b in cfg.box] + [f32(1.0 / b) for b in cfg.box]
            + [f32(cfg.r2_max), f32(cfg.alpha), f32(cfg.daipi2),
               f32(cfg.fennel_c1), f32(cfg.fennel_c2), f32(cfg.r_real)])


def f32(v) -> float:
    """``v`` rounded to f32."""
    return float(np.float32(v))


@dataclass
class CandArgs:
    """Inputs of a candidate pass: the (nsp,) int32 donor/acceptor bits,
    the (N,) int32 parents in the kernel's atom order (None: no parent
    test) and which minima to keep."""
    donacc: torch.Tensor
    parents: torch.Tensor | None
    want_bind: bool
    want_jump: bool

    def c_args(self, cfg, tie: int) -> list:
        """want_bind, want_jump, use_par, the kernel's tie-order integer
        (K1: its tie tile width, K4: N) and r2_elec, in C order."""
        return [int(self.want_bind), int(self.want_jump),
                int(self.parents is not None), tie, f32(cfg.r2_elec)]


def cand_args(cfg, ff, parents, want_bind, want_jump, dev):
    """CandArgs of a pass, or None without candidates (checks parents)."""
    if not (want_bind or want_jump):
        return None
    par = parents if want_bind else None
    if par is not None:
        check_tensor("parents", par, torch.int32, (cfg.n_at,), dev)
    return CandArgs(ff.spec_donacc.to(device=dev, dtype=torch.int32)
                    .contiguous(), par, want_bind, want_jump)


def merge_splits(cand_r2, cand_key, q):
    """Minimum q (0 bind, 1 jump donor row, 2 jump acceptor row) over the
    kernel's splits: (min r2, key) per row, exact since the key orders
    ties."""
    m = cand_r2[q].T
    return keyed_row_min(m, torch.isfinite(m), cand_key[q].T)


def split_candidates(c: CandArgs | None, cand_r2, cand_key):
    """(bind, jump) row minima of a kernel launch, for ``pair_result``."""
    if c is None:
        return None, None
    bind = merge_splits(cand_r2, cand_key, 0) if c.want_bind else None
    jump = ((merge_splits(cand_r2, cand_key, 1),
             merge_splits(cand_r2, cand_key, 2)) if c.want_jump else None)
    return bind, jump


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CAND_C = [_P, _P, _I, _I, _I, _I, _F, _P, _P]   # CandArgs + outputs


def _lib():
    lib = cuda_build.load("allpairs")
    fn = lib.aztotmd_allpairs_f32
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 5 + [_I] * 5 + [_F] * 12 + [_P] * 4)
        fn.restype = ctypes.c_int
        cf = lib.aztotmd_allpairs_cand_f32
        cf.argtypes = ([_P] * 5 + [_I] * 5 + [_F] * 12 + [_P] * 3
                       + _CAND_C + [_P])
        cf.restype = ctypes.c_int
        lib.aztotmd_allpairs_tile.restype = ctypes.c_int
        lib.aztotmd_allpairs_max_range.restype = ctypes.c_int
        lib.aztotmd_allpairs_smem_bytes.argtypes = [_I] * 5
        lib.aztotmd_allpairs_smem_bytes.restype = ctypes.c_longlong
    return lib


def check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _allpairs_cuda(cfg, ff, pos, types, radii, parents, want_bind,
                   want_jump) -> PairResult:
    N = cfg.n_at
    dev = pos.device
    if pos.dtype != torch.float32:
        raise TypeError("the all-pairs CUDA kernel is f32 only; got "
                        f"{pos.dtype} (the engines send f64 to the cell-block "
                        "engine)")
    if cfg.n_spec > 32:
        raise ValueError(f"the all-pairs kernel takes at most 32 species "
                         f"(shared-memory table), got {cfg.n_spec}")
    use_radii = bool(cfg.use_radii and radii is not None)
    check_tensor("pos", pos, torch.float32, (N, 3), dev)
    check_tensor("types", types, torch.int32, (N,), dev)
    if use_radii:
        check_tensor("radii", radii, torch.float32, (N,), dev)
    c = cand_args(cfg, ff, parents, want_bind, want_jump, dev)
    frc_p, ev_p, ec_p, cr2, ckey = launch(
        cfg, *kernel_tables(cfg, ff, dev, want_bind), pos, types,
        radii if use_radii else None, c)
    return pair_result(frc_p.sum(0), ev_p.sum(), ec_p.sum(), _zero_occ(dev),
                       ff, types, *split_candidates(c, cr2, ckey))


def launch(cfg, prm, kinds, pos, types, radii, cand: CandArgs | None = None):
    """Launch csrc/allpairs.cu on checked inputs (``radii`` None without
    radii) and return its (n_split, N, 3) force and (n_split, N) energy
    partial rows, and with ``cand`` its (3, n_split, N) f32 r2 and int64
    key partial minima (bind, jump donor row, jump acceptor row; else
    None).  Counts the launch as K1 or, with ``cand``, K1-cand.  The
    splits come from ``allpairs_split``; the kernel refuses (and this
    raises) a split whose j range would not fit its shared memory."""
    global launches, cand_launches
    N = cfg.n_at
    dev = pos.device
    lib = _lib()
    n_split = allpairs_split(N, lib.aztotmd_allpairs_tile(), sm_count(dev),
                             lib.aztotmd_allpairs_max_range())
    frc_p = torch.empty((n_split, N, 3), dtype=torch.float32, device=dev)
    ev_p = torch.empty((n_split, N), dtype=torch.float32, device=dev)
    ec_p = torch.empty((n_split, N), dtype=torch.float32, device=dev)
    cr2 = ckey = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not N:
        return frc_p, ev_p, ec_p, cr2, ckey
    common = [pos.data_ptr(), types.data_ptr(),
              radii.data_ptr() if radii is not None else None,
              prm.data_ptr(), kinds.data_ptr(), cfg.n_spec, N, n_split,
              int(radii is not None), int(cfg.elec_type),
              *kernel_consts(cfg), frc_p.data_ptr(), ev_p.data_ptr(),
              ec_p.data_ptr()]
    if cand is None:
        err = lib.aztotmd_allpairs_f32(*common, stream)
    else:
        cr2 = torch.empty((3, n_split, N), dtype=torch.float32, device=dev)
        ckey = torch.empty((3, n_split, N), dtype=torch.int64, device=dev)
        err = lib.aztotmd_allpairs_cand_f32(
            *common, cand.donacc.data_ptr(),
            cand.parents.data_ptr() if cand.parents is not None else None,
            *cand.c_args(cfg, cand_tile(N)), cr2.data_ptr(),
            ckey.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"allpairs kernel launch failed: CUDA error {err}")
    if cand is None:
        launches += 1
    else:
        cand_launches += 1
    return frc_p, ev_p, ec_p, cr2, ckey


# --------------------------------------------------------------------------
# the rectangular pass of the slab-decomposed step (K2)


def _rect_batched(tensors):
    """The inputs with a leading slab axis, and whether it was added."""
    squeeze = tensors[0].dim() == 2
    if squeeze:
        tensors = [None if t is None else t[None] for t in tensors]
    return tensors, squeeze


def pair_forces_allpairs_rect_plain(cfg, ff, pos_i, types_i, valid_i,
                                    pos_j, types_j, valid_j, radii_i=None,
                                    radii_j=None, rows: int | None = None):
    """What the rectangular kernel computes, in plain PyTorch (f32 or f64,
    see ``pair_terms``), ``rows`` i slots at a time.

    Per slab: forces on the Ni i slots from the Nj j slots, where the i
    slots are the first Ni j slots (the self pair is i == j by slot
    index), a pair counts when both slots are valid, the min-image is over
    the full box.  ``pos_i`` (L, Ni, 3), ``types_i``/``valid_i``/
    ``radii_i`` (L, Ni), and likewise j; without the leading slab axis the
    result has none either.  Returns (frc_i (L, Ni, 3), e_vdw (L,),
    e_coul (L,)), each energy 0.5 per visited ordered pair."""
    (pos_i, types_i, valid_i, radii_i, pos_j, types_j, valid_j, radii_j), \
        squeeze = _rect_batched([pos_i, types_i, valid_i, radii_i, pos_j,
                                 types_j, valid_j, radii_j])
    dt = pos_i.dtype
    dev = pos_i.device
    L, Ni = pos_i.shape[:2]
    Nj = pos_j.shape[1]
    use_radii = bool(cfg.use_radii and radii_i is not None)
    tabs = plain_tables(cfg, ff, dt)
    box = const(cfg.box, dt, dev)
    ibox = const([1.0 / b for b in cfg.box], dt, dev)
    if rows is None:
        rows = max(1, (1 << 22) // max(Nj, 1))
    gj = torch.arange(Nj, device=dev)[None, :]
    frc = torch.zeros((L, Ni, 3), dtype=dt, device=dev)
    ev_sum = torch.zeros(L, dtype=dt, device=dev)
    ec_sum = torch.zeros(L, dtype=dt, device=dev)
    for s in range(L):
        for i0 in range(0, Ni, rows):
            i1 = min(Ni, i0 + rows)
            d = []
            for k in range(3):
                dk = pos_i[s, i0:i1, k, None] - pos_j[s, None, :, k]
                d.append(dk - box[k] * torch.round(dk * ibox[k]))
            dx, dy, dz = d
            r2 = dx * dx + dy * dy + dz * dz
            gi = torch.arange(i0, i1, device=dev)[:, None]
            inr = ((r2 <= cfg.r2_max) & (gi != gj)
                   & valid_i[s, i0:i1, None] & valid_j[s, None, :])
            fsum, ev, ec = pair_terms(
                cfg, tabs, r2, inr, types_i[s, i0:i1, None],
                types_j[s, None, :],
                radii_i[s, i0:i1, None] if use_radii else None,
                radii_j[s, None, :] if use_radii else None)
            ev_sum[s] += ev.sum()
            ec_sum[s] += ec.sum()
            frc[s, i0:i1, 0] = torch.sum(fsum * dx, dim=1)
            frc[s, i0:i1, 1] = torch.sum(fsum * dy, dim=1)
            frc[s, i0:i1, 2] = torch.sum(fsum * dz, dim=1)
    if squeeze:
        return frc[0], ev_sum[0], ec_sum[0]
    return frc, ev_sum, ec_sum


def pair_forces_allpairs_rect(cfg, ff, pos_i, types_i, valid_i, pos_j,
                              types_j, valid_j, radii_i=None, radii_j=None):
    """The rectangular pass: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same arguments and results as
    ``pair_forces_allpairs_rect_plain``)."""
    if pos_i.device.type == "cpu":
        return pair_forces_allpairs_rect_plain(
            cfg, ff, pos_i, types_i, valid_i, pos_j, types_j, valid_j,
            radii_i, radii_j)
    if pos_i.device.type != "cuda":
        raise ValueError(f"unsupported device {pos_i.device}")
    args, squeeze = _rect_batched([pos_i, types_i, valid_i, radii_i, pos_j,
                                   types_j, valid_j, radii_j])
    frc_p, ev_p, ec_p = _rect_cuda(cfg, ff, *args)
    frc, ev, ec = frc_p.sum(1), ev_p.sum((1, 2)), ec_p.sum((1, 2))
    if squeeze:
        return frc[0], ev[0], ec[0]
    return frc, ev, ec


RECT_BLOCKS_PER_SM = 32  # most (split, slab, i tile) blocks K2 aims at an SM


def rect_split(n_slab: int, ni: int, nj: int, tile: int, groups: int,
               sm_count: int) -> int:
    """Splits of K2's j range: one j tile of ``tile`` slots for each of a
    block's ``groups`` thread groups, but no more splits than give
    RECT_BLOCKS_PER_SM (split, slab, i tile) blocks an SM (the partial
    rows grow with the splits), and at least one.  K2 is latency-bound
    and its blocks with only empty i slots leave at once, so it wants many
    more blocks than K1's BLOCKS_PER_SM."""
    n_blk = max(1, n_slab * -(-ni // tile))
    tiles = -(-nj // tile)
    return max(1, min(-(-tiles // groups),
                      -(-RECT_BLOCKS_PER_SM * sm_count // n_blk)))


# --------------------------------------------------------------------------
# the warp sub-tile cull of K2 and K4, in torch (for tests and chip_smoke.py)

CULL_SUB = 32            # slots of a warp's sub-tile (SUB in csrc/*.cu)
CULL_SLACK = 2.0 ** -18  # cull margin over the longest box side
                         # (CULL_SLACK in csrc/pair_physics.cuh)


def sub_boxes(xyz, filled):
    """Boxes of the CULL_SUB-slot sub-tiles along the last axis of the
    three coordinate tensors ``xyz`` over their ``filled`` slots, as the
    kernels compute them in f32: centres and half-widths (3, ...,
    n_sub) each, and (..., n_sub) whether a sub-tile holds a filled slot
    (centres and half-widths 0 where not).  A ragged last sub-tile is
    padded with empty slots."""
    n = filled.shape[-1]
    n_sub = -(-n // CULL_SUB)
    pad = (0, n_sub * CULL_SUB - n)

    def sub(a, fill):
        a = torch.nn.functional.pad(a, pad, value=fill)
        return a.reshape(a.shape[:-1] + (n_sub, CULL_SUB))

    fs = sub(filled, False)
    nonempty = fs.any(-1)
    cs, hs = [], []
    for a in xyz:
        a = sub(a, 0.0)
        lo = torch.where(fs, a, float("inf")).amin(-1)
        hi = torch.where(fs, a, float("-inf")).amax(-1)
        cs.append(torch.where(nonempty, (lo + hi) * 0.5, 0.0))
        hs.append(torch.where(nonempty, (hi - lo) * 0.5, 0.0))
    return torch.stack(cs), torch.stack(hs), nonempty


def cull_keep(cfg, ci, hi, cj, hj):
    """Whether boxes (centres ``ci``/``cj``, half-widths ``hi``/``hj``,
    (3, ...) f32, broadcast) lie within the cutoff plus CULL_SLACK of the
    longest box side: their periodic min-image gap, the sparse worklist's
    formula with every operation rounded on its own, as the kernels round
    it.  The gap bounds every pair's distance from below, so a pair in
    range never lies in a pair of boxes this drops."""
    dt, dev = ci.dtype, ci.device
    t = lambda v: const(v, dt, dev)
    gap2 = None
    for k in range(3):
        b, ib = t(f32(cfg.box[k])), t(f32(1.0 / cfg.box[k]))
        d = ci[k] - cj[k]
        d = d - b * torch.round(d * ib)
        g = torch.clamp(torch.abs(d) - hi[k] - hj[k], min=0.0)
        gap2 = g * g if gap2 is None else gap2 + g * g
    rc = (torch.sqrt(t(f32(cfg.r2_max)))
          + t(f32(CULL_SLACK)) * t(max(f32(b) for b in cfg.box)))
    return gap2 <= rc * rc


def rect_subtile_keep(cfg, pos_i, valid_i, pos_j, valid_j):
    """(L, n_isub, n_jsub) bool: the (i sub-tile, j sub-tile) pairs of
    each slab that K2's warps keep, a sub-tile being CULL_SUB consecutive
    slots (i sub-tile w is warp w % 4 of i block w // 4).  Kept: both
    hold a filled slot and ``cull_keep`` holds for their boxes over the
    filled slots (empty slots, at the origin or holding a departed atom's
    stale position, never widen a box).  Arguments as
    ``pair_forces_allpairs_rect``'s, with the leading slab axis."""
    ci, hi, ne_i = sub_boxes(pos_i.unbind(-1), valid_i)
    cj, hj, ne_j = sub_boxes(pos_j.unbind(-1), valid_j)
    keep = cull_keep(cfg, ci[..., :, None], hi[..., :, None],
                     cj[..., None, :], hj[..., None, :])
    return keep & ne_i[:, :, None] & ne_j[:, None, :]


def rect_kept_slot_pairs(keep, valid_i, valid_j) -> int:
    """Pairs of filled slots, over all slabs, in the (i sub-tile, j
    sub-tile) pairs that ``keep`` (``rect_subtile_keep``'s shape) keeps:
    the slot pairs K2's warps test."""
    def per_sub(v):
        v = torch.nn.functional.pad(v.to(torch.int64),
                                    (0, -v.shape[1] % CULL_SUB))
        return v.reshape(v.shape[0], -1, CULL_SUB).sum(-1)

    fi, fj = per_sub(valid_i), per_sub(valid_j)
    return int((keep * fi[:, :, None] * fj[:, None, :]).sum())


def rect_kernel_keep(cfg, ff, pos_i, types_i, valid_i, pos_j, types_j,
                     valid_j, radii_i=None, radii_j=None):
    """``rect_subtile_keep``'s mask as K2's warps took it: one launch of
    the kernel's recording instantiation on CUDA inputs (with the leading
    slab axis).  On the CPU, ``rect_subtile_keep`` itself."""
    if pos_i.device.type == "cpu":
        return rect_subtile_keep(cfg, pos_i, valid_i, pos_j, valid_j)
    L, Ni = pos_i.shape[:2]
    rec = torch.zeros((L, -(-Ni // CULL_SUB), -(-pos_j.shape[1] // CULL_SUB)),
                      dtype=torch.uint8, device=pos_i.device)
    use_radii = bool(cfg.use_radii and radii_i is not None)
    launch_rect(cfg, *kernel_tables(cfg, ff, pos_i.device), pos_i, types_i,
                valid_i, radii_i if use_radii else None, pos_j, types_j,
                valid_j, radii_j if use_radii else None, kept=rec)
    return rec > 0


def _rect_lib():
    lib = cuda_build.load("allpairs_rect")
    fn = lib.aztotmd_allpairs_rect_f32
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 7 + [_F] * 12 + [_P] * 5
        fn.restype = ctypes.c_int
        lib.aztotmd_allpairs_rect_tile.restype = ctypes.c_int
        lib.aztotmd_allpairs_rect_groups.restype = ctypes.c_int
    return lib


def _rect_cuda(cfg, ff, pos_i, types_i, valid_i, radii_i, pos_j, types_j,
               valid_j, radii_j):
    """Check the inputs of the batched rectangular pass and launch it;
    returns its (L, n_split, Ni, 3) force and (L, n_split, Ni) energy
    partial rows."""
    dev = pos_i.device
    if pos_i.dtype != torch.float32:
        raise TypeError("the rectangular CUDA kernel is f32 only; got "
                        f"{pos_i.dtype} (f64 slab steps take the stencil "
                        "pass)")
    if cfg.n_spec > 32:
        raise ValueError(f"the rectangular kernel takes at most 32 species "
                         f"(shared-memory table), got {cfg.n_spec}")
    L, Ni = pos_i.shape[:2]
    Nj = pos_j.shape[1]
    if Ni > Nj:
        raise ValueError(f"the i slots must be the first of the j slots; "
                         f"got Ni={Ni} > Nj={Nj}")
    use_radii = bool(cfg.use_radii and radii_i is not None)
    for side, p, t, v, r, n in (("i", pos_i, types_i, valid_i, radii_i, Ni),
                                ("j", pos_j, types_j, valid_j, radii_j, Nj)):
        check_tensor(f"pos_{side}", p, torch.float32, (L, n, 3), dev)
        check_tensor(f"types_{side}", t, torch.int32, (L, n), dev)
        check_tensor(f"valid_{side}", v, torch.bool, (L, n), dev)
        if use_radii:
            check_tensor(f"radii_{side}", r, torch.float32, (L, n), dev)
    return launch_rect(cfg, *kernel_tables(cfg, ff, dev), pos_i, types_i,
                       valid_i, radii_i if use_radii else None, pos_j,
                       types_j, valid_j, radii_j if use_radii else None)


def launch_rect(cfg, prm, kinds, pos_i, types_i, valid_i, radii_i, pos_j,
                types_j, valid_j, radii_j, kept=None):
    """Launch csrc/allpairs_rect.cu on checked inputs (radii None without
    radii) and return its partial rows.  Counts the launch as K2.  With
    ``kept``, a zeroed (L, ceil(Ni/32), ceil(Nj/32)) uint8 tensor, the
    kernel's recording instantiation also sets the (i sub-tile, j
    sub-tile) entries its warps keep (see ``rect_kernel_keep``)."""
    global rect_launches
    dev = pos_i.device
    L, Ni = pos_i.shape[:2]
    Nj = pos_j.shape[1]
    lib = _rect_lib()
    n_split = rect_split(L, Ni, Nj, lib.aztotmd_allpairs_rect_tile(),
                         lib.aztotmd_allpairs_rect_groups(), sm_count(dev))
    frc_p = torch.empty((L, n_split, Ni, 3), dtype=torch.float32, device=dev)
    ev_p = torch.empty((L, n_split, Ni), dtype=torch.float32, device=dev)
    ec_p = torch.empty((L, n_split, Ni), dtype=torch.float32, device=dev)
    if not (L and Ni):
        return frc_p, ev_p, ec_p
    if kept is not None:
        check_tensor("kept", kept, torch.uint8,
                     (L, -(-Ni // CULL_SUB), -(-Nj // CULL_SUB)), dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = lib.aztotmd_allpairs_rect_f32(
        ptr(pos_i), ptr(types_i), ptr(valid_i), ptr(radii_i), ptr(pos_j),
        ptr(types_j), ptr(valid_j), ptr(radii_j), prm.data_ptr(),
        kinds.data_ptr(), cfg.n_spec, L, Ni, Nj, n_split,
        int(radii_i is not None), int(cfg.elec_type), *kernel_consts(cfg),
        frc_p.data_ptr(), ev_p.data_ptr(), ec_p.data_ptr(), ptr(kept),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rectangular allpairs kernel launch failed: CUDA "
                           f"error {err}")
    rect_launches += 1
    return frc_p, ev_p, ec_p
