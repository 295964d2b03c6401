"""The slab-decomposed MD step with atom migration (port of
``aztotmd_tpu/parallel/slab.py``, keeping its names).

The box is cut into D x-slabs.  Slab s owns the atoms inside it in a
fixed-capacity array of C slots, and one step runs the whole schedule on
every slab:

  [Nose-Hoover] -> verlet-1 (drift + wrap) -> migrate crossers to the
  neighbour slabs (fixed-size buffers) -> [reactive pre-pair stage] ->
  pair pass on the slab and its halos -> [constant bonds and angles] ->
  [Ewald reciprocal space: partial S(k) + one psum] -> [reactive
  post-pair stages] -> verlet-2 -> thermostat -> global scalars by psum.

The step is written once over tensors whose first axis is the local slab
axis L (``SlabState``'s per-slot fields are (L, C, ...)), against a
communicator (``parallel/comm.py``): ``LocalRing`` runs all D slabs in one
process (L = D, batched launches), ``DistRing`` one slab per rank over
``torch.distributed``.  The replicated scalars have no slab axis.

Two pair passes, as in the JAX package: decks on the ``"pallas"`` or
``"sparse"`` engine in f32 that are not reactive take the dense
rectangular pass (``_pair_pass_dense``: the slab's slots against [own;
left; right] slab halos through the K2 kernel,
``ops.allpairs.pair_forces_allpairs_rect``); f64, ``"block"`` and reactive
decks take the cell-block stencil pass (``stencil_pass``, torch ops).  The
radiative thermostat stays trajectory-identical to one device because its
noise is keyed by (seed, step, global atom id).

Topology, as in the JAX package: constant bonds and angles are per-atom
records that migrate with their atoms, evaluated against a gid-keyed
position table of the slab and its two neighbours (``_bonded_pass``);
reactive decks (bonds that form, break and mutate; electron jumps) keep
replicated topology tables beside the sharded geometry
(``parallel/slab_react.py``, ``SlabState.rg``).

Empty-slot invariant: gid == -1 marks a free slot; its pos/vel/frc/engs
are zero and every stage keeps them so.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import _round_up, make_block_grid
from ..core.state import Energies
from ..io.control import ELEC_EWALD, ELEC_NONE, TSTAT_NOSE, TSTAT_RADI
from ..ops import angles as ops_angles
from ..ops import bonds as ops_bonds
from ..ops import integrate as integ
from ..ops import thermostat as tstat
from ..ops.consts import const
from ..ops.allpairs import pair_forces_allpairs_rect
from ..ops.elec import coul_eval, ewald_recip
from ..ops.pairs import MX_FRC, min_image
from ..ops.vdw import vdw_eval
from .slab_react import (ReactiveGlobals, _masked, assemble_global,
                         make_globals, reactive_mode, reactive_pass)


@dataclass
class SlabState:
    """Per-slot tensors of the local slabs, (L, C, ...), and the
    replicated scalars."""
    gid: torch.Tensor          # (L, C) int32 global atom id, -1 = empty
    types: torch.Tensor        # (L, C) int32
    pos: torch.Tensor          # (L, C, 3)
    vel: torch.Tensor
    frc: torch.Tensor
    engs: torch.Tensor         # (L, C) thermal internal energy
    radii: torch.Tensor        # (L, C) thermal radius
    # constant topology, travelling with the atom on migration: each side
    # of a bond holds a record by global partner id, computes the force
    # on itself and half the energy; every participant of an angle holds
    # its record, applies its own share of the force, and the central
    # atom's holder counts the energy (1 wide and empty on reactive and
    # bond-free decks)
    bnd_partner: torch.Tensor  # (L, C, B) int32 partner gid, -1 = empty
    bnd_type: torch.Tensor     # (L, C, B) int32 bond type, 0 = empty
    ang_c: torch.Tensor        # (L, C, A) int32 central gid, -1 = empty
    ang_l1: torch.Tensor
    ang_l2: torch.Tensor
    ang_t: torch.Tensor        # (L, C, A) int32 angle type, 0 = empty

    # --- replicated scalars ---
    rng: torch.Tensor          # (2,) int64 holding uint32 words
    step: torch.Tensor         # () int32
    energies: Energies
    pressure: torch.Tensor
    chit: torch.Tensor
    consint: torch.Tensor
    pos_mom: torch.Tensor      # (3,)
    neg_mom: torch.Tensor
    mom_buf_pos: torch.Tensor
    mom_buf_neg: torch.Tensor
    i_mom: torch.Tensor
    cross_pos: torch.Tensor    # (nsp, 3) int32
    cross_neg: torch.Tensor
    mig_total: torch.Tensor    # () int32 atoms migrated so far
    mig_lost: torch.Tensor     # () int32 atoms deleted (receiver full)
    mig_defer: torch.Tensor    # () int32 sends deferred to a later step
    slab_occ: torch.Tensor     # () int32 fullest cell seen (stencil pass)
    bond_miss: torch.Tensor    # () int32 bond/angle records whose partner
    #                            was outside the +-1-slab position table
    #                            (their forces dropped; the runner warns)
    # reactive decks only: the replicated topology tables
    # (slab_react.ReactiveGlobals); None on the other decks
    rg: ReactiveGlobals | None = None

    def replace(self, **kw) -> "SlabState":
        return dataclasses.replace(self, **kw)


PER_SLOT = ("gid", "types", "pos", "vel", "frc", "engs", "radii",
            "bnd_partner", "bnd_type", "ang_c", "ang_l1", "ang_l2",
            "ang_t")
# empty-slot marker per field
_FILL = {"gid": -1, "bnd_partner": -1, "ang_c": -1, "ang_l1": -1,
         "ang_l2": -1}


def slab_caps(cfg, n_dev: int, cap_factor: float = 1.6):
    """(slot capacity C per slab, migration buffer M per direction)."""
    C = _round_up(int(cfg.n_at / n_dev * cap_factor) + 8, 8)
    M = _round_up(max(8, C // 8), 8)
    return C, M


def max_devices(cfg) -> int:
    """Most slabs a deck takes: each slab at least one cutoff thick, so
    N <= floor(box_x / r_max)."""
    return max(1, int(cfg.box[0] / cfg.r_max))


def check_slab_cfg(cfg, n_dev: int):
    grid = cfg.grid
    if n_dev < 2:
        raise ValueError("slab mode needs >= 2 devices (single-device "
                         "runs use the regular engines)")
    if grid.dims[0] % n_dev:
        raise ValueError(f"ncx={grid.dims[0]} not divisible by {n_dev}")
    if min(grid.dims) < 3 or any(abs(o) > 1 for off in grid.stencil
                                 for o in off):
        raise ValueError("slab decomposition needs a 27-point stencil "
                         "(cell edge >= cutoff, >= 3 cells per axis)")


def prepare_slab_cfg(cfg, n_dev: int):
    """A cfg whose grid satisfies the slab constraints (27-point block
    stencil, ncx divisible by n_dev), with the engine of the slab pair
    pass: "pallas" (the dense rectangular pass) for f32 decks on the
    "pallas" or "sparse" engine that are not reactive, else "block"."""
    grid = cfg.grid
    ok = (grid is not None and min(grid.dims) >= 3
          and not any(abs(o) > 1 for off in grid.stencil for o in off))
    if not ok:
        grid = make_block_grid(cfg.box, cfg.r_max, cfg.n_at)
    ncx = grid.dims[0]
    if ncx % n_dev:
        ncx = max((ncx // n_dev) * n_dev, n_dev)
        if cfg.box[0] / ncx < cfg.r_max:
            raise ValueError(
                f"box x ({cfg.box[0]} A) cannot host {n_dev} slabs of "
                f"cell edge >= {cfg.r_max} A; this deck's 1D-slab "
                f"ceiling is --mesh {max_devices(cfg)} "
                "(see parallel.slab.max_devices)")
        grid = dataclasses.replace(
            grid, dims=(ncx,) + grid.dims[1:],
            edge=(cfg.box[0] / ncx,) + grid.edge[1:])
    engine = "block"
    if (cfg.pair_engine in ("pallas", "sparse") and not reactive_mode(cfg)
            and cfg.dtype != "f64"):
        engine = "pallas"
        n_halo = 2 if n_dev == 2 else 3
        print(f"slab mesh: '{cfg.pair_engine}' deck routed to the "
              f"dense rectangular pair pass "
              f"(>={n_halo * slab_caps(cfg, n_dev)[0] ** 2} slot pairs/"
              f"device/step — lower bound: make_slab_state grows the "
              f"slot cap C to the observed worst-slab occupancy, up to "
              f"C~N on heavily clustered decks — vs ~27*cap^2 = "
              f"{27 * grid.cap ** 2} per cell on the block path)",
              file=sys.stderr)
    cfg = dataclasses.replace(cfg, grid=grid, pair_engine=engine)
    check_slab_cfg(cfg, n_dev)
    return cfg


def _cell_x(cfg, pos, ncx):
    """The cell-x index of every position: floor(pos_x * scale) mod ncx,
    with scale = ncx / box_x divided on the host in f64 and rounded to the
    positions' dtype, as in the JAX package.  make_slab_state, _migrate
    and _pair_pass must agree on it, or a boundary atom lands on a slab
    whose pair pass does not own it."""
    scale = const(ncx / cfg.box[0], pos.dtype, pos.device)
    return torch.floor(pos[..., 0] * scale).to(torch.int32) % ncx


def _topology_records(state, reactive: bool):
    """The per-atom bond and angle records of a constant-topology deck
    from the MDState's global tables, as numpy arrays by atom id: each
    side of a live bond gets a (partner, type) record, each participant
    of an angle the full (c, l1, l2, type) record.  Widths B (the largest
    bond degree) and A (the largest angle participation) are at least 1;
    reactive decks keep 1-wide empty records, so the migration payload
    stays small (their topology is replicated, ``slab_react``)."""
    h = lambda t: t.detach().cpu().numpy()
    N = state.pos.shape[0]
    b_at1, b_at2, b_t = h(state.bond_at1), h(state.bond_at2), \
        h(state.bond_type)
    live_b = (b_t != 0) & (not reactive)
    deg = np.zeros(N, np.int64)
    for a in (b_at1[live_b], b_at2[live_b]):
        np.add.at(deg, a, 1)
    B = max(1, int(deg.max()) if live_b.any() else 1)
    rec = {"bnd_partner": np.full((N, B), -1, np.int32),
           "bnd_type": np.zeros((N, B), np.int32)}
    fill_n = np.zeros(N, np.int64)
    for me, other in ((b_at1, b_at2), (b_at2, b_at1)):
        for k in np.flatnonzero(live_b):
            i = me[k]
            rec["bnd_partner"][i, fill_n[i]] = other[k]
            rec["bnd_type"][i, fill_n[i]] = b_t[k]
            fill_n[i] += 1

    a_c, a_1, a_2, a_t = (h(state.ang_central), h(state.ang_lig1),
                          h(state.ang_lig2), h(state.ang_type))
    live_a = (a_t != 0) & (not reactive)
    dega = np.zeros(N, np.int64)
    for a in (a_c[live_a], a_1[live_a], a_2[live_a]):
        np.add.at(dega, a, 1)
    A = max(1, int(dega.max()) if live_a.any() else 1)
    for k, f in (("ang_c", -1), ("ang_l1", -1), ("ang_l2", -1),
                 ("ang_t", 0)):
        rec[k] = np.full((N, A), f, np.int32)
    fill_n[:] = 0
    for role in (a_c, a_1, a_2):
        for k in np.flatnonzero(live_a):
            i = role[k]
            j = fill_n[i]
            rec["ang_c"][i, j] = a_c[k]
            rec["ang_l1"][i, j] = a_1[k]
            rec["ang_l2"][i, j] = a_2[k]
            rec["ang_t"][i, j] = a_t[k]
            fill_n[i] += 1
    return rec


def make_slab_state(cfg, state, comm, cap_factor: float = 1.6) -> SlabState:
    """Distribute a single-device MDState by x-slab onto the slabs of
    ``comm``: C slots each (grown to the worst slab's occupancy plus
    headroom), atoms in ascending id order within a slab, each with its
    bond and angle records (``_topology_records``); a reactive deck gets
    the replicated topology tables as ``rg``."""
    n_dev = comm.n_dev
    check_slab_cfg(cfg, n_dev)
    C, _ = slab_caps(cfg, n_dev, cap_factor)
    N = cfg.n_at
    ncx = cfg.grid.dims[0]
    nloc = ncx // n_dev
    dev = state.pos.device
    reactive = reactive_mode(cfg)

    dev_of = (_cell_x(cfg, state.pos, ncx) // nloc).cpu().numpy()
    occ0 = int(np.bincount(dev_of, minlength=n_dev).max())
    C = max(C, _round_up(occ0 + occ0 // 8 + 8, 8))

    src = {"pos": state.pos, "vel": state.vel, "frc": state.frc,
           "engs": state.engs, "radii": state.radii, "types": state.types,
           "gid": torch.arange(N, dtype=torch.int32, device=dev)}
    src = {k: v.detach().cpu().numpy() for k, v in src.items()}
    src.update(_topology_records(state, reactive))
    out = {k: np.full((n_dev, C) + a.shape[1:], _FILL.get(k, 0), a.dtype)
           for k, a in src.items()}
    for d in range(n_dev):
        idx = np.flatnonzero(dev_of == d)
        if len(idx) > C:
            raise ValueError(f"slab {d} holds {len(idx)} atoms > "
                             f"capacity {C}; raise cap_factor")
        for k, a in src.items():
            out[k][d, :len(idx)] = a[idx]
    slots = {k: comm.local_slabs(torch.as_tensor(v).to(dev))
             for k, v in out.items()}
    zi = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return SlabState(
        rng=state.rng.clone(), step=state.step.clone(),
        energies=Energies(**{f.name: getattr(state.energies, f.name).clone()
                             for f in dataclasses.fields(Energies)}),
        pressure=state.pressure.clone(), chit=state.chit.clone(),
        consint=state.consint.clone(), pos_mom=state.pos_mom.clone(),
        neg_mom=state.neg_mom.clone(), mom_buf_pos=state.mom_buf_pos.clone(),
        mom_buf_neg=state.mom_buf_neg.clone(), i_mom=state.i_mom.clone(),
        cross_pos=state.cross_pos.clone(), cross_neg=state.cross_neg.clone(),
        mig_total=zi(), mig_lost=zi(), mig_defer=zi(), slab_occ=zi(),
        bond_miss=zi(), rg=make_globals(state) if reactive else None,
        **slots)


GATHER_FIELDS = ("pos", "vel", "frc", "engs", "radii", "types")


def gather_state(sstate: SlabState, n_at: int, comm, fields=GATHER_FIELDS):
    """Host side: the per-atom arrays in global-id order, as a dict of
    numpy arrays (every rank takes part under ``DistRing``)."""
    gid = comm.gather_slabs(sstate.gid).reshape(-1).cpu().numpy()
    live = gid >= 0
    order = gid[live]
    out = {}
    for name in fields:
        a = comm.gather_slabs(getattr(sstate, name))
        a = a.reshape((-1,) + tuple(a.shape[2:])).cpu().numpy()[live]
        full = np.zeros((n_at,) + a.shape[1:], a.dtype)
        full[order] = a
        out[name] = full
    return out


# ----------------------------------------------------------------------
def _rows(t, idx):
    """Rows ``idx`` (L, K) of every slab of ``t`` (L, C, ...)."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


def _migrate(cfg, comm, nloc, M, sd, valid):
    """Send the atoms that crossed a slab boundary to the neighbour slab.

    One hop a step: farther movers stay put and count in n_defer, as do
    senders beyond the M-row buffer.  Receivers fill free slots in order;
    an atom without a free slot is deleted and counts in n_lost.  Returns
    (sd, valid, n_recv, n_lost, n_defer), the counts per local slab."""
    n_dev = comm.n_dev
    pos = sd["pos"]
    L, C = valid.shape
    dev = pos.device
    ncx = nloc * n_dev
    slab = _cell_x(cfg, pos, ncx) // nloc
    delta = (slab - comm.slab_index()[:, None].to(slab.dtype)) % n_dev
    go_r = valid & (delta == 1)
    if n_dev == 2:
        # both neighbours are the same slab: delta == 1 covers both
        # directions, and a left exchange would duplicate every crosser
        go_l = torch.zeros_like(go_r)
    else:
        go_l = valid & (delta == n_dev - 1)
    stray = valid & (delta != 0) & ~go_r & ~go_l
    n_stray = stray.sum(1, dtype=torch.int32)
    ar_m = torch.arange(M, device=dev)

    def pack(go):
        """Senders first (stable) into fixed (L, M, ...) buffers."""
        n_go = go.sum(1, dtype=torch.int32)
        order = torch.argsort((~go).to(torch.int8), dim=1, stable=True)
        rows = order[:, :M]
        sent_ok = ar_m[None, :] < torch.clamp(n_go, max=M)[:, None]
        buf = {}
        for k in PER_SLOT:
            v = _rows(sd[k], rows)
            m = sent_ok.reshape(sent_ok.shape + (1,) * (v.dim() - 2))
            buf[k] = torch.where(m, v, torch.full_like(v, _FILL.get(k, 0)))
        overflow = torch.clamp(n_go - M, min=0)
        sent = torch.zeros((L, C), dtype=torch.bool, device=dev)
        sent[torch.arange(L, device=dev)[:, None], rows] = sent_ok
        return buf, go & sent, overflow

    buf_r, clr_r, ov_r = pack(go_r)
    buf_l, clr_l, ov_l = pack(go_l)
    recv_r = {k: comm.shift_from_left(v) for k, v in buf_r.items()}
    if n_dev == 2:
        recv_l = buf_l              # all empty: nothing goes left
    else:
        recv_l = {k: comm.shift_from_right(v) for k, v in buf_l.items()}
    recv = {k: torch.cat([recv_r[k], recv_l[k]], 1) for k in recv_r}

    # clear the sent slots
    cleared = clr_r | clr_l
    valid = valid & ~cleared
    for k in PER_SLOT:
        v = sd[k]
        m = cleared.reshape(cleared.shape + (1,) * (v.dim() - 2))
        sd[k] = torch.where(m, torch.full_like(v, _FILL.get(k, 0)), v)

    # received atoms into free slots, in order
    rvalid = recv["gid"] >= 0
    rorder = torch.argsort((~rvalid).to(torch.int8), dim=1, stable=True)
    rvalid_s = torch.gather(rvalid, 1, rorder)
    n_recv = rvalid.sum(1, dtype=torch.int32)
    free_first = torch.argsort(valid.to(torch.int8), dim=1, stable=True)
    n_free = (~valid).sum(1, dtype=torch.int32)
    fit = rvalid_s & (torch.arange(2 * M, device=dev)[None, :]
                      < n_free[:, None])
    dest = free_first[:, :2 * M]
    lidx = torch.arange(L, device=dev)[:, None]
    for k in PER_SLOT:
        r = _rows(recv[k], rorder)
        old = sd[k][lidx, dest]
        m = fit.reshape(fit.shape + (1,) * (r.dim() - 2))
        new = sd[k].clone()
        new[lidx, dest] = torch.where(m, r, old)
        sd[k] = new
    valid = sd["gid"] >= 0
    n_lost = torch.clamp(n_recv - n_free, min=0)
    n_defer = ov_r + ov_l + n_stray
    return sd, valid, n_recv, n_lost, n_defer


# ----------------------------------------------------------------------
def _bonded_pass(cfg, ff, comm, sd, valid):
    """Constant bond and angle forces from the per-atom records.

    Each slab builds a gid-keyed position table of its own slots and both
    neighbour slabs' (the shifts of (pos, gid): a bond's reach is at most
    a cell edge, at most a slab's width, so every partner of a slab's atom
    lies within one slab) and evaluates each record on its holder: a bond
    record applies the force on its holder and half the energy (both
    partners hold it); an angle record applies the holder's share of the
    force, and the central atom's holder counts the energy.  Returns
    (frc (L, C, 3), e_bond (L,), e_angle (L,), n_miss (L,)): n_miss
    counts the records whose partner was not in the table (topology
    stretched beyond a slab, its forces dropped; the runner warns)."""
    N = cfg.n_at
    pos, gid = sd["pos"], sd["gid"]
    L = valid.shape[0]
    dt = pos.dtype
    dev = pos.device

    # the tables of the L local slabs, flat: slab l's row g is l*(N+1)+g
    base = (torch.arange(L, device=dev) * (N + 1))[:, None]
    pos_tab = torch.zeros((L * (N + 1), 3), dtype=dt, device=dev)
    present = torch.zeros(L * (N + 1), dtype=torch.bool, device=dev)
    for p, g in ((pos, gid),
                 (comm.shift_from_left(pos), comm.shift_from_left(gid)),
                 (comm.shift_from_right(pos), comm.shift_from_right(gid))):
        idx = (torch.where(g >= 0, g, torch.full_like(g, N)).long()
               + base).reshape(-1)
        pos_tab[idx] = p.reshape(-1, 3)
        present[idx] = (g >= 0).reshape(-1)
    present.reshape(L, N + 1)[:, N].fill_(False)

    def lookup(g, live):
        """(positions, present) of the gids ``g`` (L, C, K) where live."""
        idx = (torch.where(live & (g >= 0), g, torch.full_like(g, N)).long()
               + base[:, :, None])
        return pos_tab[idx], present[idx]

    frc = torch.zeros_like(pos)
    one = torch.ones((), dtype=dt, device=dev)
    e_bond = e_angle = torch.zeros(L, dtype=dt, device=dev)
    n_miss = torch.zeros(L, dtype=torch.int32, device=dev)

    if cfg.use_bnd:
        bp = sd["bnd_partner"]                         # (L, C, B)
        bt = sd["bnd_type"]
        live = (bt != 0) & (bp >= 0) & valid[..., None]
        ppos, ok = lookup(bp, live)
        there = live & ok
        delta = min_image(pos[:, :, None, :] - ppos, cfg)
        r2 = torch.where(there, torch.sum(delta * delta, -1), one)
        r = torch.sqrt(r2)
        kind = torch.where(there, ff.bond_kind[bt.long()],
                           torch.zeros_like(bt))
        f, e = ops_bonds.bond_eval(kind, ff.bond_p[bt.long()], r2, r,
                                   kinds=cfg.bond_kinds)
        f = torch.where(there, f, torch.zeros_like(f))
        frc = frc + torch.sum(f[..., None] * delta, 2)
        e_bond = 0.5 * torch.where(there, e, torch.zeros_like(e)).sum((1, 2))
        n_miss = n_miss + (live & ~ok).sum((1, 2), dtype=torch.int32)

    if cfg.use_angl:
        ac, al1, al2, at_ = (sd["ang_c"], sd["ang_l1"], sd["ang_l2"],
                             sd["ang_t"])                # (L, C, A)
        live = (at_ != 0) & valid[..., None]
        pc, okc = lookup(ac, live)
        p1, ok1 = lookup(al1, live)
        p2, ok2 = lookup(al2, live)
        ok = live & okc & ok1 & ok2
        dij = min_image(p1 - pc, cfg)
        dik = min_image(p2 - pc, cfg)
        r2ij = torch.where(ok, torch.sum(dij * dij, -1), one)
        r2ik = torch.where(ok, torch.sum(dik * dik, -1), one)
        f1, f2, fc, ea = ops_angles.angle_terms(
            dij, dik, r2ij, r2ik, ff.ang_p[at_.long(), 0],
            ff.ang_p[at_.long(), 1])
        g3 = gid[..., None]
        mine = torch.where((g3 == ac)[..., None], fc,
                           torch.where((g3 == al1)[..., None], f1, f2))
        frc = frc + torch.sum(torch.where(ok[..., None], mine,
                                          torch.zeros_like(mine)), 2)
        e_angle = torch.where(ok & (g3 == ac), ea,
                              torch.zeros_like(ea)).sum((1, 2))
        n_miss = n_miss + (live & ~(okc & ok1 & ok2)).sum(
            (1, 2), dtype=torch.int32)

    return frc, e_bond, e_angle, n_miss


# ----------------------------------------------------------------------
def dense_pass_inputs(cfg, comm, sd, valid):
    """The arguments of K2 on a slab state: (pos_i, types_i, valid_i,
    pos_j, types_j, valid_j, radii_i, radii_j), j = [own; left slab;
    right slab].  Cell edge >= cutoff makes the two neighbour slabs a
    superset of every partner in range; the kernel's full-box min-image
    handles the periodic wrap, so halo coordinates are not shifted.  Two
    slabs: left == right, one halo copy only, or every cross-slab pair
    counts twice."""
    pos, types = sd["pos"], sd["types"]
    # empty slots carry radii 0: Surkov's 1/(p2*ra + p3*rb) is inf there
    # and 0 * inf = NaN would survive a masked sum; 1.0 before the halo
    radii = (torch.where(valid, sd["radii"], torch.ones_like(sd["radii"]))
             if cfg.use_radii else None)
    own = (pos, types, valid, radii)
    shifts = ([comm.shift_from_left] if comm.n_dev == 2
              else [comm.shift_from_left, comm.shift_from_right])
    parts = [own] + [tuple(None if a is None else sh(a) for a in own)
                     for sh in shifts]
    cat = lambda q: torch.cat([p[q] for p in parts], 1)
    return (pos, types, valid, cat(0), cat(1), cat(2), radii,
            cat(3) if radii is not None else None)


def _pair_pass_dense(cfg, ff, comm, sd, valid):
    """Dense rectangular pair pass of the dense and clustered decks: the
    forces on each slab's slots from [own; left slab; right slab] through
    K2 (``pair_forces_allpairs_rect``), inputs from
    ``dense_pass_inputs``.  Returns (frc (L, C, 3), e_vdw (L,), e_coul
    (L,), occ (L,) = 0); the energies need the caller's psum."""
    pos_i, types_i, valid_i, pos_j, types_j, valid_j, radii_i, radii_j = \
        dense_pass_inputs(cfg, comm, sd, valid)
    frc, e_vdw, e_coul = pair_forces_allpairs_rect(
        cfg, ff, pos_i, types_i, valid_i, pos_j, types_j, valid_j,
        radii_i=radii_i, radii_j=radii_j)
    frc = torch.where(valid[..., None], frc, torch.zeros_like(frc))
    occ = torch.zeros(valid.shape[0], dtype=torch.int32, device=frc.device)
    return frc, e_vdw, e_coul, occ


def _pair_pass(cfg, ff, comm, sd, valid):
    """The slab step's pair pass: ``_pair_pass_dense`` for decks on the
    dense engine in f32, else ``stencil_pass``."""
    if cfg.pair_engine == "pallas" and cfg.dtype != "f64":
        return _pair_pass_dense(cfg, ff, comm, sd, valid)
    return stencil_pass(cfg, ff, comm, sd, valid)


def stencil_pass(cfg, ff, comm, sd, valid):
    """Bin each slab's atoms (the valid slots inside it) into its cells,
    exchange the boundary cell planes, run the stencil pair pass.
    Returns (frc (L, C, 3), e_vdw (L,), e_coul (L,), occ (L,)): occ is
    the fullest cell; an atom of rank >= cap in its cell gets no pair
    force, and the caller monitors occ against grid.cap.  The energies
    need the caller's psum.  ``parallel/domain.py`` runs it over
    replicated positions."""
    n_dev = comm.n_dev
    grid = cfg.grid
    ncx, ncy, ncz = grid.dims
    cap = grid.cap
    nloc = ncx // n_dev
    pos = sd["pos"]
    types = sd["types"]
    L, C = valid.shape
    dt = pos.dtype
    dev = pos.device
    nsp = cfg.n_spec
    sidx = comm.slab_index()
    x0 = (sidx * nloc)[:, None]

    scale = const([grid.dims[k] / cfg.box[k] for k in range(3)], dt, dev)
    dims = const(grid.dims, torch.int32, dev)
    c = torch.floor(pos * scale).to(torch.int32) % dims
    in_slab = valid & (c[..., 0] >= x0) & (c[..., 0] < x0 + nloc)
    n_cell_loc = nloc * ncy * ncz
    cid = ((c[..., 0] - x0) * ncy + c[..., 1]) * ncz + c[..., 2]
    cid = torch.where(in_slab, cid, torch.full_like(cid, n_cell_loc))
    # one stable sort over every local slab: the slab is the major key, so
    # the sorted array is the slabs' sorted slots one after another
    key = (cid.to(torch.int64)
           + torch.arange(L, device=dev)[:, None] * (n_cell_loc + 1))
    order = torch.argsort(key.reshape(-1), stable=True)
    skey = key.reshape(-1)[order]
    first = torch.searchsorted(skey, skey, right=False)
    rank = torch.arange(L * C, device=dev) - first
    lo = order // C
    scid = skey - lo * (n_cell_loc + 1)
    slot = torch.where((rank < cap) & (scid < n_cell_loc),
                       rank * n_cell_loc + scid,
                       torch.full_like(rank, cap * n_cell_loc))
    occ = torch.where(scid < n_cell_loc, rank + 1,
                      torch.zeros_like(rank)).reshape(L, C).amax(1) \
        .to(torch.int32)

    def blk(vals, fill=0.0):
        out = torch.full((L, cap * n_cell_loc + 1), fill, dtype=vals.dtype,
                         device=dev)
        out[lo, slot] = vals.reshape(-1)[order]
        return out[:, :-1].reshape(L, cap, nloc, ncy, ncz)

    use_radii = bool(cfg.use_radii)
    bx, by, bz = blk(pos[..., 0]), blk(pos[..., 1]), blk(pos[..., 2])
    bv = blk(valid.to(dt))
    bt = blk(types)
    br = blk(sd["radii"]) if use_radii else None

    # --- boundary x-planes of the neighbour slabs ---
    box_x = const(cfg.box[0], dt, dev)
    first_slab = (sidx == 0).reshape(L, 1, 1, 1, 1)
    last_slab = (sidx == n_dev - 1).reshape(L, 1, 1, 1, 1)

    def halo(b, is_x=False):
        from_left = comm.shift_from_left(b[:, :, -1:])
        from_right = comm.shift_from_right(b[:, :, :1])
        if is_x:
            from_left = torch.where(first_slab, from_left - box_x, from_left)
            from_right = torch.where(last_slab, from_right + box_x,
                                     from_right)
        return torch.cat([from_left, b, from_right], 2)

    ex, ey, ez = halo(bx, True), halo(by), halo(bz)
    ev_, et = halo(bv), halo(bt)
    er = halo(br) if use_radii else None

    flat = lambda b: b.reshape(L, cap, -1)
    xi, yi, zi, vi, ti = flat(bx), flat(by), flat(bz), flat(bv), flat(bt)
    ri = flat(br) if use_radii else None

    fx = torch.zeros_like(xi)
    fy = torch.zeros_like(xi)
    fz = torch.zeros_like(xi)
    e_vdw = torch.zeros(L, dtype=dt, device=dev)
    e_coul = torch.zeros(L, dtype=dt, device=dev)
    box = const(cfg.box, dt, dev)
    eye = torch.eye(cap, dtype=torch.bool, device=dev)[None, :, :, None]

    for off in grid.stencil:
        dx_, dy_, dz_ = off

        def nb(e):
            a = e[:, :, 1 + dx_: 1 + dx_ + nloc]
            if dy_:
                a = torch.roll(a, -dy_, 3)
            if dz_:
                a = torch.roll(a, -dz_, 4)
            return a.reshape(L, cap, -1)

        xj, yj, zj = nb(ex), nb(ey), nb(ez)
        vj, tj = nb(ev_), nb(et)
        # pair tiles are (L, cap_i, cap_j, n_cell_loc)
        ddx = xi[:, :, None, :] - xj[:, None, :, :]
        ddy = yi[:, :, None, :] - yj[:, None, :, :]
        ddz = zi[:, :, None, :] - zj[:, None, :, :]
        ddy = ddy - box[1] * torch.round(ddy / box[1])
        ddz = ddz - box[2] * torch.round(ddz / box[2])
        r2 = ddx * ddx + ddy * ddy + ddz * ddz

        mask = (vi[:, :, None, :] * vj[:, None, :, :]) > 0.0
        mask = mask & (r2 <= cfg.r2_max)
        if off == (0, 0, 0):
            mask = mask & ~eye
        r2s = torch.where(mask, r2, torch.ones_like(r2))
        rr = torch.sqrt(r2s)
        zeros = torch.zeros_like(r2s)
        tpair = (ti[:, :, None, :] * nsp + tj[:, None, :, :]).long()

        if cfg.elec_type != ELEC_NONE:
            chp = ff.chprod.reshape(-1)[tpair]
            fc, ecl = coul_eval(cfg, r2s, rr, chp)
            fc = torch.where(mask, fc, zeros)
            ecl = torch.where(mask, ecl, zeros)
        else:
            fc = ecl = zeros

        if cfg.vdw_families:
            kind = ff.vdw_kind.reshape(-1)[tpair]
            vp = ff.vdw_p.reshape(-1, 5)[tpair]
            r2cut = ff.vdw_r2cut.reshape(-1)[tpair]
            vmask = mask & (r2 <= r2cut)
            kind = torch.where(vmask, kind, torch.zeros_like(kind))
            if use_radii:
                rj = nb(er)
                ra = ri[:, :, None, :].expand_as(r2s)
                rb = rj[:, None, :, :].expand_as(r2s)
            else:
                ra = rb = None
            fv, evd = vdw_eval(kind, vp, r2s, rr, ra, rb,
                               families=cfg.vdw_families)
            fv = torch.where(vmask, fv, zeros)
            evd = torch.where(vmask, evd, zeros)
        else:
            fv = evd = zeros

        f = torch.clamp(fc + fv, -MX_FRC, MX_FRC)
        fx = fx + torch.sum(f * ddx, 2)
        fy = fy + torch.sum(f * ddy, 2)
        fz = fz + torch.sum(f * ddz, 2)
        e_vdw = e_vdw + 0.5 * evd.sum((1, 2, 3))
        e_coul = e_coul + 0.5 * ecl.sum((1, 2, 3))

    # back to slot order (each slab owns its atoms: no psum)
    soa = torch.empty(L * C, dtype=torch.int64, device=dev)
    soa[order] = slot
    soa = soa.reshape(L, C)

    def unsort(a):
        a = torch.cat([a.reshape(L, -1), torch.zeros((L, 1), dtype=a.dtype,
                                                     device=dev)], 1)
        return torch.gather(a, 1, soa)

    frc = torch.stack([unsort(fx), unsort(fy), unsort(fz)], -1)
    return frc, e_vdw, e_coul, occ


# ----------------------------------------------------------------------
class _AtomView:
    """Duck-typed mini-state over (flattened) slot tensors, so the
    single-device integrator and thermostat run unchanged."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def replace(self, **kw):
        d = dict(self.__dict__)
        d.update(kw)
        return _AtomView(**d)


def make_slab_step(cfg, aux, comm):
    """step(SlabState, ForceField) -> SlabState over the slabs of
    ``comm``."""
    n_dev = comm.n_dev
    check_slab_cfg(cfg, n_dev)
    nloc = cfg.grid.dims[0] // n_dev
    _, M = slab_caps(cfg, n_dev)
    photons = aux.photons if aux is not None else None
    ewald_rk = aux.rk if aux is not None else None
    ewald_w = aux.kweights if aux is not None else None
    if cfg.elec_type == ELEC_EWALD and ewald_rk is None:
        raise ValueError("Ewald deck needs aux.rk/kweights "
                         "(runtime.setup builds them)")
    reactive = reactive_mode(cfg)

    def step(st: SlabState, ff) -> SlabState:
        valid = st.gid >= 0
        sd = {k: getattr(st, k) for k in PER_SLOT}
        L, C = valid.shape
        fdt = sd["pos"].dtype
        dev = sd["pos"].device
        flat = lambda t: t.reshape((L * C,) + tuple(t.shape[2:]))
        unflat = lambda t: t.reshape((L, C) + tuple(t.shape[1:]))

        # --- [Nose] start-of-step scaling with the previous step's
        # kinetic energy (replicated) ---
        chit, consint = st.chit, st.consint
        if cfg.tstat_type == TSTAT_NOSE:
            v0, _, chit, consint = tstat.nose_apply(
                cfg, sd["vel"], st.energies.kin, chit, consint)
            sd["vel"] = _masked(valid, v0)

        # --- verlet 1 from zeroed accumulators: pure per-slab deltas ---
        nsp = st.cross_pos.shape[0]
        zi3 = torch.zeros((nsp, 3), dtype=torch.int32, device=dev)
        z3 = torch.zeros(3, dtype=fdt, device=dev)
        view = _AtomView(pos=flat(sd["pos"]), vel=flat(sd["vel"]),
                         frc=flat(sd["frc"]), types=flat(sd["types"]),
                         pos_mom=z3, neg_mom=z3, cross_pos=zi3,
                         cross_neg=zi3)
        upd, eng_field = integ.verlet1(cfg, ff, view)
        # empty slots stay all-zero (the external-field reset writes a
        # per-charge constant into every row)
        for k in ("pos", "vel", "frc"):
            sd[k] = _masked(valid, unflat(upd[k]))
        pos_mom = st.pos_mom + comm.allsum(upd["pos_mom"])
        neg_mom = st.neg_mom + comm.allsum(upd["neg_mom"])
        cross_pos = st.cross_pos + comm.allsum(upd["cross_pos"])
        cross_neg = st.cross_neg + comm.allsum(upd["cross_neg"])
        eng_field = comm.allsum(eng_field)

        # --- migration ---
        sd, valid, n_mig, n_lost, n_defer = _migrate(cfg, comm, nloc, M, sd,
                                                     valid)
        mig_total = st.mig_total + comm.psum(n_mig)
        mig_lost = st.mig_lost + comm.psum(n_lost)
        mig_defer = st.mig_defer + comm.psum(n_defer)

        # --- reactive topology, pre-pair stage: bond forces, repair and
        # mutation on the replicated view (the one-device step's order,
        # so type mutations feed the pair pass as there) ---
        rg, rng = st.rg, st.rng
        e_bond = torch.zeros((), dtype=fdt, device=dev)
        e_angle = torch.zeros((), dtype=fdt, device=dev)
        if reactive:
            stage2, frc_b, e_bond, sd, rg = reactive_pass(
                cfg, ff, comm, cfg.n_at, sd, valid, rg, rng, st.step)
            sd["frc"] = sd["frc"] + frc_b

        # --- pair pass on the slab and its halos ---
        pfrc, e_vdw, e_coul, occ = _pair_pass(cfg, ff, comm, sd, valid)
        sd["frc"] = sd["frc"] + pfrc
        e_vdw = comm.psum(e_vdw)
        e_coul = comm.psum(e_coul)
        slab_occ = torch.maximum(st.slab_occ, comm.pmax(occ))

        # --- constant bonds and angles (per-atom records, gid table) ---
        bond_miss = st.bond_miss
        if (cfg.use_bnd or cfg.use_angl) and not reactive:
            bfrc, eb, ea, miss = _bonded_pass(cfg, ff, comm, sd, valid)
            sd["frc"] = sd["frc"] + bfrc
            e_bond = comm.psum(eb).to(fdt)
            e_angle = comm.psum(ea).to(fdt)
            bond_miss = bond_miss + comm.psum(miss)

        # --- Ewald reciprocal space: partial S(k) per slab, one psum ---
        e_coul2 = torch.zeros((), dtype=fdt, device=dev)
        if cfg.elec_type == ELEC_EWALD:
            charge = torch.where(valid, ff.spec_charge[sd["types"].long()],
                                 torch.zeros((), dtype=fdt, device=dev))
            frc_r, e_coul2 = ewald_recip(cfg, flat(sd["pos"]), flat(charge),
                                         ewald_rk, ewald_w,
                                         allsum=comm.allsum)
            sd["frc"] = sd["frc"] + _masked(valid, unflat(frc_r))

        # --- reactive topology, post-pair stages: bond creation, jumps,
        # angles on the replicated view ---
        if reactive:
            frc_post, e_angle, rg, rng = stage2(rg, rng)
            sd["frc"] = sd["frc"] + frc_post
            sd["types"] = _masked(valid, rg.types[
                torch.clamp(sd["gid"], 0, cfg.n_at - 1).long()])
            if cfg.use_bnd:
                rg = ops_bonds.bond_means(cfg, rg)

        # --- verlet 2 (global kinetic energy) ---
        vel, _ = integ.verlet2(cfg, ff, flat(sd["vel"]), flat(sd["frc"]),
                               flat(sd["types"]))
        vel = _masked(valid, unflat(vel))
        mass = ff.spec_mass[sd["types"].long()]
        ekin = 0.5 * torch.sum(torch.where(
            valid, mass * torch.sum(vel * vel, -1), torch.zeros_like(mass)))
        eng_kin = comm.allsum(ekin)
        sd["vel"] = vel

        # --- thermostat ---
        eng_temp = torch.zeros((), dtype=fdt, device=dev)
        # rng was threaded through the reactive pass (Metropolis draws)
        if cfg.n_equil and cfg.freq_equil:
            do_scale = (st.step <= cfg.n_equil) & \
                (st.step % cfg.freq_equil == 0)
            vel_s, ek_s = tstat.temp_scale(cfg, sd["vel"], eng_kin)
            sd["vel"] = torch.where(do_scale, vel_s, sd["vel"])
            eng_kin = torch.where(do_scale, ek_s, eng_kin)
        if cfg.tstat_type == TSTAT_NOSE:
            v2, eng_kin, chit, consint = tstat.nose_apply(
                cfg, sd["vel"], eng_kin, chit, consint)
            sd["vel"] = _masked(valid, v2)
        elif cfg.tstat_type == TSTAT_RADI:
            tview = _AtomView(pos=flat(sd["pos"]), vel=flat(sd["vel"]),
                              engs=flat(sd["engs"]),
                              types=flat(sd["types"]), rng=rng, step=st.step)
            v2, engs, radii, et_loc, rng = tstat.tstat_radiative(
                cfg, ff, tview, photons, gid=flat(sd["gid"]),
                valid=flat(valid))
            sd["vel"] = _masked(valid, unflat(v2))
            sd["engs"] = unflat(engs)
            sd["radii"] = _masked(valid, unflat(radii))
            eng_temp = comm.allsum(et_loc)

        # --- energies and pressure (replicated) ---
        e_coul3 = torch.full((), cfg.eng_ewald_const, dtype=fdt, device=dev)
        pot = e_coul + e_coul2 + e_coul3 + e_vdw + e_bond + e_angle
        energies = Energies(
            kin=eng_kin.to(fdt), vdw=e_vdw.to(fdt), coul1=e_coul.to(fdt),
            coul2=e_coul2.to(fdt), coul3=e_coul3, bond=e_bond,
            angle=e_angle, temp=eng_temp.to(fdt), field=eng_field.to(fdt),
            pot=pot.to(fdt), tot=(pot + eng_kin).to(fdt))
        pview = _AtomView(pos=sd["pos"], i_mom=st.i_mom, step=st.step,
                          pressure=st.pressure, pos_mom=pos_mom,
                          neg_mom=neg_mom, mom_buf_pos=st.mom_buf_pos,
                          mom_buf_neg=st.mom_buf_neg)
        pres, buf_p, buf_n, i_mom = integ.pressure_update(cfg, pview)

        return st.replace(
            energies=energies, pressure=pres, pos_mom=pos_mom,
            neg_mom=neg_mom, mom_buf_pos=buf_p, mom_buf_neg=buf_n,
            i_mom=i_mom, cross_pos=cross_pos, cross_neg=cross_neg,
            mig_total=mig_total, mig_lost=mig_lost, mig_defer=mig_defer,
            slab_occ=slab_occ, bond_miss=bond_miss, rg=rg, rng=rng,
            chit=chit, consint=consint, step=st.step + 1, **sd)

    return step


def make_slab_multi_step(cfg, aux, comm, graph: bool | None = None):
    """multi(st, ff, n) -> the slab state after n steps
    (``runtime.step.MultiStep``).  Over a ``LocalRing`` (every slab on one
    device) ``graph`` is as there: on the card each step is a replay of a
    captured CUDA graph of the slab step.  ``DistRing`` (one slab per
    rank, collectives over torch.distributed) runs eagerly: ``graph=None``
    takes the eager path there and ``graph=True`` raises."""
    from ..runtime.step import MultiStep
    from .comm import LocalRing
    if not isinstance(comm, LocalRing):
        if graph:
            raise NotImplementedError(
                "a CUDA graph of the slab step over DistRing (collectives "
                "across processes) is not ported (ROADMAP.md, queue 1)")
        graph = False
    return MultiStep({"step": make_slab_step(cfg, aux, comm)}, graph)


# ----------------------------------------------------------------------
def make_slab_rdf_sample(cfg, rcfg, comm, spec_nuclei, nucl_number):
    """sample(st, hist, nhist) -> (hist, nhist): one RDF sample on the
    mesh.  Each slab histograms its own rows against the psum-assembled
    global position table and one psum adds the integer counts, which
    equal the one-device histogram's exactly.  The size gate is the
    one-device sample's: past the RDF grid's candidate row the rows go
    through the cell candidates."""
    from ..ops import rdf as ops_rdf
    N = cfg.n_at
    nsp = cfg.n_spec
    use_cells = N > len(rcfg.grid.stencil) * rcfg.grid.cap

    def sample(st, hist, nhist):
        valid = st.gid >= 0
        gid = torch.where(valid, st.gid, torch.full_like(st.gid, -1))
        pos_g = assemble_global(comm, N, st.gid, valid, st.pos)
        types_g = assemble_global(comm, N, st.gid, valid, st.types)
        rows = (st.pos.reshape(-1, 3), gid.reshape(-1),
                st.types.reshape(-1))
        fn = (ops_rdf.rdf_counts_rows_cells if use_cells
              else ops_rdf.rdf_counts_rows)
        counts = comm.allsum(fn(cfg, rcfg, *rows, pos_g, types_g))
        # live species counts from the filled slots
        sp = torch.arange(nsp, dtype=torch.int32, device=st.pos.device)
        spec_number = comm.allsum(
            (valid[..., None] & (st.types[..., None] == sp))
            .sum((0, 1), dtype=torch.int32))
        return ops_rdf._apply_weights(cfg, rcfg, counts, spec_number,
                                      spec_nuclei, nucl_number, hist, nhist)

    return sample


# ----------------------------------------------------------------------
# the slab health monitors, in the stat row's first over slots
SLAB_OVER_KEYS = ("slab_occ", "mig_lost", "mig_defer", "bond_miss")


def _make_local_stat_row(cfg, spec_counts0, pos0, comm):
    """stat_row(st) -> (frow float32, irow int32) of a slab state over
    ``comm``, in the layout of ``runtime.statring.make_stat_row``, so the
    runner decodes both alike.  The per-atom reductions (displacement MSD
    from the replicated pos0 table keyed by gid, x1 of global atom 0,
    live species counts, the constant-topology bond count as
    (records + 1) // 2) are per-slab partials and one psum.  The int
    row's "over" slots carry the slab health monitors [slab_occ,
    mig_lost, mig_defer, bond_miss, 0, 0, 0] instead of the one-device
    capacity monitors (the runner decodes per mode)."""
    from ..runtime.statring import pack_rows

    N = cfg.n_at
    nsp = cfg.n_spec
    counts = np.maximum(np.asarray(spec_counts0), 1).astype(np.float32)
    counts = [float(c) for c in counts]
    box = [float(b) for b in cfg.box]
    pos0_h = np.asarray(pos0)
    reactive = reactive_mode(cfg)
    nbt = max(cfg.n_bond_types, 1)
    # the replicated pos0 table on the device, built at the first call
    # (before a capture), per dtype
    tables = {}

    def stat_row(st: SlabState):
        E = st.energies
        dt, dev = st.pos.dtype, st.pos.device
        key = (dt, dev)
        if key not in tables:
            tables[key] = torch.as_tensor(pos0_h).to(device=dev, dtype=dt)
        i32 = torch.int32
        valid = st.gid >= 0
        gsafe = st.gid.clamp(0, N - 1).to(torch.int64)
        # per-species mean |r(t)-r(0)|^2, minimum image
        d = st.pos - tables[key][gsafe]
        bx = const(box, dt, dev)
        d = d - bx * torch.round(d / bx)
        r2 = torch.where(valid, torch.sum(d * d, dim=-1),
                         torch.zeros((), dtype=dt, device=dev))
        sp = torch.arange(nsp, dtype=i32, device=dev)
        live = valid[..., None] & (st.types[..., None] == sp)
        oh = live.to(dt)
        msd = comm.psum((r2[..., None] * oh).sum(1)).to(torch.float32) \
            / const(counts, torch.float32, dev)
        # x1 = x of global atom 0 (owned by exactly one slot mesh-wide)
        x1 = comm.psum(torch.where(
            st.gid == 0, st.pos[..., 0],
            torch.zeros((), dtype=dt, device=dev)).sum(1))
        zero = torch.zeros((1,), dtype=i32, device=dev)
        if reactive:
            rg = st.rg
            spec_number, n_bond = rg.spec_number, rg.n_bond
            bt_count, bt_r, bt_lt = rg.bt_count, rg.bt_r_mean, rg.bt_lt_mean
            n_jump, j_pos, j_neg = rg.n_jump, rg.jump_pos, rg.jump_neg
        else:
            spec_number = comm.psum(live.sum(1, dtype=i32))
            n_bond = zero
            if cfg.use_bnd:
                # each side of a bond holds a record
                rec = (valid[..., None] & (st.bnd_type != 0)).sum(
                    (1, 2), dtype=i32)
                n_bond = (comm.psum(rec) + 1) // 2
            bt_count = torch.zeros((nbt,), dtype=i32, device=dev)
            bt_r = bt_lt = torch.zeros((nbt,), dtype=torch.float32,
                                       device=dev)
            n_jump = j_pos = j_neg = zero
        return pack_rows(
            E, st.pos_mom, st.neg_mom, st.pressure, x1, msd, bt_r, bt_lt,
            st.step, spec_number, st.cross_pos, st.cross_neg, n_bond, n_jump,
            j_pos, j_neg, [getattr(st, k) for k in SLAB_OVER_KEYS]
            + [zero] * 3, bt_count)

    return stat_row


def make_slab_ring(cfg, aux, comm, rcfg, spec_nuclei, nucl_number,
                   p_stat: int, p_rdf: int, spec_counts0, pos0, multi=None,
                   sample=None, cap: int = 512):
    """The slab mesh's stat ring: ring(st, h, nh, ff, n_samples) ->
    (st, h, nh, frows, irows) runs ``n_samples`` stat periods of the slab
    step, with an RDF sample on the mesh after every ``p_rdf`` steps
    (``p_rdf`` 0 or ``rcfg`` None: none), and writes one stat row a period
    (``_make_local_stat_row``) into a device ring of ``cap`` rows
    (``runtime.statring.RowRing``); frows and irows are its first
    ``n_samples`` rows, valid until the next call.  Over a ``LocalRing``
    the step, the row and the ring's reset are replays of captured CUDA
    graphs on the card (as ``make_slab_multi_step``'s step); over
    ``DistRing`` they run eagerly.  ``multi`` (a slab ``MultiStep``) and
    ``sample`` are shared with the caller's programs where given;
    ``ring.multi`` holds the step, "row" and "ring_reset" programs."""
    from ..runtime.graph import GraphedSample
    from ..runtime.statring import RowRing, make_layout
    from ..runtime.step import MultiStep

    check_slab_cfg(cfg, comm.n_dev)
    fuse_rdf = rcfg is not None and p_rdf > 0
    if fuse_rdf and p_stat % p_rdf:
        raise ValueError("mesh ring needs p_rdf | p_stat")
    if multi is None:
        multi = make_slab_multi_step(cfg, aux, comm)
    _, nf, _, ni = make_layout(cfg.n_spec, max(cfg.n_bond_types, 1))
    rows = RowRing(nf, ni, cap, comm.device)
    multi = MultiStep(dict(multi.fns, row=rows.program(
        _make_local_stat_row(cfg, spec_counts0, pos0, comm)),
        ring_reset=rows.reset), multi.graph)
    if fuse_rdf and sample is None:
        sample = GraphedSample(
            make_slab_rdf_sample(cfg, rcfg, comm, spec_nuclei, nucl_number),
            "mesh RDF sample", multi.graph)

    def ring(st, h, nh, ff, n_samples: int):
        run, current = multi.start(st, ff)
        run("ring_reset")
        for _ in range(n_samples):
            if fuse_rdf:
                for _ in range(p_stat // p_rdf):
                    run("step", p_rdf)
                    h, nh = sample(current(), h, nh)
            else:
                run("step", p_stat)
            run("row")
        frows, irows = rows.rows(n_samples)
        return current(), h, nh, frows, irows

    ring.multi, ring.sample, ring.rows = multi, sample, rows
    return ring
