"""Reactive topology on the slab mesh: replicated tables over sharded
geometry (port of ``aztotmd_tpu/parallel/slab_react.py``, keeping its
names).

Bonds that form, break and mutate, and electron jumps, on the
slab-decomposed step (``parallel/slab.py``):

- the topology (bond and angle tables, per-atom types, parents and bond
  counts, the reactive statistics, the jump counters) is *replicated*: a
  ``ReactiveGlobals`` with no slab axis, like ``SlabState``'s scalars;
- the geometry stays sharded: once a step every slab scatters its atoms'
  positions into a gid-keyed global table and one psum adds the tables
  (``assemble_global``; each atom lives in one slot of one slab, so the
  sum is exact);
- the single-device reactive ops (``ops.bonds.apply_bonds`` and
  ``create_bonds``, ``ops.ejump.do_jumps``, ``ops.angles.refresh_angles``
  and ``apply_angles``) then run unchanged on that replicated view.  They
  are pure functions of replicated inputs, so every rank reaches the
  same decisions: the lowest-slot-wins claims of one device are the
  consensus of the mesh;
- forces go back to the slabs by a gid gather, applied once because each
  gid has one owner.

Over ``LocalRing`` (every slab in one process) the replicated work runs
once for all slabs; over ``DistRing`` every rank runs it.  Candidate
selection is sharded: each slab computes the candidate rows of the slots
it owns against a cell table over the global positions, and a
sentinel-preserving psum merges them.  The environment-dU sweep of the
bond-free jump decks is sharded the same way: each slab contributes its
own slots as neighbour columns.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# MDState fields mirrored into the replicated reactive globals
_FIELDS = (
    "types", "parents", "nbonds", "touched", "spec_number",
    "bond_at1", "bond_at2", "bond_type", "bond_start", "n_bond",
    "bt_count", "bt_lt_sum", "bt_lt_count", "bt_r_sum", "bt_r_count",
    "bt_r_mean", "bt_lt_mean",
    "ang_central", "ang_lig1", "ang_lig2", "ang_type", "n_angle",
    "n_jump", "jump_pos", "jump_neg",
)


@dataclass
class ReactiveGlobals:
    """The replicated topology state, indexed by global atom id (field
    meanings: ``core/state.py``)."""
    types: torch.Tensor        # (N,) int32, the authoritative species
    parents: torch.Tensor      # (N,) int32
    nbonds: torch.Tensor       # (N,) int32
    touched: torch.Tensor      # (N,) bool
    spec_number: torch.Tensor  # (nsp,) int32
    bond_at1: torch.Tensor     # (mxB,) int32 global atom ids
    bond_at2: torch.Tensor
    bond_type: torch.Tensor
    bond_start: torch.Tensor
    n_bond: torch.Tensor
    bt_count: torch.Tensor
    bt_lt_sum: torch.Tensor
    bt_lt_count: torch.Tensor
    bt_r_sum: torch.Tensor
    bt_r_count: torch.Tensor
    bt_r_mean: torch.Tensor
    bt_lt_mean: torch.Tensor
    ang_central: torch.Tensor
    ang_lig1: torch.Tensor
    ang_lig2: torch.Tensor
    ang_type: torch.Tensor
    n_angle: torch.Tensor
    n_jump: torch.Tensor
    jump_pos: torch.Tensor
    jump_neg: torch.Tensor

    def replace(self, **kw) -> "ReactiveGlobals":
        return dataclasses.replace(self, **kw)


def reactive_mode(cfg) -> bool:
    """True when the deck takes the replicated-topology path: reactive
    bonds or angles, or electron jumps (constant-topology decks carry
    per-atom records instead, ``slab._bonded_pass``)."""
    return cfg.use_bnd == 2 or cfg.use_angl == 2 or cfg.ejtype != 0


def make_globals(state) -> ReactiveGlobals:
    """The reactive globals of an MDState (copies, on its device)."""
    return ReactiveGlobals(**{k: getattr(state, k).clone() for k in _FIELDS})


def merge_into_state(state, rg: ReactiveGlobals):
    """Write the reactive globals back into an MDState."""
    return state.replace(**{k: getattr(rg, k) for k in _FIELDS})


class _GlobalView:
    """Duck-typed MDState over the replicated globals and the assembled
    geometry, so the single-device reactive ops run unchanged."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def replace(self, **kw):
        d = dict(self.__dict__)
        d.update(kw)
        return _GlobalView(**d)


def _masked(valid, t):
    """``t`` (L, C, ...) with the slots that ``valid`` does not mark
    zeroed."""
    m = valid.reshape(valid.shape + (1,) * (t.dim() - 2))
    return torch.where(m, t, torch.zeros_like(t))


def assemble_global(comm, n_at: int, gid, valid, arr):
    """The gid-keyed global table of a per-slot tensor ``arr`` (L, C,
    ...): every slab scatters its filled slots and one psum adds the
    tables.  Each gid lives in one slot of one slab, so the sum
    reproduces the values exactly."""
    idx = torch.where(valid, gid.to(torch.int64),
                      torch.full_like(gid, n_at, dtype=torch.int64))
    vals = _masked(valid, arr)
    tab = torch.zeros((n_at + 1,) + tuple(arr.shape[2:]), dtype=arr.dtype,
                      device=arr.device)
    tab[idx.reshape(-1)] = vals.reshape((-1,) + tuple(arr.shape[2:]))
    return comm.allsum(tab[:n_at])


def candidate_rows(cfg, ff, comm, gid, valid, pos, pos_g, types, parents,
                   want_bind, want_jump):
    """Sharded bind/jump candidate selection: the cell table over the
    global positions ``pos_g`` is replicated, the candidate rows are those
    of the slots each slab owns (``gid``, ``valid``, ``pos``: (L, C, ...)),
    and a psum-scatter merges them by gid.  ``types`` and ``parents`` are
    the replicated tables.  Returns (bind_idx, bind_r2, jump_idx), (N,)
    each, sentinel N and r2 inf where an atom has no candidate."""
    from ..ops import cell_list as ops_cl
    from ..ops.pairs import bind_jump_candidates_rows

    N = cfg.n_at
    L, C = valid.shape
    gsafe = torch.clamp(gid, 0, N - 1).long()
    table, _ = ops_cl.build_cell_table(cfg, pos_g)
    row_own = torch.where(valid, gid, torch.full_like(gid, N))
    row_types = _masked(valid, types[gsafe])
    row_parents = torch.where(valid, parents[gsafe], torch.full_like(gid, -1))
    b_i, b_r2, j_i, _ = bind_jump_candidates_rows(
        cfg, ff, table, pos_g, types, parents, pos.reshape(-1, 3),
        row_own.reshape(-1), row_types.reshape(-1), row_parents.reshape(-1),
        want_bind=want_bind, want_jump=want_jump)
    b_i, b_r2, j_i = (t.reshape(L, C) for t in (b_i, b_r2, j_i))
    # a sentinel-preserving merge: scatter idx - N, so that a gid no slab
    # owns (an atom lost to a migration deletion) sums to 0 and lands back
    # on the sentinel N, not on atom 0
    bind_idx = assemble_global(comm, N, gid, valid, b_i - N) + N
    jump_idx = assemble_global(comm, N, gid, valid, j_i - N) + N
    bind_r2 = assemble_global(
        comm, N, gid, valid,
        torch.where(torch.isfinite(b_r2), b_r2, torch.zeros_like(b_r2)))
    bind_r2 = torch.where(bind_idx >= N,
                          torch.full_like(bind_r2, float("inf")), bind_r2)
    return bind_idx, bind_r2, jump_idx


def reactive_pass(cfg, ff, comm, n_at, sd, valid, rg: ReactiveGlobals, rng,
                  step):
    """The single-device reactive schedule on the replicated view, in the
    order of the one-device step around the pair pass: this call runs the
    pre-pair stage (bond forces with repair and mutation) and returns the
    post-pair stages (bond creation, electron jumps, angles) as a
    continuation, so that the caller runs the sharded pair pass and Ewald
    where the one-device step has them.

    ``sd`` holds the per-slot tensors (L, C, ...).  Returns (stage2,
    frc_bond (L, C, 3), e_bond, sd, rg), with ``stage2(rg, rng) ->
    (frc_post (L, C, 3), e_angle, rg, rng)``.
    """
    from ..ops import angles as ops_angles
    from ..ops import bonds as ops_bonds
    from ..ops import ejump as ops_ejump

    N = n_at
    fdt = sd["pos"].dtype
    dev = sd["pos"].device
    gid = sd["gid"]
    L = valid.shape[0]
    gsafe = torch.clamp(gid, 0, N - 1).long()
    zeros3 = lambda: torch.zeros((N, 3), dtype=fdt, device=dev)

    # the authoritative types are the replicated table's; the per-slot
    # types are a cache refreshed after every mutating stage
    sd["types"] = _masked(valid, rg.types[gsafe])

    pos_g = assemble_global(comm, N, gid, valid, sd["pos"])
    need_vel = bool(cfg.use_bnd == 2 and cfg.bond_equil_hack)
    vel_g = (assemble_global(comm, N, gid, valid, sd["vel"]) if need_vel
             else zeros3())

    view = _GlobalView(pos=pos_g, vel=vel_g, frc=zeros3(), rng=rng,
                       step=step, **{k: getattr(rg, k) for k in _FIELDS})
    view = view.replace(touched=torch.zeros(N, dtype=torch.bool,
                                            device=dev))

    # --- bond forces with reactive repair and mutation (pre-pair) ---
    e_bond = torch.zeros((), dtype=fdt, device=dev)
    if cfg.use_bnd:
        view, e_bond = ops_bonds.apply_bonds(cfg, ff, view)
        if need_vel:
            # the equilibration hack zeroes velocities in the global view;
            # mirror it in the slots vel_g was assembled from
            sd["vel"] = _masked(valid, view.vel[gsafe])
    frc_bond = _masked(valid, view.frc[gsafe])
    sd["types"] = _masked(valid, view.types[gsafe])
    rg = ReactiveGlobals(**{k: getattr(view, k) for k in _FIELDS})

    want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
    want_jump = cfg.ejtype != 0
    pos_loc = sd["pos"]

    env_du_fn = None
    if want_jump and not cfg.use_bnd:
        # the bond-free decks' environment dU, sharded: each slab
        # contributes the slots it owns as columns, and a psum of the
        # per-slab partials restores the sums on every rank
        ar = torch.arange(N, dtype=gid.dtype, device=dev)[:, None]

        def env_du_fn(s):
            tj = _masked(valid, s.types[gsafe])
            parts = [ops_ejump.env_du_partial(
                cfg, ff, pos_g, s.types, pos_loc[l], tj[l], valid[l],
                gid[l][None, :] == ar) for l in range(L)]
            return (comm.psum(torch.stack([p[0] for p in parts])),
                    comm.psum(torch.stack([p[1] for p in parts])))

    def stage2(rg2: ReactiveGlobals, rng2):
        """The post-pair stages: create_bonds, jumps, angles."""
        v = _GlobalView(pos=pos_g, vel=vel_g, frc=zeros3(), rng=rng2,
                        step=step, **{k: getattr(rg2, k) for k in _FIELDS})
        if want_bind or want_jump:
            bind_idx, bind_r2, jump_idx = candidate_rows(
                cfg, ff, comm, gid, valid, pos_loc, pos_g, v.types,
                v.parents, want_bind, want_jump)
        if want_bind:
            v = ops_bonds.create_bonds(cfg, ff, v, bind_idx, bind_r2)
        if want_jump:
            f = int(cfg.ejump_freq)
            if f < 0:
                # one pass every |f| steps, its acceptance masked on the
                # device
                v = ops_ejump.do_jumps(cfg, ff, v, jump_idx,
                                       active=(step % (-f)) == 0,
                                       env_du_fn=env_du_fn)
            else:
                for _ in range(max(f, 1)):
                    v = ops_ejump.do_jumps(cfg, ff, v, jump_idx,
                                           env_du_fn=env_du_fn)

        e_angle = torch.zeros((), dtype=fdt, device=dev)
        if cfg.use_angl:
            if cfg.use_angl == 2:
                v = ops_angles.refresh_angles(cfg, ff, v)
            v, e_angle = ops_angles.apply_angles(cfg, ff, v)
        frc_post = _masked(valid, v.frc[gsafe])
        rg2 = ReactiveGlobals(**{k: getattr(v, k) for k in _FIELDS})
        return frc_post, e_angle, rg2, v.rng

    return stage2, frc_bond, e_bond, sd, rg
