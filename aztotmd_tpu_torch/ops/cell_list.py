"""Bucketed cell list (port of the parts of ``aztotmd_tpu/ops/cell_list.py``
that the cell-candidate RDF and the Verlet-list build need).

Atoms are binned into a flat (n_cell * cap,) table of atom ids with one
stable sort; empty slots hold the sentinel ``n_at``, and atoms past a
cell's capacity are dropped and reported through the returned maximum
occupancy.  Each atom's candidates are the slots of its stencil cells.
``build_pos_table`` is the same binning with each slot's position beside
its id.
"""

from __future__ import annotations

import torch

from .consts import const


def cell_coords(cfg, pos):
    """Integer cell coordinates per atom (periodic wrap for robustness
    against slightly out-of-box positions)."""
    g = cfg.grid
    dims = const(g.dims, torch.int32, pos.device)
    scale = const([g.dims[k] / cfg.box[k] for k in range(3)], pos.dtype,
                  pos.device)
    return torch.floor(pos * scale).to(torch.int32) % dims


def cell_ids(cfg, coords):
    _, ncy, ncz = cfg.grid.dims
    return (coords[..., 0] * ncy + coords[..., 1]) * ncz + coords[..., 2]


def _bin_slots(cfg, pos):
    """Sort atoms by cell id and compute each atom's flat table slot
    (cell id * cap + rank in its cell).

    Returns (order (N,) sorted atom ids, slot (N,) scatter targets with
    rank >= cap sent to the drop slot n_cell * cap, max occupancy)."""
    N = cfg.n_at
    grid = cfg.grid
    cap = grid.cap
    cid = cell_ids(cfg, cell_coords(cfg, pos))
    # stable, as jnp.argsort: which atoms a full cell drops depends on it
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(N, dtype=torch.int32, device=pos.device) \
        - first.to(torch.int32)
    slot = torch.where(rank < cap, sorted_cid * cap + rank,
                       grid.n_cell * cap)
    return order, slot, torch.max(rank) + 1


def build_cell_table(cfg, pos):
    """The flat (n_cell * cap,) int32 atom-id table (sentinel ``n_at``)
    and the maximum cell occupancy."""
    N = cfg.n_at
    size = cfg.grid.n_cell * cfg.grid.cap
    order, slot, max_occ = _bin_slots(cfg, pos)
    table = torch.full((size + 1,), N, dtype=torch.int32, device=pos.device)
    table[slot.long()] = order.to(torch.int32)
    return table[:size], max_occ


def stencil_offsets(cfg, device=None):
    """(S, 3) int32 neighbor-cell offsets."""
    return const(cfg.grid.stencil, torch.int32, device)


def stencil_cell_ids(cfg, coords):
    """Flat cell ids of every stencil cell per atom: (N, S) int32."""
    g = cfg.grid
    dims = const(g.dims, torch.int32, coords.device)
    offs = stencil_offsets(cfg, coords.device)
    return cell_ids(cfg, (coords[:, None, :] + offs[None, :, :]) % dims)


def stencil_slot_ids(cfg, coords):
    """(N, S * cap) flat table-slot ids of every stencil cell's slots."""
    cap = cfg.grid.cap
    ncid = stencil_cell_ids(cfg, coords)
    slots = (ncid[:, :, None] * cap
             + torch.arange(cap, dtype=torch.int32,
                            device=coords.device)[None, None, :])
    return slots.reshape(slots.shape[0], -1)


def gather_candidates(cfg, table, coords):
    """(N, S * cap) int32 candidate atom ids per atom (sentinel n_at)."""
    return table[stencil_slot_ids(cfg, coords).long()]


def build_pos_table(cfg, pos):
    """The fused (n_cell * cap, 4) table of (x, y, z, id as a float) rows
    in the slots of ``build_cell_table`` (empty slots: zeros and id
    ``n_at``) and the maximum cell occupancy.  The id round-trips exactly
    through f32 for n_at < 2^24."""
    N = cfg.n_at
    size = cfg.grid.n_cell * cfg.grid.cap
    order, slot, max_occ = _bin_slots(cfg, pos)
    rows = torch.cat([pos[order], order[:, None].to(pos.dtype)], dim=1)
    ptab = torch.zeros((size + 1, 4), dtype=pos.dtype, device=pos.device)
    ptab[:, 3].fill_(float(N))
    ptab[slot.long()] = rows
    return ptab[:size], max_occ
