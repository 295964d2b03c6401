"""Valence angles (port of ``aztotmd_tpu/ops/angles.py``): harmonic-cosine
forces over the angle table (type 0 = empty slot), and for
``use_angl == 2`` the rebuild of the angles centred on atoms whose type
or topology changed this step from the live bond table.

Forces are added with ``index_add`` (the JAX package's ``.at[].add``),
and ``.at[i].set(v, mode="drop")`` is ``bonds._set_drop``.  No function
synchronises with the host.
"""

from __future__ import annotations

import torch

from .bonds import _set_drop
from .pairs import min_image

MAX_BOND_NEI = 8        # partners kept per atom (the reference's nei[8])


def angle_terms(dij, dik, r2ij, r2ik, k, cos0):
    """The harmonic-cosine law of one angle on each entry of a batch:
    ligand vectors ``dij``, ``dik`` (..., 3) from the central atom, their
    squared lengths (1 where the angle is not live), the constants ``k``
    and ``cos0``.  Returns (f1, f2, fc, e): the forces on the two ligands
    and on the central atom, and the energy."""
    rij = torch.sqrt(r2ij)
    rik = torch.sqrt(r2ik)
    cos_th = torch.sum(dij * dik, dim=-1) / (rij * rik)
    dcos = cos_th - cos0
    c1 = -k * dcos
    c2 = 1.0 / (rij * rik)

    f1 = c1[..., None] * (dik * c2[..., None]
                          - cos_th[..., None] * dij / r2ij[..., None])
    f2 = c1[..., None] * (dij * c2[..., None]
                          - cos_th[..., None] * dik / r2ik[..., None])
    fc = -(f1 + f2)
    return f1, f2, fc, 0.5 * k * dcos * dcos


def apply_angles(cfg, ff, state):
    """Angle forces added to ``state.frc`` and the angle energy:
    (state, eng_angle)."""
    c, l1, l2, at = (state.ang_central.long(), state.ang_lig1.long(),
                     state.ang_lig2.long(), state.ang_type.long())
    live = at != 0
    pos = state.pos
    one = torch.ones((), dtype=pos.dtype, device=pos.device)

    dij = min_image(pos[l1] - pos[c], cfg)
    dik = min_image(pos[l2] - pos[c], cfg)
    r2ij = torch.where(live, torch.sum(dij * dij, dim=-1), one)
    r2ik = torch.where(live, torch.sum(dik * dik, dim=-1), one)
    f1, f2, fc, e = angle_terms(dij, dik, r2ij, r2ik, ff.ang_p[at, 0],
                                ff.ang_p[at, 1])
    lv = live[:, None]
    f1 = torch.where(lv, f1, torch.zeros_like(f1))
    f2 = torch.where(lv, f2, torch.zeros_like(f2))
    fc = torch.where(lv, fc, torch.zeros_like(fc))

    frc = state.frc.index_add(0, c, fc).index_add(0, l1, f1) \
        .index_add(0, l2, f2)
    eng = torch.sum(torch.where(live, e, torch.zeros_like(e)))
    return state.replace(frc=frc), eng


def refresh_angles(cfg, ff, state):
    """Rebuild the angles of touched atoms from the live bond table: drop
    the angles centred on a touched atom, compact the survivors in order,
    and append every ligand pair of each touched atom whose species forms
    angles and which has two or more bonds."""
    N = cfg.n_at
    mxA = state.ang_type.shape[0]
    dev = state.pos.device
    touched = state.touched

    keep = (state.ang_type != 0) & ~touched[state.ang_central.long()]
    at = torch.where(keep, state.ang_type, torch.zeros_like(state.ang_type))

    nb = _bond_neighbors(cfg, state)

    t_ang = ff.spec_angle_type[state.types.long()]           # (N,)
    make = touched & (t_ang != 0) & (state.nbonds > 1)
    pairs = [(i, j) for i in range(MAX_BOND_NEI - 1)
             for j in range(i + 1, MAX_BOND_NEI)]
    li = nb[:, [p[0] for p in pairs]]                        # (N, P)
    lj = nb[:, [p[1] for p in pairs]]
    cand_ok = make[:, None] & (li < N) & (lj < N)

    dest = torch.cumsum(keep.to(torch.int32), dim=0) - 1
    dest = torch.where(keep, dest, mxA)
    n_keep = torch.sum(keep, dtype=torch.int32)

    def mv(a):
        return _set_drop(torch.zeros_like(a), dest, a)

    ang_c = mv(state.ang_central)
    ang_1 = mv(state.ang_lig1)
    ang_2 = mv(state.ang_lig2)
    ang_t = mv(at)

    flat_ok = cand_ok.reshape(-1)
    rank = torch.cumsum(flat_ok.to(torch.int32), dim=0) - 1
    slot = torch.where(flat_ok, torch.clamp(n_keep + rank, max=mxA), mxA)
    centr = torch.arange(N, dtype=torch.int32, device=dev)[:, None] \
        .expand(cand_ok.shape).reshape(-1)
    t_rows = t_ang[:, None].expand(cand_ok.shape).reshape(-1)
    # the candidates land on distinct slots after the survivors; the
    # rest, and those past the capacity, share the slot mxA, cut off
    ang_c = _set_drop(ang_c, slot, centr)
    ang_1 = _set_drop(ang_1, slot, li.reshape(-1))
    ang_2 = _set_drop(ang_2, slot, lj.reshape(-1))
    ang_t = _set_drop(ang_t, slot, t_rows)

    n_angle = torch.clamp(n_keep + torch.sum(flat_ok, dtype=torch.int32),
                          max=mxA)
    return state.replace(ang_central=ang_c, ang_lig1=ang_1, ang_lig2=ang_2,
                         ang_type=ang_t, n_angle=n_angle)


def _bond_neighbors(cfg, state):
    """(N, MAX_BOND_NEI) bonded partners from the live bond table,
    sentinel N, in the order of a stable sort of the bond ends."""
    N = cfg.n_at
    at1, at2, bt = state.bond_at1, state.bond_at2, state.bond_type
    live = bt != 0
    ends = torch.cat([torch.where(live, at1, N), torch.where(live, at2, N)])
    partners = torch.cat([at2, at1])
    order = torch.argsort(ends, stable=True)
    se = ends[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(se.shape[0], dtype=torch.int32,
                        device=se.device) - first.to(torch.int32)
    ok = (se < N) & (rank < MAX_BOND_NEI)
    slot = torch.where(ok, se * MAX_BOND_NEI + rank, N * MAX_BOND_NEI)
    nb = torch.full((N * MAX_BOND_NEI + 1,), N, dtype=torch.int32,
                    device=se.device)
    nb[slot.long()] = partners[order].to(torch.int32)
    return nb[:N * MAX_BOND_NEI].reshape(N, MAX_BOND_NEI)
