"""Electron jumps: redox charge transfer between species (port of
``aztotmd_tpu/ops/ejump.py``).

A donor atom hands an electron to an acceptor: the donor becomes its
oxidised form and the acceptor its reduced form.  Candidate pairs come
from the pair pass (the donor's nearest acceptor, ``jump_idx``).  The
energy change dU of a jump is

* with bonds: the per-atom mutation energies over the bonded
  neighbourhood (VdW, Coulomb and bond-energy differences, summed over
  the live bond table);
* without bonds: the environment sweep over all neighbours within the
  cutoff at their current types (VdW and plain-Coulomb differences),
  minus the acceptor-donor term the per-atom sums count twice;

plus the species' own-energy differences and the external-field term.
Acceptance is 'eq' (|dU| < dEjump), 'min' (dU < 0) or Metropolis
(dU < 0 or xi < exp(-dU/kT), with xi from ``ops/jrandom.py``, the
JAX package's draws).  Conflicts resolve as in the JAX package: the
lowest donor wins each acceptor, a claimed atom does not donate, and
donor chains are broken.  Box-edge jump counters are kept along x.
No step of it synchronises with the host.
"""

from __future__ import annotations

import torch

from .. import units
from ..io.control import JUMP_EQ, JUMP_METR, JUMP_MIN
from . import cell_list as cl
from . import jrandom
from .bonds import _evol_bondtype, _min_drop, _set_drop, bond_eval
from .bonds import species_count
from .pairs import min_image
from .vdw import vdw_eval

_BIG = torch.iinfo(torch.int32).max


def _vdw_energy(cfg, ff, t1, t2, r2, r):
    """VdW energy between species t1 and t2 at distance r, within the
    pair's cutoff (no radius-dependent family)."""
    tp = (t1 * cfg.n_spec + t2).long()
    kind = ff.vdw_kind.reshape(-1)[tp]
    p = ff.vdw_p.reshape(-1, 5)[tp]
    r2cut = ff.vdw_r2cut.reshape(-1)[tp]
    kind = torch.where(r2 <= r2cut, kind, torch.zeros_like(kind))
    _, e = vdw_eval(kind, p, r2, r, None, None,
                    families=tuple(f for f in cfg.vdw_families if f != 7))
    return e


def _bond_energy(cfg, ff, bt, r2, r):
    kind = torch.where(bt != 0, ff.bond_kind[bt.long()],
                       torch.zeros_like(bt))
    _, e = bond_eval(kind, ff.bond_p[bt.long()], r2, r, kinds=cfg.bond_kinds)
    return torch.where(bt != 0, e, torch.zeros_like(e))


def _mutation_energies(cfg, ff, state):
    """Per-atom energy change of switching each atom to its ox / red
    form, summed over its bonded neighbourhood."""
    N = cfg.n_at
    types = state.types
    at1, at2, bt = state.bond_at1, state.bond_at2, state.bond_type
    live = bt != 0
    pos = state.pos
    delta = min_image(pos[at1.long()] - pos[at2.long()], cfg)
    r2 = torch.sum(delta * delta, dim=-1)
    r2 = torch.where(live, r2, torch.ones_like(r2))
    r = torch.sqrt(r2)
    t1 = types[at1.long()]
    t2 = types[at2.long()]
    e_cur = _bond_energy(cfg, ff, torch.where(live, bt, torch.zeros_like(bt)),
                         r2, r)
    q = ff.spec_charge
    out = []
    for table in (ff.spec_oxform, ff.spec_redform):
        dU = torch.zeros(N + 1, dtype=pos.dtype, device=pos.device)
        for side in (0, 1):
            me, tme, tnei = (at1, t1, t2) if side == 0 else (at2, t2, t1)
            new_t = table[tme.long()] - 1                # -1 = no form
            ok = live & (new_t >= 0)
            new_safe = torch.clamp(new_t, min=0)
            dvdw = (_vdw_energy(cfg, ff, new_safe, tnei, r2, r)
                    - _vdw_energy(cfg, ff, tme, tnei, r2, r))
            dq = q[new_safe.long()] - q[tme.long()]
            dcoul = cfg.coul_scale * q[tnei.long()] / r * dq
            s1n, s2n = (new_safe, tnei) if side == 0 else (tnei, new_safe)
            nbt = _evol_bondtype(ff, bt, s1n, s2n)
            dbond = _bond_energy(cfg, ff, torch.abs(nbt), r2, r) - e_cur
            contrib = torch.where(ok, dvdw + dcoul + dbond,
                                  torch.zeros_like(r))
            dU = dU.index_add(0, torch.where(ok, me, N).long(), contrib)
        out.append(dU[:N])
    return out[0], out[1]


def env_du_partial(cfg, ff, pos_i, types_i, pos_j, types_j, jmask,
                   self_pairs):
    """Environment-dU sums of the rows (pos_i, types_i) over the columns
    (pos_j, types_j) that ``jmask`` marks live, ``self_pairs`` (N, M)
    marking the same atom: partial (dU_ox, dU_red), summable over
    disjoint column sets."""
    delta = min_image(pos_i[:, None, :] - pos_j[None, :, :], cfg)
    r2 = torch.sum(delta * delta, dim=-1)
    within = jmask[None, :] & ~self_pairs & (r2 <= cfg.r2_max)
    r2s = torch.where(within, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    q = ff.spec_charge
    tj = types_j[None, :].expand(r2.shape)
    out = []
    for table in (ff.spec_oxform, ff.spec_redform):
        new_t = table[types_i.long()] - 1                # -1 = no form
        ok = new_t >= 0
        new_safe = torch.clamp(new_t, min=0)
        dv = (_vdw_energy(cfg, ff, new_safe[:, None], tj, r2s, r)
              - _vdw_energy(cfg, ff, types_i[:, None], tj, r2s, r))
        dq = (q[new_safe.long()] - q[types_i.long()])[:, None]
        dc = cfg.coul_scale * q[tj.long()] / r * dq
        out.append(torch.sum(torch.where(within & ok[:, None], dv + dc,
                                         torch.zeros_like(r)), dim=1))
    return out[0], out[1]


def env_candidates(cfg, pos):
    """(N, M) cell-table candidate list of the environment sweep, the
    pair pass's stencil reach (sentinel N, self excluded).  Positions do
    not change across a step's jump passes, so the step builds it once."""
    N = cfg.n_at
    coords = cl.cell_coords(cfg, pos)
    table, _ = cl.build_cell_table(cfg, pos)
    cand = cl.gather_candidates(cfg, table, coords)
    own = torch.arange(N, dtype=cand.dtype, device=pos.device)[:, None]
    return torch.where(cand == own, N, cand)


def _env_mutation_energies(cfg, ff, state, nbr_idx=None):
    """Environment dU of switching each atom to its ox / red form, over
    its neighbours within r_max at their current types: over the
    candidate list ``nbr_idx`` when given (built from the cell table for
    decks above 8,192 atoms), else over all pairs."""
    N = cfg.n_at
    pos = state.pos
    types = state.types
    dt = pos.dtype
    dev = pos.device
    if nbr_idx is None and N > 8192 and cfg.grid is not None:
        nbr_idx = env_candidates(cfg, pos)
    if nbr_idx is None:
        return env_du_partial(cfg, ff, pos, types, pos, types,
                              torch.ones(N, dtype=torch.bool, device=dev),
                              torch.eye(N, dtype=torch.bool, device=dev))
    pos_p = torch.cat([pos, torch.zeros((1, 3), dtype=dt, device=dev)])
    types_p = torch.cat([types, torch.zeros(1, dtype=types.dtype,
                                            device=dev)])
    q = ff.spec_charge
    M = nbr_idx.shape[1]
    chunk = max(1, int((2 << 30) // max(N * 128 * 4, 1)))
    sums = [torch.zeros(N, dtype=dt, device=dev) for _ in range(2)]
    forms = []
    for table in (ff.spec_oxform, ff.spec_redform):
        new_t = table[types.long()] - 1
        forms.append((new_t >= 0, torch.clamp(new_t, min=0)))
    for i in range(0, M, chunk):
        nb = nbr_idx[:, i:i + chunk].long()
        valid = nb < N
        delta = min_image(pos[:, None, :] - pos_p[nb], cfg)
        tj = types_p[nb]
        r2 = torch.sum(delta * delta, dim=-1)
        within = valid & (r2 <= cfg.r2_max)
        r2s = torch.where(within, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        for k, (ok, new_safe) in enumerate(forms):
            dv = (_vdw_energy(cfg, ff, new_safe[:, None], tj, r2s, r)
                  - _vdw_energy(cfg, ff, types[:, None], tj, r2s, r))
            dq = (q[new_safe.long()] - q[types.long()])[:, None]
            dc = cfg.coul_scale * q[tj.long()] / r * dq
            sums[k] = sums[k] + torch.sum(
                torch.where(within & ok[:, None], dv + dc,
                            torch.zeros_like(r)), dim=1)
    return sums[0], sums[1]


def do_jumps(cfg, ff, state, jump_idx, active=None, nbr_idx=None,
             env_du_fn=None):
    """One pass of electron jumps over the candidates ``jump_idx`` (the
    donor's nearest acceptor, N when none).

    ``active``: optional bool scalar tensor gating the whole pass (the
    rare-jump schedule masks acceptance).  ``nbr_idx``: optional (N, K)
    candidate list for the bond-free environment dU.  ``env_du_fn``:
    optional ``state -> (dU_ox, dU_red)`` replacing the environment
    sweep."""
    N = cfg.n_at
    dt = state.pos.dtype
    dev = state.pos.device
    types = state.types
    tl = types.long()
    me = torch.arange(N, dtype=torch.int32, device=dev)
    da = ff.spec_donacc

    has = ((da[tl] & 1) != 0) & (jump_idx < N)
    if active is not None:
        has = has & active
    acc = torch.clamp(jump_idx, 0, N - 1).long()
    acc_t = types[acc]
    has = has & ((da[acc_t.long()] & 2) != 0)
    ox = ff.spec_oxform[tl] - 1
    red = ff.spec_redform[acc_t.long()] - 1
    has = has & (ox >= 0) & (red >= 0)
    ox = torch.clamp(ox, min=0)
    red = torch.clamp(red, min=0)
    q = ff.spec_charge

    if cfg.use_bnd:
        dU_ox, dU_red = _mutation_energies(cfg, ff, state)
        dU = dU_ox + dU_red[acc]
    else:
        if env_du_fn is not None:
            dU_ox, dU_red = env_du_fn(state)
        else:
            dU_ox, dU_red = _env_mutation_energies(cfg, ff, state, nbr_idx)
        dU = dU_ox + dU_red[acc]
        # the acceptor's sum skips the donor while the donor's keeps the
        # acceptor at its old type: remove the term counted twice
        d_ij = min_image(state.pos - state.pos[acc], cfg)
        r2ij = torch.sum(d_ij * d_ij, dim=-1)
        r2ij = torch.where(has, r2ij, torch.ones_like(r2ij))
        rij = torch.sqrt(r2ij)
        corr = (_vdw_energy(cfg, ff, red, types, r2ij, rij)
                - _vdw_energy(cfg, ff, acc_t, types, r2ij, rij)
                + cfg.coul_scale * q[tl] / rij
                * (q[red.long()] - q[acc_t.long()]))
        dU = dU - torch.where(has, corr, torch.zeros_like(corr))

    # own-energy differences
    e = ff.spec_energy
    dU = dU + (e[ox.long()] - e[tl]) + (e[red.long()] - e[acc_t.long()])

    # external field along x; px = image shift of the acceptor
    ex = cfg.ext_field[0]
    la = cfg.box[0]
    x = state.pos[:, 0]
    xa = state.pos[acc, 0]
    px = torch.round((x - xa) / torch.full((), la, dtype=dt, device=dev))
    if ex != 0.0:
        dU = dU + ex * (x * (q[ox.long()] - q[tl])
                        + (xa + px * la) * (q[red.long()] - q[acc_t.long()]))

    rng = state.rng
    if cfg.ejtype == JUMP_EQ:
        do = (dU > -cfg.d_ejump) & (dU < cfg.d_ejump)
    elif cfg.ejtype == JUMP_MIN:
        do = dU < 0.0
    elif cfg.ejtype == JUMP_METR:
        rng, k = jrandom.split(state.rng)
        xi = jrandom.uniform(k, N, dt)
        kt = units.KB * cfg.temp
        do = (dU < 0.0) | (xi < torch.exp(-torch.clamp(dU / kt, max=50.0)))
    else:
        return state
    do = do & has

    # lowest donor wins each acceptor; a claimed atom does not donate;
    # donor chains (i -> j while j -> k) are broken
    claim = torch.full((N,), _BIG, dtype=torch.int32, device=dev)
    claim = _min_drop(claim, torch.where(do, acc.to(torch.int32), N),
                      torch.where(do, me, torch.full_like(me, _BIG)))
    win = do & (claim[acc] == me) & (claim == _BIG)
    win = win & ~win[acc]

    zero = torch.zeros_like(ox)
    new_types = _set_drop(types, torch.where(win, me, N),
                          torch.where(win, ox, zero))
    new_types = _set_drop(new_types, torch.where(win, acc.to(torch.int32), N),
                          torch.where(win, red, zero))
    touched = _set_drop(state.touched, torch.where(win, me, N), True)
    touched = _set_drop(touched, torch.where(win, acc.to(torch.int32), N),
                        True)

    n_win = torch.sum(win, dtype=torch.int32)
    pos_cross = win & ((px > 0) | ((px == 0) & (xa > x)))
    neg_cross = win & ((px < 0) | ((px == 0) & (xa < x)))
    return state.replace(
        types=new_types, touched=touched, rng=rng,
        n_jump=state.n_jump + n_win,
        jump_pos=state.jump_pos + torch.sum(pos_cross, dtype=torch.int32),
        jump_neg=state.jump_neg + torch.sum(neg_cross, dtype=torch.int32),
        spec_number=species_count(cfg, new_types))
