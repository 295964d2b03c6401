"""Velocity-Verlet integration with periodic wrap and wall-momentum
pressure bookkeeping (port of ``aztotmd_tpu/ops/integrate.py``)."""

from __future__ import annotations

import torch

from .consts import const


def verlet1(cfg, ff, state):
    """First half-kick, drift, periodic wrap (with per-species crossing
    counters and wall momenta) and force reset.

    Returns (dict of state fields to merge, eng_field).
    """
    dt = state.pos.dtype
    dev = state.pos.device
    types = state.types.long()
    rm_hdt = ff.spec_rmass_hdt[types][:, None]
    mass = ff.spec_mass[types]
    frozen = (ff.spec_frozen[types] > 0)[:, None]

    vel = state.vel + rm_hdt * state.frc
    pos = torch.where(frozen, state.pos, state.pos + vel * cfg.dt)

    # periodic wrap: whole-box crossings, then the pos >= box guard
    box = const(cfg.box, dt, dev)
    n = torch.floor(pos / box)
    pos = pos - n * box
    pos = torch.where(pos >= box, torch.zeros_like(pos), pos)

    ni = n.to(torch.int32)
    mom = mass[:, None] * vel
    zero = torch.zeros_like(mom)
    pos_mom = state.pos_mom + torch.sum(torch.where(ni > 0, mom, zero), 0)
    neg_mom = state.neg_mom + torch.sum(torch.where(ni < 0, -mom, zero), 0)
    # per-species crossing counters (feed msd.dat)
    nsp = state.cross_pos.shape[0]
    onehot = types[:, None, None] == torch.arange(nsp, device=dev)[None, :,
                                                                    None]
    dpos = torch.sum(onehot & (ni > 0)[:, None, :], 0, dtype=torch.int32)
    dneg = torch.sum(onehot & (ni < 0)[:, None, :], 0, dtype=torch.int32)
    cross_pos = state.cross_pos + dpos
    cross_neg = state.cross_neg + dneg

    # external electric field: E = -grad U; eng = q (r . dU/dr)
    charge = ff.spec_charge[types]
    if any(v != 0.0 for v in cfg.ext_field):
        ext = const(cfg.ext_field, dt, dev)
        eng_field = torch.sum(charge * (pos @ ext))
        frc = (-charge[:, None] * ext).expand_as(pos).clone()
    else:
        eng_field = torch.zeros((), dtype=dt, device=dev)
        frc = torch.zeros_like(pos)

    # shiftX directive: constant z-force on atoms beyond the x threshold
    if cfg.shift_x != 0.0 or cfg.shift_val != 0.0:
        frc[:, 2] = torch.where(pos[:, 0] > cfg.shift_x,
                                torch.full_like(pos[:, 0], cfg.shift_val),
                                frc[:, 2])

    return dict(pos=pos, vel=vel, frc=frc, pos_mom=pos_mom, neg_mom=neg_mom,
                cross_pos=cross_pos, cross_neg=cross_neg), eng_field


def verlet2(cfg, ff, vel, frc, types):
    """Second half-kick; returns (vel, eng_kin)."""
    types = types.long()
    vel = vel + ff.spec_rmass_hdt[types][:, None] * frc
    mass = ff.spec_mass[types]
    eng_kin = 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1))
    return vel, eng_kin


def pressure_update(cfg, state):
    """Pressure from the wall-momentum ring buffer: P = dM/dt / area over
    the last (n_mom - 1) samples and all six walls.  During warm-up the
    slot is the step number, and a write past the ring is dropped (as
    JAX's ``.at[slot].set(mode="drop")``), never clamped."""
    dt_ = state.pos.dtype
    dev = state.pos.device
    i = state.i_mom.long()
    n_mom = cfg.n_mom
    step = state.step.long()
    la, lb, lc = cfg.box
    rev_area = const([1.0 / (lb * lc), 1.0 / (la * lc), 1.0 / (la * lb)],
                     dt_, dev)
    k = 2.0 * 1.58e6 / (cfg.dt * (n_mom - 1))

    w = step >= n_mom - 1                        # steady regime?
    j = torch.where(i - 1 < 0, torch.full_like(i, n_mom - 1), i - 1)
    slot = torch.where(w, j, step)               # warm-up writes at `step`
    in_ring = (slot >= 0) & (slot < n_mom)
    rows = torch.arange(n_mom, device=dev)
    hit = ((rows == slot) & in_ring)[:, None]
    buf_p = torch.where(hit, state.pos_mom[None, :], state.mom_buf_pos)
    buf_n = torch.where(hit, state.neg_mom[None, :], state.mom_buf_neg)
    # index_select keeps the device index on the device (no host sync)
    i1 = i.reshape(1)
    pp = k * (state.pos_mom - state.mom_buf_pos.index_select(0, i1)[0]) \
        * rev_area
    pn = k * (state.neg_mom - state.mom_buf_neg.index_select(0, i1)[0]) \
        * rev_area
    pres = torch.where(w, (torch.sum(pp) + torch.sum(pn)) / 6.0,
                       state.pressure)
    i_next = torch.where(w, torch.where(i + 1 >= n_mom,
                                        torch.zeros_like(i), i + 1), i)
    return pres, buf_p, buf_n, i_next.to(torch.int32)
