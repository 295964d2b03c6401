"""Bonds: constant and reactive (port of ``aztotmd_tpu/ops/bonds.py``).

Bond forces over the fixed-capacity bond table (type 0 = empty slot), and
for reactive decks (``use_bnd == 2``): orientation and type repair after
atom-type changes, the min/max length triggers that mutate or break a
bond, a lowest-slot-wins claim so each atom takes part in one mutation
per step, lifetime, count and length statistics, and bond creation from
the pair pass's bind candidates (a lowest-proposer-wins claim on both
ends, appended after the live bonds).  ``nbonds``, ``parents`` and the
species counts are recomputed from the live table after every topology
change.

Every step is tensor code with no host synchronisation: counts, claims
and the appended slots stay on the device.  JAX's ``.at[i].set/.min``
with the out-of-range index N ("drop") is a scatter into an (N+1)-long
buffer whose last element is then cut off (``_set_drop``,
``_min_drop``).
"""

from __future__ import annotations

import torch

from ..io.field import (BOND_BUCK, BOND_E612, BOND_HARM, BOND_MORSE,
                        BOND_PEDONE)
from .pairs import min_image

_BIG = torch.iinfo(torch.int32).max


def _set_drop(a, idx, val):
    """``a.at[idx].set(val, mode="drop")`` for idx in [0, len(a)]."""
    n = a.shape[0]
    buf = torch.cat([a, a[:1]])
    if torch.is_tensor(val):
        val = val.to(a.dtype).expand(idx.shape)
    else:
        # a fill, not a copy of host data
        val = torch.full(idx.shape, val, dtype=a.dtype, device=a.device)
    buf.index_put_((idx.long(),), val)
    return buf[:n]


def _min_drop(a, idx, val):
    """``a.at[idx].min(val, mode="drop")`` for idx in [0, len(a)]."""
    n = a.shape[0]
    buf = torch.cat([a, a[:1]])
    return buf.scatter_reduce(0, idx.long(), val, "amin")[:n]


def _add(a, idx, val):
    """``a.at[idx].add(val)`` (idx in range)."""
    return a.index_add(0, idx.long(), val.to(a.dtype))


def bond_eval(kind, p, r2, r, kinds=()):
    """Bond force-over-r and energy, masked multi-family evaluation."""
    f = torch.zeros_like(r2)
    e = torch.zeros_like(r2)
    p0, p1, p2, p3, p4 = (p[..., k] for k in range(5))
    one = torch.ones_like(p1)
    for fam in kinds:
        m = kind == fam
        if fam == BOND_HARM:
            x = r - p1
            ee = 0.5 * p0 * x * x
            ff = -p0 / r * x
        elif fam == BOND_MORSE:
            x = torch.exp(-p1 * (r - p2))
            y = 1.0 - x
            ee = p0 * y * y - p3
            ff = -2.0 * p0 * p1 * x * y / r
        elif fam == BOND_PEDONE:
            x = torch.exp(-p1 * (r - p2))
            y = 1.0 - x
            ir2 = 1.0 / r2
            ir12 = (ir2 * ir2) ** 3
            ee = p0 * y * y - p3 - p4 * ir12
            ff = -2.0 * p0 * p1 * x * y / r - 12.0 * p4 * ir12 * ir2
        elif fam == BOND_BUCK:
            ir2 = 1.0 / r2
            ir4 = ir2 * ir2
            ro = torch.where(m, p1, one)
            ex = torch.exp(-r / ro)
            ee = p0 * ex - p2 * ir4 * ir2
            ff = p0 * ex / (r * ro) - 6.0 * p2 * ir4 * ir4
        elif fam == BOND_E612:
            ir2 = 1.0 / r2
            ir4 = ir2 * ir2
            ro = torch.where(m, p1, one)
            ex = torch.exp(-r / ro)
            ee = (p0 * ex - p2 * ir4 * ir2 - p3 * ir4 * ir4
                  - p4 * ir4 * ir4 * ir4)
            ff = (p0 * ex / (r * ro) - 6.0 * p2 * ir4 * ir4
                  - 8.0 * p3 * ir4 * ir4 * ir2
                  - 12.0 * p4 * ir4 * ir4 * ir4 * ir2)
        else:
            continue
        f = torch.where(m, ff, f)
        e = torch.where(m, ee, e)
    return f, e


def bond_energy_only(ff, cfg, bt, r2, r):
    """Energy of bond type bt at distance r (0 for type 0)."""
    _, e = bond_eval(ff.bond_kind[bt.long()], ff.bond_p[bt.long()], r2, r,
                     kinds=cfg.bond_kinds)
    return torch.where(bt > 0, e, torch.zeros_like(e))


def _evol_bondtype(ff, bt, s1, s2):
    """New signed bond type when the atom types become (s1, s2): the
    bond type's 'evol' type if its species match (negative if reversed),
    else the species pair's default bond."""
    nsp = ff.def_bond.shape[0]
    ev = ff.bond_evol[bt.long()]
    ev_s1 = ff.bond_spec1[ev.long()]
    ev_s2 = ff.bond_spec2[ev.long()]
    by_matrix = ff.def_bond.reshape(-1)[(s1 * nsp + s2).long()]
    return torch.where(
        ev != 0,
        torch.where((s1 == ev_s1) & (s2 == ev_s2), ev,
                    torch.where((s1 == ev_s2) & (s2 == ev_s1), -ev,
                                by_matrix)),
        by_matrix)


def refresh_derived(cfg, ff, state):
    """Recompute nbonds, parents and the per-species counts from the live
    bond table and the types."""
    N = cfg.n_at
    at1, at2, bt = state.bond_at1, state.bond_at2, state.bond_type
    mxB = at1.shape[0]
    if mxB * (N + 1) > _BIG:
        raise ValueError(f"parent key slot*(N+1) leaves int32 at "
                         f"{mxB} bond slots and {N} atoms")
    live = bt != 0
    hat = ff.bond_hatom[bt.long()]                   # -1 covalent
    t1 = state.types[at1.long()]
    t2 = state.types[at2.long()]
    # an endpoint counts the bond unless the other end is the H atom of
    # an H-bond
    inc1 = (live & (hat != t2)).to(torch.int32)
    inc2 = (live & (hat != t1)).to(torch.int32)
    zi = torch.zeros(N, dtype=torch.int32, device=bt.device)
    nbonds = _add(_add(zi, at1, inc1), at2, inc2)

    # parent: the partner of the lowest-slot live bond; an H-bond parents
    # only its H atom
    key = torch.arange(mxB, dtype=torch.int32, device=bt.device) * (N + 1)
    p1_ok = live & ((hat == -1) | (hat == t1))       # at1 gets parent at2
    p2_ok = live & ((hat == -1) | (hat == t2))
    big = torch.full_like(key, _BIG)
    best = torch.full((N,), _BIG, dtype=torch.int32, device=bt.device)
    best = best.scatter_reduce(0, at1.long(),
                               torch.where(p1_ok, key + at2, big), "amin")
    best = best.scatter_reduce(0, at2.long(),
                               torch.where(p2_ok, key + at1, big), "amin")
    parents = torch.where(best == _BIG, -1, best % (N + 1)).to(torch.int32)
    return state.replace(nbonds=nbonds, parents=parents,
                         spec_number=species_count(cfg, state.types))


def species_count(cfg, types):
    """(nsp,) int32 count of atoms per species (a scatter: torch.bincount
    on a CUDA tensor would wait for the device to size its output)."""
    cnt = torch.zeros(cfg.n_spec, dtype=torch.int32, device=types.device)
    return cnt.index_add_(0, types.long(), torch.ones_like(types))


def apply_bonds(cfg, ff, state):
    """Bond forces (+ reactive repair/mutation when use_bnd == 2).
    Returns (state, eng_bond)."""
    at1, at2, bt = state.bond_at1, state.bond_at2, state.bond_type
    types = state.types
    N = cfg.n_at
    dev = bt.device
    mxB = at1.shape[0]
    live = bt != 0
    reactive = cfg.use_bnd == 2
    L = lambda a: a.long()

    if reactive:
        # --- stage 1: orientation / type repair ---
        s1 = types[L(at1)]
        s2 = types[L(at2)]
        b1, b2 = ff.bond_spec1[L(bt)], ff.bond_spec2[L(bt)]
        ok = (b1 == s1) & (b2 == s2)
        rev = (b1 == s2) & (b2 == s1) & (s1 != s2)
        at1, at2 = torch.where(rev, at2, at1), torch.where(rev, at1, at2)
        s1, s2 = torch.where(rev, s2, s1), torch.where(rev, s1, s2)
        mismatch = live & ~ok & ~rev
        defb = _evol_bondtype(ff, bt, s1, s2)
        rep = torch.where(mismatch, defb, bt)        # signed; 0 -> dies
        rep_rev = rep < 0
        at1, at2 = (torch.where(rep_rev, at2, at1),
                    torch.where(rep_rev, at1, at2))
        new_bt = torch.abs(rep)
        repair_delete = mismatch & (new_bt == 0)
        save_lt = mismatch

        # --- stage 2: distance triggers ---
        delta = min_image(state.pos[L(at1)] - state.pos[L(at2)], cfg)
        r2 = torch.sum(delta * delta, dim=-1)
        nb = L(new_bt)
        mx_trig = (live & ~repair_delete & (ff.bond_mx_ex[nb] != 0)
                   & (r2 > ff.bond_r2max[nb]))
        mn_trig = (live & ~repair_delete & ~mx_trig
                   & (ff.bond_mn_ex[nb] != 0) & (r2 < ff.bond_r2min[nb]))
        mnmx = mx_trig.long()
        trig = mx_trig | mn_trig
        trig_delete = mx_trig & (ff.bond_new_type[nb, 1] == 0)

        # --- stage 3: lowest slot wins both atoms of a mutation ---
        slot = torch.arange(mxB, dtype=torch.int32, device=dev)
        want = torch.where(trig, slot, torch.full_like(slot, _BIG))
        claim = torch.full((N,), _BIG, dtype=torch.int32, device=dev)
        claim = claim.scatter_reduce(0, L(at1), want, "amin")
        claim = claim.scatter_reduce(0, L(at2), want, "amin")
        win = trig & (claim[L(at1)] == slot) & (claim[L(at2)] == slot)

        nt_rows = ff.bond_new_type[nb, mnmx]
        ns1 = ff.bond_new_spec1[nb, mnmx]
        ns2 = ff.bond_new_spec2[nb, mnmx]
        zero = torch.zeros_like(ns1)
        types = _set_drop(types, torch.where(win, at1, N),
                          torch.where(win, ns1, zero))
        types = _set_drop(types, torch.where(win, at2, N),
                          torch.where(win, ns2, zero))

        # --- stage 4: bond record updates ---
        win_delete = win & trig_delete
        win_mutate = win & trig & ~trig_delete
        final_bt = torch.where(win_mutate, torch.abs(nt_rows), new_bt)
        final_bt = torch.where(win_delete | repair_delete,
                               torch.zeros_like(final_bt), final_bt)
        swap = win_mutate & (nt_rows < 0)
        at1, at2 = torch.where(swap, at2, at1), torch.where(swap, at1, at2)
        save_lt = save_lt | win

        # lifetime statistics on the old type
        chg = save_lt & live
        age = (state.step - state.bond_start).to(state.bt_lt_sum.dtype)
        lt_idx = torch.where(chg, bt, torch.zeros_like(bt))
        bt_lt_sum = _add(state.bt_lt_sum, lt_idx,
                         torch.where(chg, age, torch.zeros_like(age)))
        bt_lt_count = _add(state.bt_lt_count, lt_idx, chg.to(torch.int32))
        bond_start = torch.where(save_lt, state.step, state.bond_start)

        # per-type counts: -old +new for changed live bonds
        bt_count = _add(state.bt_count, lt_idx, -chg.to(torch.int32))
        gain = chg & (final_bt != 0)
        bt_count = _add(bt_count, torch.where(chg, final_bt,
                                              torch.zeros_like(final_bt)),
                        gain.to(torch.int32))

        bt = final_bt
        live = bt != 0
        gone = win_delete | repair_delete
        touched = state.touched
        for m, a in ((win, at1), (win, at2), (gone, at1), (gone, at2)):
            touched = _set_drop(touched, torch.where(m, a, N), True)
        state = state.replace(types=types, bond_at1=at1, bond_at2=at2,
                              bond_type=bt, bond_start=bond_start,
                              bt_lt_sum=bt_lt_sum, bt_lt_count=bt_lt_count,
                              bt_count=bt_count, touched=touched)
    else:
        delta = min_image(state.pos[L(at1)] - state.pos[L(at2)], cfg)
        r2 = torch.sum(delta * delta, dim=-1)

    # --- forces on live bonds (delta as measured before any swap) ---
    r2s = torch.where(live, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    kind = torch.where(live, ff.bond_kind[L(bt)], torch.zeros_like(bt))
    f, e = bond_eval(kind, ff.bond_p[L(bt)], r2s, r, kinds=cfg.bond_kinds)
    f = torch.where(live, f, torch.zeros_like(f))
    e = torch.where(live, e, torch.zeros_like(e))
    fd = f[:, None] * delta
    frc = state.frc.index_add(0, L(at1), fd).index_add(0, L(at2), -fd)
    eng = torch.sum(e)

    # mean-length statistics over the whole run
    stat_idx = torch.where(live, bt, torch.zeros_like(bt))
    bt_r_sum = _add(state.bt_r_sum, stat_idx,
                    torch.where(live, r, torch.zeros_like(r)))
    bt_r_count = _add(state.bt_r_count, stat_idx, live.to(torch.int32))
    state = state.replace(frc=frc, bt_r_sum=bt_r_sum, bt_r_count=bt_r_count)

    if reactive and cfg.bond_equil_hack:
        # the reference zeroes the velocities of reactive bond partners
        # near force equilibrium (cfg.bond_equil_hack, CLI switch)
        calm = live & (f > -0.1) & (f < 0.1)
        vmask = torch.zeros(N, dtype=torch.bool, device=dev)
        vmask = _set_drop(vmask, torch.where(calm, at1, N), True)
        vmask = _set_drop(vmask, torch.where(calm, at2, N), True)
        state = state.replace(vel=torch.where(vmask[:, None],
                                              torch.zeros_like(state.vel),
                                              state.vel))

    if reactive:
        state = refresh_derived(cfg, ff, compact_bonds(cfg, state))
    return state, eng


def compact_bonds(cfg, state):
    """Stable compaction of the bond table: live bonds move to the front
    in slot order, the rest become empty slots."""
    bt = state.bond_type
    live = bt != 0
    mxB = bt.shape[0]
    dest = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    dest = torch.where(live, dest, mxB)

    def mv(a):
        return _set_drop(torch.zeros_like(a), dest, a)

    return state.replace(
        bond_at1=mv(state.bond_at1), bond_at2=mv(state.bond_at2),
        bond_type=mv(bt), bond_start=mv(state.bond_start),
        n_bond=torch.sum(live, dtype=torch.int32))


def create_bonds(cfg, ff, state, bind_idx, bind_r2):
    """Create bonds from the pair pass's candidates: bind_idx[i] is the
    nearest eligible partner of atom i (N when none).  A candidate pair
    (a, b), a < b, is created iff its proposer wins the claim on both
    atoms (lowest proposer); of two mutual proposals the lower proposer's
    is kept.  New bonds are appended after n_bond while slots last."""
    N = cfg.n_at
    nsp = cfg.n_spec
    dev = bind_idx.device
    me = torch.arange(N, dtype=torch.int32, device=dev)
    has = bind_idx < N
    a = torch.where(has, torch.minimum(me, bind_idx), N)
    b = torch.where(has, torch.maximum(me, bind_idx), N)
    ac = torch.clamp(a, 0, N - 1).long()
    bc = torch.clamp(b, 0, N - 1).long()

    s1 = state.types[ac]
    s2 = state.types[bc]
    btype = ff.bonding_matr.reshape(-1)[(s1 * nsp + s2).long()]
    has = has & (btype != 0)

    big = torch.full_like(me, _BIG)
    claim = torch.full((N,), _BIG, dtype=torch.int32, device=dev)
    claim = _min_drop(claim, torch.where(has, a, N), torch.where(has, me, big))
    claim = _min_drop(claim, torch.where(has, b, N), torch.where(has, me, big))
    win = has & (claim[ac] == me) & (claim[bc] == me)

    # mutual proposals: keep the lower proposer
    partner = bind_idx
    mutual = win & (partner[torch.clamp(partner, 0, N - 1).long()] == me)
    win = win & ~(mutual & (partner < me))

    # orientation and type change on formation
    rev = btype < 0
    bt_abs = torch.abs(btype)
    id1 = torch.where(rev, b, a)
    id2 = torch.where(rev, a, b)
    new_t1 = ff.bond_spec1[bt_abs.long()]
    new_t2 = ff.bond_spec2[bt_abs.long()]

    # append into free slots
    rank = torch.cumsum(win.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = state.n_bond + rank
    mxB = state.bond_type.shape[0]
    ok = win & (slot < mxB)
    tgt = torch.where(ok, slot, mxB)
    step = state.step.expand(N)
    bond_at1 = _set_drop(state.bond_at1, tgt, id1)
    bond_at2 = _set_drop(state.bond_at2, tgt, id2)
    bond_type = _set_drop(state.bond_type, tgt, bt_abs)
    bond_start = _set_drop(state.bond_start, tgt, step)
    n_new = torch.sum(ok, dtype=torch.int32)

    zero = torch.zeros_like(new_t1)
    types = _set_drop(state.types, torch.where(ok, id1, N),
                      torch.where(ok, new_t1, zero))
    types = _set_drop(types, torch.where(ok, id2, N),
                      torch.where(ok, new_t2, zero))

    bt_count = _add(state.bt_count, torch.where(ok, bt_abs,
                                                torch.zeros_like(bt_abs)),
                    ok.to(torch.int32))

    touched = _set_drop(state.touched, torch.where(ok, id1, N), True)
    touched = _set_drop(touched, torch.where(ok, id2, N), True)

    state = state.replace(
        bond_at1=bond_at1, bond_at2=bond_at2, bond_type=bond_type,
        bond_start=bond_start, n_bond=state.n_bond + n_new,
        types=types, bt_count=bt_count, touched=touched)
    return refresh_derived(cfg, ff, state)


def bond_means(cfg, state):
    """Mean lifetime and length per bond type for the stat stream."""
    cnt = state.bt_lt_count
    lt = torch.where(cnt > 0, state.bt_lt_sum * cfg.dt
                     / torch.clamp(cnt, min=1), torch.zeros_like(
                         state.bt_lt_sum))
    cnt = state.bt_r_count
    rm = torch.where(cnt > 0, state.bt_r_sum / torch.clamp(cnt, min=1),
                     torch.zeros_like(state.bt_r_sum))
    return state.replace(bt_lt_mean=lt, bt_r_mean=rm)


def fix_bonds(cfg, ff, state):
    """Final bond-type repair before saving: orient each live bond to its
    type's species order, or give it the type its species now call for."""
    at1, at2, bt = state.bond_at1, state.bond_at2, state.bond_type
    live = bt != 0
    s1 = state.types[at1.long()]
    s2 = state.types[at2.long()]
    b1, b2 = ff.bond_spec1[bt.long()], ff.bond_spec2[bt.long()]
    ok = (b1 == s1) & (b2 == s2)
    rev = (b1 == s2) & (b2 == s1) & ~ok
    mism = live & ~ok & ~rev
    defb = _evol_bondtype(ff, bt, s1, s2)
    new_bt = torch.where(mism, torch.abs(defb), bt)
    flip = rev | (mism & (defb < 0))
    return state.replace(bond_at1=torch.where(flip, at2, at1),
                         bond_at2=torch.where(flip, at1, at2),
                         bond_type=new_bt)
