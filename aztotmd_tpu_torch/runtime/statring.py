"""The stat ring's rows (port of ``aztotmd_tpu/runtime/statring.py``) and
the buffers that carry them from the card to the writers.

``make_stat_row`` builds, from a state, one float32 row (the energies,
momenta, pressure, x1, per-species displacement MSD and bond means) and
one int32 row (the step, species counts, crossing counters, bond and jump
counters, the seven capacity monitors and the bond-type counts), with the
JAX package's columns in its order (``make_layout``).  It is torch ops
only, so the runner captures it into a program of the stat period.

``RowRing`` is the static ring on the device: its program ``row`` writes
the row of the state it is given into slot ``slot`` (a device counter
that the program advances; no program takes a host value), and its
program ``reset`` sets the counter back to 0 at the start of a window.
``HostRows`` holds two host buffers (pinned on the card) and moves a
window's rows into one of them with one non-blocking copy and an event
after it: the host decodes window k while the card runs window k+1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.consts import const


def make_layout(n_spec: int, n_bt: int):
    """Column slices for the float and int sample rows."""
    fsl, off = {}, 0
    for name, w in [("eng", 8), ("pos_mom", 3), ("neg_mom", 3),
                    ("press", 1), ("x1", 1), ("msd", n_spec),
                    ("bt_r", n_bt), ("bt_lt", n_bt)]:
        fsl[name] = slice(off, off + w)
        off += w
    nf = off
    isl, off = {}, 0
    for name, w in [("step", 1), ("spec", n_spec), ("cpos", 3 * n_spec),
                    ("cneg", 3 * n_spec), ("nbond", 1), ("njump", 1),
                    ("jpos", 1), ("jneg", 1), ("over", 7), ("btc", n_bt)]:
        isl[name] = slice(off, off + w)
        off += w
    return fsl, nf, isl, off


# float-row "eng" column order (matches StatWriter's expectations)
ENG_KEYS = ("tot", "kin", "vdw", "coul1", "coul2", "bond", "angle", "temp")

# the monitors of the int row's "over" slots, in order
OVER_KEYS = ("cell_overflow", "nbr_over", "nbr_viol", "nbrow_over",
             "nbr2_over", "rdf_over", "orow_over")


def _i32(t):
    return t.reshape(-1).to(torch.int32)


def pack_rows(E, pos_mom, neg_mom, pressure, x1, msd, bt_r, bt_lt, step,
              spec_number, cross_pos, cross_neg, n_bond, n_jump, jump_pos,
              jump_neg, over, bt_count):
    """(frow float32, irow int32) of the layout from its values."""
    f32 = torch.float32
    frow = torch.cat([
        torch.stack([getattr(E, k).to(f32) for k in ENG_KEYS]),
        pos_mom.to(f32), neg_mom.to(f32), pressure.to(f32).reshape(1),
        x1.to(f32).reshape(1), msd, bt_r.to(f32), bt_lt.to(f32)])
    irow = torch.cat([_i32(step), _i32(spec_number), _i32(cross_pos),
                      _i32(cross_neg), _i32(n_bond), _i32(n_jump),
                      _i32(jump_pos), _i32(jump_neg),
                      torch.cat([_i32(o) for o in over]),
                      _i32(bt_count)])
    return frow, irow


def make_stat_row(cfg, spec_counts0):
    """Build stat_row(state) -> (frow float32, irow int32).

    spec_counts0: initial per-species atom counts (the displacement-MSD
    denominators are bound at t=0, matching MsdDisplWriter / the serial
    build's out_msd, out_md.cpp:89-124)."""
    counts = np.maximum(np.asarray(spec_counts0), 1).astype(np.float32)
    counts = [float(c) for c in counts]
    n_spec = cfg.n_spec
    box = [float(b) for b in cfg.box]

    def stat_row(state):
        dev, dt = state.pos.device, state.pos.dtype
        # per-species mean |r(t)-r(0)|^2, minimum image: a masked column
        # sum in the state's dtype (JAX's one-hot matmul, without a BLAS
        # call), then float32
        d = state.pos - state.pos0
        bx = const(box, dt, dev)
        d = d - bx * torch.round(d / bx)
        r2 = torch.sum(d * d, dim=1)
        sp = torch.arange(n_spec, dtype=torch.int32, device=dev)
        oh = (state.types[:, None] == sp[None, :]).to(dt)
        msd = (r2[:, None] * oh).sum(0).to(torch.float32) \
            / const(counts, torch.float32, dev)
        return pack_rows(
            state.energies, state.pos_mom, state.neg_mom, state.pressure,
            state.pos[0, 0], msd, state.bt_r_mean, state.bt_lt_mean,
            state.step, state.spec_number, state.cross_pos, state.cross_neg,
            state.n_bond, state.n_jump, state.jump_pos, state.jump_neg,
            [getattr(state, k) for k in OVER_KEYS], state.bt_count)

    return stat_row


class RowRing:
    """The device ring of ``cap`` rows: ``program(stat_row)`` is a state
    program ``(state, ff) -> state`` that writes ``stat_row(state)`` into
    slot ``slot % cap`` and advances ``slot``; ``reset`` is the program
    that sets ``slot`` to 0.  Both return their state unchanged, so a
    captured program is the row's kernels and nothing else."""

    def __init__(self, nf: int, ni: int, cap: int, device):
        self.cap = int(cap)
        self.frows = torch.zeros((self.cap, nf), dtype=torch.float32,
                                 device=device)
        self.irows = torch.zeros((self.cap, ni), dtype=torch.int32,
                                 device=device)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=device)

    def program(self, stat_row):
        def row(state, ff):
            frow, irow = stat_row(state)
            j = torch.remainder(self.slot, self.cap)
            self.frows.index_copy_(0, j, frow[None])
            self.irows.index_copy_(0, j, irow[None])
            self.slot.add_(1)
            return state
        return row

    def reset(self, state, ff):
        self.slot.zero_()
        return state

    def rows(self, n: int):
        """The device rows of the window's first ``n`` periods."""
        return self.frows[:n], self.irows[:n]


class HostRows:
    """Two host buffers of up to ``cap`` rows each, pinned when the rows
    live on the card.  ``fetch(frows, irows)`` enqueues one non-blocking
    copy of a window's rows into the next buffer and records an event
    after it; ``wait(pending)`` waits for that event and returns the rows
    as numpy arrays (views of the buffer, valid until the buffer's next
    fetch, two windows later)."""

    def __init__(self, nf: int, ni: int, cap: int, device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._bufs = [(torch.empty((cap, nf), dtype=torch.float32,
                                   pin_memory=pin),
                       torch.empty((cap, ni), dtype=torch.int32,
                                   pin_memory=pin)) for _ in range(2)]
        self._next = 0
        self.fetches = 0

    def fetch(self, frows, irows):
        hf, hi = self._bufs[self._next]
        self._next ^= 1
        n = frows.shape[0]
        hf, hi = hf[:n], hi[:n]
        cuda = self.device.type == "cuda"
        hf.copy_(frows, non_blocking=cuda)
        hi.copy_(irows, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        self.fetches += 1
        return hf, hi, event

    @staticmethod
    def wait(pending):
        hf, hi, event = pending
        if event is not None:
            event.synchronize()
        return hf.numpy(), hi.numpy()
