"""Debug-mode state invariants (port of ``aztotmd_tpu/runtime/debug.py``).

The reference compiles invariant kernels under DEBUG_MODE (defines.h:5):
``verify_clist`` (cell-table consistency, cuMDfunc.cu:716),
``verify_forces`` (NaN scan, :768), bond-type range checks.  Here one
function of the state returns a vector of violation counts, computed on
the device; ``assert_state_ok`` pulls it to the host once and raises with
the named violations (``run --debug`` after every chunk).
"""

from __future__ import annotations

import torch

from ..ops.consts import const

CHECKS = (
    "pos_finite", "vel_finite", "frc_finite",
    "pos_in_box", "types_in_range",
    "bond_atoms_in_range", "bond_types_in_range",
    "angle_atoms_in_range", "spec_number_consistent",
    "velocity_bound",
)

MX_VEL = 1.0e5      # DEBUG1_MODE velocity bound (defines.h:6-7)


def check_state(cfg, state):
    """An int32 vector of violation counts, one per ``CHECKS``, on the
    state's device."""
    N = cfg.n_at
    box = const(cfg.box, state.pos.dtype, state.pos.device)

    def count(bad):
        return torch.sum(bad.to(torch.int32), dtype=torch.int32)

    flags = [count(~torch.isfinite(state.pos)),
             count(~torch.isfinite(state.vel)),
             count(~torch.isfinite(state.frc)),
             count((state.pos < 0.0) | (state.pos >= box)),
             count((state.types < 0) | (state.types >= cfg.n_spec))]

    live = state.bond_type != 0
    at_ok = (state.bond_at1 >= 0) & (state.bond_at1 < N) \
        & (state.bond_at2 >= 0) & (state.bond_at2 < N)
    flags.append(count(live & ~at_ok))
    nbt = max(cfg.n_bond_types, 1)
    flags.append(count(live & (state.bond_type >= nbt)))

    alive = state.ang_type != 0
    a_ok = (state.ang_central >= 0) & (state.ang_central < N) \
        & (state.ang_lig1 >= 0) & (state.ang_lig1 < N) \
        & (state.ang_lig2 >= 0) & (state.ang_lig2 < N)
    flags.append(count(alive & ~a_ok))

    # as JAX's .at[types].add(1): a negative id counts from the end, an
    # id out of range either way is dropped
    t = state.types.long()
    t = torch.where(t < 0, t + cfg.n_spec, t)
    ok_t = (t >= 0) & (t < cfg.n_spec)
    counted = torch.zeros(cfg.n_spec + 1, dtype=torch.int32,
                          device=t.device)
    counted.index_add_(0, torch.where(ok_t, t, torch.full_like(t, cfg.n_spec)),
                       torch.ones_like(t, dtype=torch.int32))
    flags.append(count(counted[:cfg.n_spec] != state.spec_number))

    flags.append(count(torch.abs(state.vel) > MX_VEL))
    return torch.stack(flags)


def assert_state_ok(cfg, state):
    """Host-side check (one pull of the counts); raises with the named
    violations."""
    vals = check_state(cfg, state).cpu().tolist()
    bad = {name: int(v) for name, v in zip(CHECKS, vals) if v}
    if bad:
        raise AssertionError(f"state invariant violations: {bad}")
