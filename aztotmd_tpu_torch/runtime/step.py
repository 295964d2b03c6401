"""The MD step (port of ``aztotmd_tpu/runtime/step.py`` for engines
without a neighbor list: the "pallas" engine (dense all-pairs or stacked
cell-block pass), the block-sparse "sparse" engine and the cell-block
"block" engine).

Stage order as in the JAX package:
  [Nose-Hoover pass] -> verlet1 (+wrap, counters, F=-qE, touched reset)
  -> [bond forces, reactive repair and mutation] -> pair forces (+ bind
  and jump candidates) -> [Ewald reciprocal space] -> [bond creation]
  -> [electron jumps] -> verlet2 -> apply_tstat -> energies and pressure
  -> [bond means]
The Verlet-list engine and angles are not ported yet; a deck that needs
one raises.  No stage synchronises with the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..io.control import ELEC_EWALD, TSTAT_NOSE

from ..core.state import Energies, MDState
from ..ops import bonds as ops_bonds
from ..ops import ejump as ops_ejump
from ..ops import integrate as integ
from ..ops import thermostat as tstat
from ..ops.allpairs import pair_forces_pallas, pallas_branch
from ..ops.cellblock import pair_forces_block
from ..ops.elec import ewald_recip
from ..ops.sparse import pair_forces_sparse

# the pair pass of each ported engine
PAIR_ENGINES = {"pallas": pair_forces_pallas, "sparse": pair_forces_sparse,
                "block": pair_forces_block}


@dataclasses.dataclass(frozen=True)
class StepAux:
    """Static auxiliary device data used by the step."""
    photons: torch.Tensor | None = None    # (N,) photon energies
    rk: torch.Tensor | None = None         # (K, 3) Ewald k-vectors
    kweights: torch.Tensor | None = None   # (K,) exp(-k^2/4a^2)/k^2


def _check_supported(cfg):
    """Raise for the parts of a deck that the port does not run yet."""
    missing = []
    if cfg.pair_engine not in PAIR_ENGINES:
        missing.append(f"pair engine {cfg.pair_engine!r} ('neighbor "
                       "engine (case study 1)')")
    if cfg.use_angl:
        missing.append("valence angles ('angles, with the neighbor "
                       "engine')")
    if missing:
        raise NotImplementedError(
            "not ported yet (ROADMAP.md: modules to port): "
            + "; ".join(missing))


def torch_engine_reason(cfg, dtype) -> str | None:
    """Why this configuration's pair pass is the cell-block engine (torch
    ops, thousands of small launches a pass on the card) rather than a
    CUDA kernel, or None when a kernel runs it.  ``dtype`` is the state's
    floating type."""
    if cfg.pair_engine == "block":
        return 'the deck selects the "block" engine'
    if dtype == torch.float64:
        return "the kernels are f32 only and f64 takes the cell-block engine"
    if cfg.pair_engine == "pallas":
        want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
        want_jump = cfg.ejtype != 0
        if pallas_branch(cfg, dtype, want_bind, want_jump) == "block":
            if want_bind or want_jump:
                return ("the stacked cell-block kernel has no bind/jump "
                        "candidates")
            return (f"the grid {cfg.grid.dims} with {len(cfg.grid.stencil)} "
                    "stencil offsets is outside the stacked cell-block "
                    "kernel (3 cells a side, offsets within +-1)")
    return None


def make_step(cfg, aux: StepAux | None = None, pair_fn=None):
    """Build step(state, ff) -> state.

    ``pair_fn`` replaces the engine's pair pass (same signature as
    ``ops.allpairs.pair_forces_pallas``); checks use it to run the plain
    version on the card.
    """
    _check_supported(cfg)
    aux = aux or StepAux()
    pair_fn = pair_fn or PAIR_ENGINES[cfg.pair_engine]
    want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
    want_jump = cfg.ejtype != 0

    def step(state: MDState, ff) -> MDState:
        fdt = state.pos.dtype
        dev = state.pos.device

        # --- Nose-Hoover pass from the previous step's kinetic energy ---
        if cfg.tstat_type == TSTAT_NOSE:
            vel, _, chit, consint = tstat.nose_apply(
                cfg, state.vel, state.energies.kin, state.chit,
                state.consint)
            state = state.replace(vel=vel, chit=chit, consint=consint)

        # --- verlet 1st stage + periodic wrap + counters ---
        upd, eng_field = integ.verlet1(cfg, ff, state)
        state = state.replace(**upd, touched=torch.zeros_like(state.touched))

        # --- bond forces (+ reactive repair and mutation) ---
        eng_bond = torch.zeros((), dtype=fdt, device=dev)
        if cfg.use_bnd:
            state, eng_bond = ops_bonds.apply_bonds(cfg, ff, state)

        # --- pair forces and bind/jump candidates ---
        pr = pair_fn(cfg, ff, state.pos, state.types,
                     radii=state.radii if cfg.use_radii else None,
                     parents=state.parents, want_bind=want_bind,
                     want_jump=want_jump)
        state = state.replace(
            frc=state.frc + pr.frc,
            cell_overflow=torch.maximum(state.cell_overflow, pr.max_occ))
        eng_coul1 = pr.eng_coul
        eng_coul2 = torch.zeros((), dtype=fdt, device=dev)
        eng_coul3 = torch.full((), cfg.eng_ewald_const, dtype=fdt,
                               device=dev)

        # --- Ewald reciprocal space ---
        if cfg.elec_type == ELEC_EWALD:
            frc_r, eng_r = ewald_recip(cfg, state.pos,
                                       ff.spec_charge[state.types.long()],
                                       aux.rk, aux.kweights)
            state = state.replace(frc=state.frc + frc_r)
            eng_coul2 = eng_r.to(fdt)

        # --- new bonds from the candidates ---
        if want_bind:
            state = ops_bonds.create_bonds(cfg, ff, state, pr.bind_idx,
                                           pr.bind_r2)

        # --- electron jumps ---
        if want_jump:
            state = _jumps(cfg, ff, state, pr.jump_idx)

        # --- verlet 2nd stage ---
        vel2, eng_kin = integ.verlet2(cfg, ff, state.vel, state.frc,
                                      state.types)
        if cfg.reset_vels:
            zero_now = state.step % cfg.reset_vels == 0
            vel2 = torch.where(zero_now, torch.zeros_like(vel2), vel2)
            eng_kin = torch.where(zero_now, torch.zeros_like(eng_kin),
                                  eng_kin)
        state = state.replace(vel=vel2)

        # --- thermostat ---
        upd = tstat.apply_tstat(cfg, ff, state, eng_kin,
                                photons=aux.photons)
        eng_kin = upd.pop("_eng_kin")
        eng_temp = upd.pop("_eng_temp",
                           torch.zeros((), dtype=fdt, device=dev))
        state = state.replace(**upd)

        # --- energies and pressure ---
        zero = torch.zeros((), dtype=fdt, device=dev)
        pot = eng_coul1 + eng_coul2 + eng_coul3 + pr.eng_vdw + eng_bond
        energies = Energies(
            kin=eng_kin.to(fdt), vdw=pr.eng_vdw.to(fdt),
            coul1=eng_coul1.to(fdt), coul2=eng_coul2, coul3=eng_coul3,
            bond=eng_bond.to(fdt), angle=zero, temp=eng_temp.to(fdt),
            field=eng_field.to(fdt), pot=pot.to(fdt),
            tot=(pot + eng_kin).to(fdt))
        pres, buf_p, buf_n, i_mom = integ.pressure_update(cfg, state)
        if cfg.use_bnd:
            state = ops_bonds.bond_means(cfg, state)
        return state.replace(energies=energies, pressure=pres,
                             mom_buf_pos=buf_p, mom_buf_neg=buf_n,
                             i_mom=i_mom, step=state.step + 1)

    return step


def _jumps(cfg, ff, state, jump_idx):
    """The step's jump passes over this step's candidates, gated by the
    jump frequency f: f < 0 runs one pass every |f| steps (masking its
    acceptance, so the step does not wait on the host), 0 < f <= 4 runs
    max(f, 1) passes and f > 4 runs f passes; each pass sees the types
    the one before mutated."""
    nbr = None
    if not cfg.use_bnd and cfg.n_at > 8192 and cfg.grid is not None:
        # positions do not change across the passes: build the
        # environment sweep's candidate list once
        nbr = ops_ejump.env_candidates(cfg, state.pos)
    f = int(cfg.ejump_freq)
    if f < 0:
        return ops_ejump.do_jumps(cfg, ff, state, jump_idx,
                                  active=(state.step % (-f)) == 0,
                                  nbr_idx=nbr)
    for _ in range(max(f, 1)):
        state = ops_ejump.do_jumps(cfg, ff, state, jump_idx, nbr_idx=nbr)
    return state


def make_multi_step(cfg, aux: StepAux | None = None, pair_fn=None):
    """multi(state, ff, n) -> state after n steps (a Python loop; no host
    synchronisation inside)."""
    step = make_step(cfg, aux, pair_fn=pair_fn)

    def multi(state, ff, n: int):
        for _ in range(n):
            state = step(state, ff)
        return state

    return multi
