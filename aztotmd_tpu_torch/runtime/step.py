"""The MD step (port of ``aztotmd_tpu/runtime/step.py``): the "pallas"
engine (dense all-pairs or stacked cell-block pass), the block-sparse
"sparse" engine, the cell-block "block" engine, the per-atom candidate
matrix of the "gather" engine and the Verlet-list "neighbor" engine,
with valence angles.

Stage order as in the JAX package:
  [Nose-Hoover pass] -> verlet1 (+wrap, counters, F=-qE, touched reset)
  -> [bond forces, reactive repair and mutation] -> pair forces (+ bind
  and jump candidates; the neighbor engine's skin monitor) -> [Ewald
  reciprocal space] -> [bond creation] -> [electron jumps] -> [angles]
  -> verlet2 -> apply_tstat -> energies and pressure -> [bond means]
No stage synchronises with the host.  On the neighbor engine the
multi-step rebuilds the list on JAX's schedule: a full rebuild at the
start of every call, and with the two-level list inner refines every
``nb_rebuild`` steps in superblocks of ``nb_outer * nb_rebuild`` steps.
On the card the multi-step replays CUDA graphs of the step, the rebuild
and the refine (``MultiStep``, ``runtime/graph.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..io.control import ELEC_EWALD, TSTAT_NOSE

from ..core.state import Energies, MDState
from ..ops import angles as ops_angles
from ..ops import bonds as ops_bonds
from ..ops import ejump as ops_ejump
from ..ops import integrate as integ
from ..ops import neighbors as ops_nbr
from ..ops import thermostat as tstat
from ..ops.allpairs import pair_forces_pallas, pallas_branch
from ..ops.cellblock import pair_forces_block
from ..ops.consts import const
from ..ops.elec import ewald_recip
from ..ops.pairs import pair_forces
from ..ops.sparse import pair_forces_sparse
from .graph import StateGraphs, use_graph

# the pair pass of each cell or dense engine ("neighbor" walks its list
# inside the step); as in the JAX step, every other name takes "gather"
PAIR_ENGINES = {"pallas": pair_forces_pallas, "sparse": pair_forces_sparse,
                "block": pair_forces_block, "gather": pair_forces}

# full list rebuilds and inner refines run since the counts were last
# set to 0 (the step's list schedule, read by checks)
nbr_counts = {"rebuild": 0, "refine": 0}


@dataclasses.dataclass(frozen=True)
class StepAux:
    """Static auxiliary device data used by the step."""
    photons: torch.Tensor | None = None    # (N,) photon energies
    rk: torch.Tensor | None = None         # (K, 3) Ewald k-vectors
    kweights: torch.Tensor | None = None   # (K,) exp(-k^2/4a^2)/k^2


def _rowcomp_updates(cfg, state, idx):
    """State updates for the row-compacted walk (``nb_rowcap`` > 0):
    recompact whenever the inner list changes."""
    if not cfg.nb_rowcap:
        return {}
    nbrow, n_rows = ops_nbr.compact_rows(idx, cfg.nb_rowcap, cfg.n_at)
    return dict(nbrow_idx=nbrow,
                nbrow_over=torch.maximum(state.nbrow_over, n_rows))


def rebuild_neighbors_state(cfg, state):
    """Full Verlet-list rebuild.  With the two-level list this rebuilds
    the outer list and takes the inner one from it: a prefix slice of the
    sorted build's rows, or a refine after the unsorted one."""
    nbr_counts["rebuild"] += 1
    pos = state.pos
    if cfg.nb_outer > 1:
        if ops_nbr.sorted_build_ok(cfg):
            ocfg = dataclasses.replace(cfg, n_neigh=cfg.n_neigh2,
                                       nb_skin=cfg.nb_skin2)
            idx2, skey2, nmax2, occ = ops_nbr.build_neighbors_keys(ocfg, pos)
            idx, nmax = ops_nbr.prefix_refine(
                idx2, skey2, cfg.r_max + cfg.nb_skin, cfg.n_neigh, cfg.n_at)
        else:
            idx2, nmax2, occ = ops_nbr.build_outer_neighbors(cfg, pos)
            idx, nmax = ops_nbr.refine_neighbors(cfg, pos, idx2)
        extra = {}
        if cfg.nb_orowcap:
            # the outer-occupied rows, which the refines sweep until the
            # next full rebuild
            orow, n_orow = ops_nbr.compact_orows(idx2, cfg.nb_orowcap,
                                                 cfg.n_at)
            extra = dict(orow_idx=orow,
                         orow_over=torch.maximum(state.orow_over, n_orow))
        return state.replace(
            nbr_idx=idx, nbr_ref=pos, nbr2_idx=idx2,
            nbr_over=torch.maximum(state.nbr_over, nmax),
            nbr2_over=torch.maximum(state.nbr2_over, nmax2),
            cell_overflow=torch.maximum(state.cell_overflow, occ),
            **extra, **_rowcomp_updates(cfg, state, idx))
    idx, nmax, occ = ops_nbr.build_neighbors(cfg, pos)
    return state.replace(
        **_rowcomp_updates(cfg, state, idx),
        nbr_idx=idx, nbr_ref=pos,
        nbr_over=torch.maximum(state.nbr_over, nmax),
        cell_overflow=torch.maximum(state.cell_overflow, occ))


def refine_neighbors_state(cfg, state):
    """Inner refine from the outer list: row-first with the row-compacted
    walk (over the outer-occupied rows only with ``nb_orowcap``), else
    over all rows and then compacted."""
    nbr_counts["refine"] += 1
    if cfg.nb_rowcap:
        idx, nbrow, nmax, n_rows = ops_nbr.refine_neighbors_rows(
            cfg, state.pos, state.nbr2_idx, cfg.nb_rowcap,
            orow=state.orow_idx if cfg.nb_orowcap else None)
        return state.replace(
            nbr_idx=idx, nbr_ref=state.pos,
            nbr_over=torch.maximum(state.nbr_over, nmax),
            nbrow_idx=nbrow,
            nbrow_over=torch.maximum(state.nbrow_over, n_rows))
    idx, nmax = ops_nbr.refine_neighbors(cfg, state.pos, state.nbr2_idx)
    return state.replace(
        nbr_idx=idx, nbr_ref=state.pos,
        nbr_over=torch.maximum(state.nbr_over, nmax),
        **_rowcomp_updates(cfg, state, idx))


def _neighbor_pairs(cfg, ff, state, want_bind, want_jump, auto_rebuild):
    """The neighbor engine's pair stage: the skin monitor (2 * the largest
    displacement since the last rebuild against nb_skin), then the walk.
    ``auto_rebuild`` (single steps) rebuilds the single-level list on
    schedule or when stale and counts only the unscheduled staleness; the
    scanned mode counts every stale step and walks the compacted rows
    when ``nb_rowcap`` is set.  Returns (state, PairResult)."""
    pos = state.pos
    box = const(cfg.box, pos.dtype, pos.device)
    disp = pos - state.nbr_ref
    disp = disp - box * torch.round(disp / box)
    max_disp = torch.sqrt(torch.max(torch.sum(disp * disp, dim=-1)))
    stale = 2.0 * max_disp > cfg.nb_skin
    kw = dict(radii=state.radii if cfg.use_radii else None,
              parents=state.parents, want_bind=want_bind,
              want_jump=want_jump)
    if auto_rebuild:
        # both branches run and a select keeps one: the device decides
        # without a host round trip
        on_sched = (state.step % cfg.nb_rebuild) == 0
        need = on_sched | stale
        idx_new, nmax, occ = ops_nbr.build_neighbors(cfg, pos)
        nbr_idx = torch.where(need, idx_new, state.nbr_idx)
        state = state.replace(
            nbr_idx=nbr_idx,
            nbr_ref=torch.where(need, pos, state.nbr_ref),
            nbr_over=torch.maximum(
                state.nbr_over, torch.where(need, nmax, state.nbr_over)),
            nbr_viol=state.nbr_viol + (stale & ~on_sched).to(torch.int32),
            cell_overflow=torch.maximum(
                state.cell_overflow,
                torch.where(need, occ, torch.zeros_like(occ))))
        return state, ops_nbr.pair_forces_neighbors(
            cfg, ff, pos, state.types, nbr_idx, **kw)
    state = state.replace(nbr_viol=state.nbr_viol + stale.to(torch.int32))
    if cfg.nb_rowcap:
        return state, ops_nbr.pair_forces_rows(
            cfg, ff, pos, state.types, state.nbrow_idx, **kw)
    return state, ops_nbr.pair_forces_neighbors(
        cfg, ff, pos, state.types, state.nbr_idx, **kw)


def torch_engine_reason(cfg, dtype) -> str | None:
    """Why this configuration's pair pass is the cell-block engine (torch
    ops, thousands of small launches a pass on the card) rather than a
    CUDA kernel, or None when a kernel runs it.  ``dtype`` is the state's
    floating type.  The neighbor and gather engines have no kernel to
    bypass (no Pallas kernel lies on their paths in the JAX package), in
    f32 or f64."""
    if cfg.pair_engine in ("neighbor", "gather"):
        return None
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


def pair_pass(cfg, dtype, device_type: str = "cuda") -> str:
    """The pair pass of this configuration's step, in words for the
    runner's record: the pass with the kernel it launches on the card
    ("stacked (K3)", "allpairs (K1)", "allpairs (K1-cand)", "sparse
    (K4)", "sparse (K4-cand)"), the torch engines ("neighbor list (torch
    ops)", "gather (torch ops)", and the cell-block engine with
    ``torch_engine_reason``'s words); off the card the kernel's place is
    taken by its plain version, and the words say so."""
    if cfg.pair_engine == "neighbor":
        return "neighbor list (torch ops)"
    if cfg.pair_engine not in ("pallas", "sparse", "block"):
        return "gather (torch ops)"
    reason = torch_engine_reason(cfg, dtype)
    if reason:
        return f"block (torch ops: {reason})"
    want_bind = cfg.use_bnd == 2 and cfg.use_linkage != 0
    want_jump = cfg.ejtype != 0
    if cfg.pair_engine == "sparse":
        name, kernel = "sparse", "K4"
    else:
        name = pallas_branch(cfg, dtype, want_bind, want_jump)
        kernel = "K1" if name == "allpairs" else "K3"
    kernel += "-cand" if want_bind or want_jump else ""
    if device_type != "cuda":
        return f"{name} (the plain version of {kernel})"
    return f"{name} ({kernel})"


def make_step(cfg, aux: StepAux | None = None, pair_fn=None,
              nbr_auto_rebuild: bool = True):
    """Build step(state, ff) -> state.

    ``pair_fn`` replaces a cell or dense engine's pair pass (same
    signature as ``ops.allpairs.pair_forces_pallas``); checks use it to
    run the plain version on the card.  ``nbr_auto_rebuild`` (the
    neighbor engine): rebuild the list inside the step on schedule or
    when stale; the multi-step passes False and rebuilds between steps.
    """
    aux = aux or StepAux()
    neighbor = cfg.pair_engine == "neighbor"
    if not neighbor:
        pair_fn = pair_fn or PAIR_ENGINES.get(cfg.pair_engine, pair_forces)
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
        if neighbor:
            state, pr = _neighbor_pairs(cfg, ff, state, want_bind,
                                        want_jump, nbr_auto_rebuild)
        else:
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

        # --- valence angles ---
        eng_angle = torch.zeros((), dtype=fdt, device=dev)
        if cfg.use_angl:
            if cfg.use_angl == 2:
                state = ops_angles.refresh_angles(cfg, ff, state)
            state, eng_angle = ops_angles.apply_angles(cfg, ff, state)

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
        pot = (eng_coul1 + eng_coul2 + eng_coul3 + pr.eng_vdw + eng_bond
               + eng_angle)
        energies = Energies(
            kin=eng_kin.to(fdt), vdw=pr.eng_vdw.to(fdt),
            coul1=eng_coul1.to(fdt), coul2=eng_coul2, coul3=eng_coul3,
            bond=eng_bond.to(fdt), angle=eng_angle.to(fdt),
            temp=eng_temp.to(fdt),
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
    if not cfg.use_bnd:
        if cfg.pair_engine == "neighbor":
            # the environment sweep walks the Verlet list
            nbr = state.nbr_idx
        elif cfg.n_at > 8192 and cfg.grid is not None:
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


class MultiStep:
    """multi(state, ff, n) -> the state after n steps, from named programs
    ``fns`` (``fn(state, ff) -> state``): "step", and on the neighbor
    engine "rebuild" and, with the two-level list, "refine", run on the
    JAX package's list schedule (``make_multi_step``).

    ``graph`` (the counterpart of JAX's ``jit=``): None captures the
    programs as CUDA graphs when the state is on a CUDA device and runs
    them eagerly on the CPU; False runs eagerly (the path checks and
    measurements compare against); True requires a CUDA state.  With the
    graph on, a call returns the static state of ``self.graphs``
    (``runtime/graph.py``), and the next call advances that very object
    in place: a caller that keeps a state clones it
    (``graph.clone_state``).  A state that is not the static one is
    copied into the static buffers, or recaptured when its layout
    differs; another force-field object recaptures too.  No host
    synchronisation inside either way."""

    def __init__(self, fns: dict, graph: bool | None = None, R: int = 1,
                 Q: int = 1):
        self.fns = dict(fns)
        self.graph = graph
        self.R, self.Q = R, Q
        self.graphs = StateGraphs(self.fns)

    def start(self, state, ff):
        """(run(name, m), current state) on the graph or the eager path:
        ``run`` calls program ``name`` m times on ``state`` and the states
        after it, ``current()`` returns the latest.  With the graph on it
        loads ``state`` into the static buffers first."""
        if use_graph(self.graph, state.pos.device):
            self.graphs.load(state, ff)
            return self.graphs.run, lambda: self.graphs.state
        box = [state]

        def run(name, m=1):
            fn = self.fns[name]
            for _ in range(m):
                box[0] = fn(box[0], ff)
        return run, lambda: box[0]

    def __call__(self, state, ff, n: int):
        run, current = self.start(state, ff)
        self.schedule(run, n)
        return current()

    def schedule(self, run, n: int):
        """n steps as calls ``run(name, m)`` (program ``name`` m times):
        the list schedule of the JAX package's multi-step."""
        if "rebuild" not in self.fns:
            run("step", n)
            return
        R, Q = self.R, self.Q

        def block(m, full):
            run("rebuild" if full else "refine")
            run("step", m)

        def superblock(m):
            block(min(R, m), True)
            m_in, rem_in = divmod(max(m - R, 0), R)
            for _ in range(m_in):
                block(R, False)
            if rem_in:
                block(rem_in, False)

        if Q > 1:
            n_sup, rem = divmod(n, Q * R)
            for _ in range(n_sup):
                superblock(Q * R)
            if rem:
                superblock(rem)
            return
        n_out, rem = divmod(n, R)
        for _ in range(n_out):
            block(R, True)
        if rem:
            block(rem, True)


def make_multi_step(cfg, aux: StepAux | None = None, pair_fn=None,
                    graph: bool | None = None) -> MultiStep:
    """multi(state, ff, n) -> state after n steps (``MultiStep``; ``graph``
    as there).  On the neighbor engine the list is rebuilt on the JAX
    package's schedule: every call starts with a full rebuild; with the
    two-level list (``nb_outer`` Q > 1) superblocks of Q*R steps each
    start with one and refine every R = ``nb_rebuild`` steps after it,
    otherwise every block of R steps starts with one."""
    if cfg.pair_engine != "neighbor":
        return MultiStep({"step": make_step(cfg, aux, pair_fn=pair_fn)},
                         graph)
    R = max(int(cfg.nb_rebuild), 1)
    Q = max(int(cfg.nb_outer), 1)
    fns = {"step": make_step(cfg, aux, nbr_auto_rebuild=False),
           "rebuild": lambda s, ff: rebuild_neighbors_state(cfg, s)}
    if Q > 1:
        fns["refine"] = lambda s, ff: refine_neighbors_state(cfg, s)
    return MultiStep(fns, graph, R, Q)
