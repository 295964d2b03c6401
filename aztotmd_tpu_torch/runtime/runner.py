"""The run orchestrator (port of ``aztotmd_tpu/runtime/runner.py``: the
host chunk loop ``_run_loop``, the stat ring's plan and loop
``_run_loop_ring``, its flush ``_flush_rows`` / ``_decode_rows``,
``_sample``, ``_sample_rest`` and ``finalize``).

Where the JAX runner takes its on-device stat ring (``ring_ok``: every
host-visible period a multiple of the stat period, and the RDF period
dividing it, and ``AZTOTMD_NO_RING`` unset), so does the port: the
periods come in JAX's dispatch windows of ``n_fix`` periods between host
events (``_ring``), each period runs the ring's ``stat_block``
(``_ring_period``) and ends with the "row" program, which writes the
period's float32 and int32 stat row (``statring.py``) into a device ring;
one copy a window moves the rows to pinned host memory, and window k is
decoded into the writers and its monitors read (the max over its rows)
only after window k+1 is enqueued, so a regrow comes one window late, as
in JAX.  On the Verlet list with short RDF blocks
(``refine_blocks``) a period starts with one full rebuild and each RDF
block with an inner refine.  Where the RDF has a list (``k_cap`` > 0,
any engine), each period builds the (N, k_cap) RDF list and the samples
read it; when its reach covers the outer list's (``rdf_covers_outer``),
the outer list is refined from it instead of rebuilt; in the opposite
regime (``rdf_from_outer``) the outer list serves the RDF directly and a
full rebuild starts each superblock of ``k_super`` periods of a window.
JAX's opt-in row-compacted sampling (``rdf_rows``, a measured loss there)
is not ported: the plan's ``rdf_rows`` is always False.  Elsewhere
steps run in chunks sized to the greatest common divisor of the output
periods, RDF samples inside the chunk every ``fr_rdf`` steps, each chunk
starting with a full list rebuild, as JAX's host chunk loop does, and
each stat row is read from the state (``_stat_row``).  Both loops reset
the RDF window after 500 samples as JAX's do.  The output files and
their rows are the JAX runner's, with stat_bnd.dat and jumps.dat for
reactive decks and revbonds.txt and lengths.dat at the end of a run with
bonds and revangles.txt with angles.  The runner reads the capacity
monitors (the block-sparse worklist length or the fullest
cell's occupancy; on the Verlet-list engine the skin violations, the
inner and outer neighbor counts, the occupied and outer-occupied rows and
the list grid's occupancy; the RDF list's ``rdf_over``) and regrows the
capacity (``_check_overflow``).  On the card the steps, the list passes
and the RDF samples are replays of CUDA graphs (``runtime/graph.py``);
every regrow rebuilds the programs, which recapture.

Mesh mode (``mesh_devices=N``, ``run --mesh N``) runs the slab-decomposed
step of ``parallel/slab.py``: the deck's grid is re-cut to the slab
stencil, the state is distributed by x-slab, and the ring loop calls the
slab ring (``make_slab_ring``: the slab step, the RDF sample on the mesh
at its period, a row psum-reduced over the slabs whose monitor slots
carry the slab health monitors; JAX's slab ring has no RDF list), or
the chunk loop the slab step and the RDF sample on the mesh.  The
host-event outputs read the state gathered in global-id order, with the
bond, angle and jump tables of the replicated reactive topology
(``SlabState.rg``) or, on a constant-topology deck, of the initial
MDState.  Checkpoints are single-device MDStates with the live topology,
which either package resumes on one device or on any mesh.  The slab
monitors regrow the cell capacity, warn about bond or angle records
whose partner lay beyond one slab, or raise the slot capacity 1.5x and
redistribute after a migration deleted atoms or kept deferring
(``_check_slab_health``).

Atom-sharded mode (``mesh_devices=N, mesh_mode="atoms"``, ``run --mesh N
--mesh-mode atoms``) keeps the per-atom fields in N equal row shards
(``parallel/mesh.py``) and runs the one-device programs and plan over
their gather; the writers, the RDF samples and checkpoints read the
gathered state, so a checkpoint resumes on one device, and a list regrow
gathers, regrows and shards again; the ring's row is computed over the
gathered rows inside the period's programs.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .. import units
from ..io.control import TSTAT_RADI
from ..output import writers as W

from ..core.config import _round_up
from ..ops import neighbors as ops_nbr
from ..ops import rdf as ops_rdf
from ..utils.profiling import StageTimer
from .checkpoint import save_checkpoint
from . import statring
from . import graph as graph_mod
from .graph import GraphedSample
from .step import (MultiStep, make_multi_step, pair_pass,
                   torch_engine_reason)

def _gcd_all(values):
    g = 0
    for v in values:
        if v and v > 0:
            g = math.gcd(g, int(v))
    return g


class MDRunner:
    """Drive a loaded system to completion and write its output files.

    ``graph`` is ``make_multi_step``'s: None captures CUDA graphs of the
    step (and the neighbor engine's rebuild and refine, and the RDF
    sample) on the card and runs eagerly on the CPU; False runs eagerly.
    ``timer`` (``utils/profiling.py::StageTimer``) always records the
    host's spans, which never wait on the card: ``steps`` (enqueuing the
    step-advancing programs), ``wait`` (blocked on the card) and
    ``sampling`` (decoding rows, the monitors, the host events), and one
    record a ``run()`` call with the counters ``regrow``, ``captures``,
    each program's graph launches and each kernel's launches (replays
    add their captures' counts); ``profile`` prints the call's
    record (``run --timings``).  ``debug`` checks the state's invariants
    after every chunk or host event on one device (``run --debug``).
    Where the JAX stat ring's gate holds (``ring_ok``) the run takes the
    ring's plan (``_ring_plan``); elsewhere every RDF block restarts the
    list schedule, as JAX's host chunk loop does.  ``AZTOTMD_RING_STEPS``
    and a deck's ``nstep stat`` set the window (``s_cap``) as in JAX;
    ``AZTOTMD_NO_RING`` takes the host loop, as in JAX."""

    def __init__(self, sysd: dict, out_dir: str = ".", quiet: bool = False,
                 checkpoint_every: int = 0, append: bool = False,
                 mesh_devices: int = 0, mesh_mode: str = "slab",
                 comm=None, graph: bool | None = None,
                 profile: bool = False, debug: bool = False):
        self.cfg = cfg = sysd["cfg"]
        self.graph = graph
        self.profile = profile
        self.debug = debug
        self.timer = StageTimer()
        self.comm = None
        self._atoms_mesh = None
        if mesh_devices or comm is not None:
            from ..parallel import comm as _comm
            from ..parallel import slab as _slab
            n_dev = comm.n_dev if comm is not None else mesh_devices
            dev = sysd["state"].pos.device
            if mesh_mode == "atoms":
                # atom-sharded mode (parallel/mesh.py): per-atom fields in
                # equal row shards, the unchanged step over their gather
                if cfg.n_at % n_dev:
                    raise ValueError(
                        f"n_at={cfg.n_at} not divisible by mesh size "
                        f"{n_dev} (atom-sharded mode needs equal shards)")
                self._atoms_mesh = comm or _comm.LocalRing(n_dev, dev)
            elif mesh_mode != "slab":
                raise ValueError(f"unknown mesh_mode {mesh_mode!r} "
                                 "(use 'slab' or 'atoms')")
            else:
                # the slab mesh routes from the cost model's engine; the
                # one-device kernel rule of ``device_pair_engine`` is not
                # the slab step's
                cfg = dataclasses.replace(cfg, pair_engine=sysd.get(
                    "cost_engine") or cfg.pair_engine)
                self.cfg = cfg = _slab.prepare_slab_cfg(cfg, n_dev)
                self.comm = comm or _comm.LocalRing(n_dev, dev)
        self.ff = sysd["ff"]
        self.state = sysd["state"]
        self.aux = sysd["aux"]
        self.ctl = ctl = sysd["ctl"]
        self.fld = fld = sysd["fld"]
        self.atoms = sysd["atoms"]
        self.out_dir = out_dir
        self.quiet = quiet
        self.checkpoint_every = checkpoint_every
        self.device = self.state.pos.device
        os.makedirs(out_dir, exist_ok=True)

        types_h = np.array([fld.spec_id(nm) for nm in self.atoms.names],
                           dtype=np.int32)
        pos_h = np.asarray(self.atoms.pos, np.float64)
        vel_h = (np.asarray(sysd["vel0"]) if sysd.get("vel0") is not None
                 else np.zeros_like(pos_h))

        # --- sampling periods (0 = off) ---
        self.p_stat = ctl.stat
        self.p_rdf = ctl.fr_rdf
        self.p_rdf_out = ctl.fr_rdf_out
        self.p_traj = ctl.fr_traj
        self.p_revcon = ctl.revcon
        periods = [self.p_stat, self.p_traj, self.p_revcon,
                   ctl.bindtraj_freq if ctl.bindtraj_nucl else 0,
                   ctl.hist, ctl.vaf, checkpoint_every]
        self.chunk = min(_gcd_all(periods) or 1000, 1000)
        self.rdf_in_chunk = bool(ctl.fr_rdf and ctl.r_rdf > 0
                                 and self.chunk % ctl.fr_rdf == 0)
        if ctl.fr_rdf and not self.rdf_in_chunk:
            self.chunk = _gcd_all(periods + [ctl.fr_rdf]) or ctl.fr_rdf

        # --- writers ---
        j = lambda p: os.path.join(out_dir, p)
        self.w_stat = W.StatWriter(j("stat.dat"), fld,
                                   cfg.tstat_type == TSTAT_RADI,
                                   cfg.use_bnd != 0, cfg.use_angl != 0,
                                   append=append)
        self.w_bnd = (W.BondStatWriter(j("stat_bnd.dat"), fld, append=append)
                      if cfg.use_bnd else None)
        self.w_msd = W.MsdWriter(j("msd.dat"), fld, append=append)
        self.w_jmp = (W.JumpWriter(j("jumps.dat"), append=append)
                      if cfg.ejtype else None)
        self.w_traj = (W.TrajWriter(j("traj.dat"), fld, types_h)
                       if self.p_traj else None)
        self.w_bindtraj = None
        self.p_bindtraj = 0
        if ctl.bindtraj_nucl and ctl.bindtraj_freq:
            nid = {nm: i for i, nm in enumerate(fld.nnames)}
            k = nid.get(ctl.bindtraj_nucl)
            if k is not None:
                nucl_of = np.array([fld.species[t].nuclei for t in types_h])
                self.bindtraj_idx = np.flatnonzero(nucl_of == k)
                if len(self.bindtraj_idx):
                    self.p_bindtraj = ctl.bindtraj_freq
                    self.w_bindtraj = W.BindTrajWriter(
                        j("traj_bnd.dat"), len(self.bindtraj_idx))
        self.p_hist = ctl.hist
        self.w_hist = W.HistWriter(j("hist.dat")) if ctl.hist else None
        self.p_vaf = ctl.vaf
        self.w_vaf = (W.VafWriter(j("vaf.dat"), fld, vel_h, types_h,
                                  cfg.n_spec) if ctl.vaf else None)
        self.w_msdd = W.MsdDisplWriter(j("msd_d.dat"), fld, pos_h, types_h,
                                       cfg.box, cfg.n_spec)

        # --- RDF ---
        m_min = min([sp.mass for sp in fld.species if sp.mass > 0],
                    default=0.0)
        self.rcfg = ops_rdf.make_rdf_config(ctl, cfg, pos=pos_h, m_min=m_min)
        self.rdf_count = 0
        self._rdf_last = None        # last written (hist, nhist, count)
        self.hist = self.nhist = None
        if self.rcfg is not None:
            self.hist, self.nhist = ops_rdf.zero_hist(self.rcfg,
                                                      device=self.device)
            spec_nuclei = np.array([s.nuclei for s in fld.species], np.int32)
            nucl_number = np.zeros(max(cfg.n_nucl, 1), np.int64)
            for t in types_h:
                nucl_number[spec_nuclei[t]] += 1
            self._spec_nuclei = torch.as_tensor(spec_nuclei,
                                                device=self.device)
            self._nucl_number = torch.as_tensor(
                nucl_number.astype(np.int32), device=self.device)
        # the host-visible periods of the JAX runner's stat ring
        # (runner.py:193-196): the two-level cadence needs each to be a
        # multiple of the stat period
        self._host_periods = [p for p in (
            self.p_traj, self.p_revcon, self.p_bindtraj, self.p_hist,
            self.p_vaf, checkpoint_every, self.p_rdf_out) if p]
        # the JAX stat ring's gate (runner.py:193-199): whole stat periods,
        # with their RDF blocks, between host events; AZTOTMD_NO_RING
        # takes the host loop, as in JAX
        self.ring_ok = self.p_stat > 0 and all(
            p % self.p_stat == 0 for p in self._host_periods) \
            and not os.environ.get("AZTOTMD_NO_RING")
        if self.rcfg is not None and self.p_rdf:
            self.ring_ok = self.ring_ok and self.p_stat % self.p_rdf == 0
        self._ring_plan = {}
        self.s_cap = 1
        if self.ring_ok:
            # the stat periods of one ring window, at most: the
            # superblocks of the plan restart at each window
            target = int(os.environ.get("AZTOTMD_RING_STEPS", "8000"))
            self.s_cap = max(1, min(512, target // self.p_stat or 1))
            dev_cfg = sysd.get("dev")
            if dev_cfg is not None and dev_cfg.nstep_stat != 10:
                self.s_cap = max(1, min(512, dev_cfg.nstep_stat))
            self._spec_counts0 = np.bincount(types_h, minlength=cfg.n_spec)
            (self._fsl, self._nf, self._isl, self._ni) = \
                statring.make_layout(cfg.n_spec, max(cfg.n_bond_types, 1))
            self._host_rows = statring.HostRows(self._nf, self._ni,
                                                self.s_cap, self.device)
            if self.comm is not None:
                # the mesh ring's MSD reads a gid-keyed table of pos0
                self._pos0_h = self.state.pos0.cpu().numpy()
        self.n_dispatch = 0      # step-advancing host dispatches
        self.n_flush = 0         # ring windows decoded (_flush_rows)
        self.n_regrow = 0        # list regrows (_reset_lists)

        self._view_cache = None
        if self._atoms_mesh is not None:
            # the run carries the row shards; _view() and mdstate() gather
            self.state = self._shard(self.state)
        if self.comm is not None:
            from ..parallel import slab as _slab
            # keep the MDState as the template of mesh-independent
            # checkpoints; the run carries the slab state
            self._mdstate_template = self.state
            self._slab_cap_factor = 1.6
            self._slab_spec_number = np.bincount(
                types_h, minlength=cfg.n_spec).astype(np.int32)
            self._slab_mig_seen = (0, 0)
            self._defer_hits = 0
            self._bond_miss_seen = 0
            self.state = _slab.make_slab_state(
                cfg, self.state, self.comm, cap_factor=self._slab_cap_factor)
        # the escalating skin monitor's record (_check_neighbor_monitors)
        self._viol_seen = 0
        self._viol_hits = 0
        self._skin_grown = 0
        self._build_programs()
        self._route_note = None
        self._note_route()
        self.loop_seconds = 0.0
        self.steps_run = 0
        self._t0 = time.time()

    def _build_programs(self):
        """(Re)build the step loop and the RDF samples from the current
        cfg: at init and after a capacity regrow.  On the card every
        program and sample is captured as a CUDA graph at its first call
        (``self.graph``, as ``make_multi_step``'s ``graph``), so a rebuild
        recaptures."""
        cfg, rcfg = self.cfg, self.rcfg
        if self.comm is not None:
            # the slab mesh: its stat ring where the gate holds, the chunk
            # loop elsewhere (JAX's slab ring has no RDF list)
            from ..parallel import slab as _slab
            self.refine_blocks = self.fuse_rdf = self.use_list = False
            self.multi = _slab.make_slab_multi_step(cfg, self.aux, self.comm,
                                                    graph=self.graph)
            if rcfg is not None:
                self._rdf = GraphedSample(
                    _slab.make_slab_rdf_sample(cfg, rcfg, self.comm,
                                               self._spec_nuclei,
                                               self._nucl_number),
                    "mesh RDF sample", self.multi.graph)
            if self.ring_ok:
                self._ring_fn = _slab.make_slab_ring(
                    cfg, self.aux, self.comm, rcfg,
                    self._spec_nuclei if rcfg is not None else None,
                    self._nucl_number if rcfg is not None else None,
                    self.p_stat, self.p_rdf if rcfg is not None else 0,
                    self._spec_counts0, self._pos0_h, multi=self.multi,
                    sample=getattr(self, "_rdf", None), cap=self.s_cap)
                # one set of programs: the ring's holds the step
                self.multi = self._ring_fn.multi
            return
        if self._atoms_mesh is not None:
            from ..parallel import mesh as _mesh
            self.multi = _mesh.make_sharded_multi_step(
                cfg, self.aux, self._atoms_mesh, self._atoms_spec,
                graph=self.graph)
        else:
            self.multi = make_multi_step(cfg, self.aux, graph=self.graph)
        if rcfg is not None:
            self._rdf = GraphedSample(
                self._sampler(ops_rdf.rdf_sample), "RDF sample",
                self.multi.graph)
        self._plan_programs(cfg, rcfg)
        if self.ring_ok:
            # the stat row of each period into the device ring: over the
            # gathered rows of an atom-sharded run
            self._rows = statring.RowRing(self._nf, self._ni, self.s_cap,
                                          self.device)
            stat_row = statring.make_stat_row(cfg, self._spec_counts0)
            base = self.multi
            self.multi = MultiStep(
                dict(base.fns, row=self._rows.program(
                    lambda s: stat_row(self._gather(s))),
                    ring_reset=self._rows.reset),
                base.graph, base.R, base.Q)

    def _sampler(self, fn, *lists):
        """An RDF sample ``(state, hist, nhist) -> (hist, nhist)`` of
        ``fn(cfg, rcfg, pos, types, spec_number, spec_nuclei,
        nucl_number, *lists, hist, nhist)`` over the (gathered) state;
        each of ``lists`` is a state field name or a tensor."""
        cfg, rcfg = self.cfg, self.rcfg

        def sample(st, h, nh):
            st = self._gather(st)
            args = [getattr(st, a) if isinstance(a, str) else a
                    for a in lists]
            return fn(cfg, rcfg, st.pos, st.types, st.spec_number,
                      self._spec_nuclei, self._nucl_number, *args, h, nh)
        return sample

    def _program(self, fn):
        """A state program ``fn(state, ff) -> state`` of the one-device
        state, over the row shards of an atom-sharded run."""
        if self._atoms_mesh is None:
            return fn
        from ..parallel import mesh as _mesh
        return _mesh.sharded(fn, self._atoms_mesh, self._atoms_spec)

    def _plan_programs(self, cfg, rcfg):
        """The JAX stat ring's plan (``aztotmd_tpu/runtime/runner.py:
        328-452``), kept in ``self._ring_plan`` with its keys, and the
        programs and samples it runs.  ``fuse_rdf``: RDF blocks inside the
        period; ``use_list``: the RDF sampled from an (N, k_cap) list
        built each period (``rdf_list_cfg``); ``refine_blocks``: on the
        two-level Verlet list, one full rebuild a period and an inner
        refine a block; ``rdf_covers_outer``: the RDF list's reach covers
        the outer list's, which is refined from it instead of rebuilt;
        ``rdf_from_outer``: the outer list serves the RDF for ``k_super``
        periods after one full rebuild, the RDF sampled from it.  JAX's
        ``rdf_rows`` (an opt-in row compaction of the outer list that JAX
        measured as a loss) is not ported: False, its caps 0."""
        p_stat, p_rdf = self.p_stat, self.p_rdf
        self.fuse_rdf = fuse_rdf = rcfg is not None and bool(p_rdf)
        self.use_list = use_list = bool(fuse_rdf and rcfg.k_cap > 0)
        self.refine_blocks = refine_blocks = bool(
            self.ring_ok and fuse_rdf and cfg.pair_engine == "neighbor"
            and cfg.nb_outer > 1 and p_rdf <= cfg.nb_rebuild
            and p_stat <= cfg.nb_outer * cfg.nb_rebuild)
        if not self.ring_ok:
            return
        r_rdf = math.sqrt(rcfg.r2_max) if rcfg is not None else 0.0
        covers = bool(refine_blocks and use_list
                      and r_rdf + rcfg.skin >= cfg.r_max + cfg.nb_skin2)
        from_outer, k_super = False, 1
        rho = cfg.nb_skin / max(cfg.nb_rebuild, 1)
        if refine_blocks and use_list and not covers:
            # pairs within r_rdf at any sample of k periods were within
            # r_rdf + rho*k*p_stat <= r_max + nb_skin2 at the rebuild
            slack = cfg.r_max + cfg.nb_skin2 - r_rdf
            k_rdf = int(slack / (rho * p_stat)) if slack > 0 else 0
            k_force = (cfg.nb_outer * cfg.nb_rebuild) // p_stat
            k_super = min(k_rdf, k_force)
            from_outer = k_super >= 1
        self._ring_plan = {
            "refine_blocks": refine_blocks, "rdf_covers_outer": covers,
            "rdf_from_outer": from_outer, "k_super": k_super,
            "rdf_rows": False, "rdf_rowcap": 0, "rdf_rowk": 0}
        N = cfg.n_at
        if from_outer:
            sample = self._sampler(ops_rdf.rdf_sample_list, "nbr2_idx")
        elif use_list:
            # the RDF list: a static buffer that the list program writes
            # and the samples read
            lcfg = ops_rdf.rdf_list_cfg(cfg, rcfg)
            use_sorted = ops_nbr.sorted_build_ok(lcfg)
            nbr_buf = torch.full((N, rcfg.k_cap), N, dtype=torch.int32,
                                 device=self.device)
            ocfg = dataclasses.replace(cfg, n_neigh=cfg.n_neigh2,
                                       nb_skin=cfg.nb_skin2)

            def rdf_list(s, ff):
                ops_rdf.rdf_counts["list_build"] += 1
                if use_sorted:
                    nbr, skey, nmax, _ = ops_nbr.build_neighbors_keys(
                        lcfg, s.pos)
                else:
                    nbr, nmax, _ = ops_nbr.build_neighbors(lcfg, s.pos)
                nbr_buf.copy_(nbr)
                s = s.replace(rdf_over=torch.maximum(s.rdf_over, nmax))
                if not covers:
                    return s
                # the outer list refined from the RDF list (the first
                # inner refine of the period derives the inner one)
                if use_sorted:
                    idx2, nmax2 = ops_nbr.prefix_refine(
                        nbr, skey, cfg.r_max + cfg.nb_skin2, cfg.n_neigh2,
                        N)
                else:
                    idx2, nmax2 = ops_nbr.refine_neighbors(ocfg, s.pos, nbr)
                return s.replace(nbr2_idx=idx2, nbr2_over=torch.maximum(
                    s.nbr2_over, nmax2))
            base = self.multi
            self.multi = MultiStep(
                dict(base.fns, rdf_list=self._program(rdf_list)),
                base.graph, base.R, base.Q)
            sample = self._sampler(ops_rdf.rdf_sample_list, nbr_buf)
        if use_list:
            self._rdf_plan = GraphedSample(sample, "RDF list sample",
                                           self.multi.graph)

    def _note_route(self):
        """One line on stderr when a run on the card will take the torch
        cell-block engine (or, on a mesh, the slab stencil pass in torch
        ops) instead of a kernel, with the reason; again only when a
        regrow changes it."""
        note = None
        if self.device.type == "cuda":
            if self.comm is not None:
                if self.cfg.pair_engine != "pallas" \
                        or self.cfg.dtype == "f64":
                    note = ("the slab mesh takes its cell-block stencil "
                            "pass for this deck (f64, a reactive deck, or a "
                            "deck not on the pallas/sparse engine)")
            else:
                note = torch_engine_reason(self.cfg, self.state.pos.dtype)
        if note and note != self._route_note:
            engine = ("slab stencil pass in torch ops" if self.comm is not None
                      else "torch cell-block engine")
            print(f"NOTE: the pair pass runs the {engine} on the card, not "
                  f"a CUDA kernel: {note}", file=sys.stderr)
        self._route_note = note

    # ------------------------------------------------------------------
    def run(self, n_steps: int | None = None):
        """Advance to ``n_steps`` (default: the deck's nstep); Ctrl-C stops
        after the current chunk and finalize() still writes the outputs."""
        total = n_steps if n_steps is not None else self.ctl.n_step
        done = int(self.state.step)
        self.timer.begin(self._counters())
        t_loop = time.perf_counter()
        try:
            self._run_loop(total, done)
        except KeyboardInterrupt:
            print(f"interrupted at step {int(self.state.step)}; writing "
                  "final outputs", file=sys.stderr)
        self._staged("wait", self._sync)
        wall = time.perf_counter() - t_loop
        self.loop_seconds += wall
        steps = int(self.state.step) - done
        self.steps_run += steps
        self.timer.end(steps, wall, self._counters(),
                       pair_pass=self.pair_pass())
        if self.profile:
            n = max(total - done, 1)
            print(f"loop wall: {wall:.1f} s for {n} steps "
                  f"({n / wall:.1f} steps/s)", file=sys.stderr)
            print(self.timer.report(), file=sys.stderr)
        return self.state

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _counters(self):
        """The counters of a call's record, as totals: list regrows,
        captures, each program's graph launches, and each kernel
        wrapper's launches as "<module>.<counter>" (``rdf.launches``)."""
        return {"regrow": self.n_regrow,
                "captures": sum(graph_mod.capture_counts.values()),
                **graph_mod.launch_counts,
                **{f"{h.__name__.rsplit('.', 1)[-1]}.{k}": getattr(h, k)
                   for h, k in graph_mod.launch_counters()
                   if not isinstance(h, dict)}}

    def pair_pass(self) -> str:
        """The pair pass the step runs now, in words (``runtime/step.py::
        pair_pass``; on the slab mesh its dense pass K2 or its stencil
        pass in torch ops), for the call's record."""
        if self.comm is not None:
            if self.cfg.pair_engine == "pallas" and self.cfg.dtype != "f64":
                return "slab dense (K2)"
            return "slab stencil (torch ops)"
        return pair_pass(self.cfg, self.state.pos.dtype, self.device.type)

    def _run_loop(self, total, done):
        if self.ring_ok:
            return self._run_loop_ring(total, done)
        while done < total:
            n = min(self.chunk, total - done)
            self._staged("steps", self._advance, n)
            done += n
            self._staged("sampling", self._sample, done)
            if self.rcfg is not None and self.rdf_in_chunk \
                    and self.rdf_count > 500:
                self._zero_hist()
            if self.debug and self.comm is None:
                from .debug import assert_state_ok
                assert_state_ok(self.cfg, self._view())

    def _run_loop_ring(self, total, done):
        """The JAX stat ring's loop (``aztotmd_tpu/runtime/runner.py:
        647-730``): windows of ``n_fix`` stat periods between host events,
        each enqueued as the plan's programs with one stat row a period
        into the device ring (``_ring``) and one copy of its rows to the
        host (``HostRows.fetch``); window k's rows are decoded
        (``_flush_rows``) only after window k+1 is enqueued, so the
        monitors, and any regrow, come one window late, as in JAX.  A
        tail shorter than a period runs as the chunk loop runs it; the
        RDF window's overfill reset comes after a window (unless it ends
        on an rdfN.dat step) and after host events.  Every host event and
        the loop's end flush first."""
        p = self.p_stat
        pending = None
        try:
            # JAX's one window size: it divides every host-event gap (the
            # gcd of the host periods, the total and the resume point)
            w = _gcd_all(list(self._host_periods) + [total, done])
            w_samp = (w // p) if (w and w % p == 0) else 1
            n_fix = max(d for d in range(1, min(self.s_cap, w_samp) + 1)
                        if w_samp % d == 0)
            self.n_fix = n_fix
            while done < total:
                nxt = self._next_host_event(done, total)
                while nxt - done >= p:
                    self.n_dispatch += 1
                    rows = self._staged("steps", self._ring, n_fix)
                    done += n_fix * p
                    if pending is not None:
                        self._flush_rows(pending)
                    pending = rows
                    if (self.rcfg is not None and self.rdf_count > 500
                            and not (self.p_rdf_out
                                     and done % self.p_rdf_out == 0)):
                        self._zero_hist()
                if pending is not None:
                    self._flush_rows(pending)
                    pending = None
                if done < nxt:
                    self._staged("steps", self._advance, nxt - done)
                    done = nxt
                self._staged("sampling", self._sample_rest, done)
                if self.rcfg is not None and self.rdf_count >= 500:
                    self._zero_hist()
                if self.debug:
                    from .debug import assert_state_ok
                    assert_state_ok(self.cfg, self._view())
        finally:
            if pending is not None:
                self._flush_rows(pending)

    def _staged(self, stage, fn, *args):
        """``fn(*args)`` in the timer's span ``stage``; spans never nest."""
        with self.timer.stage(stage):
            return fn(*args)

    def _next_host_event(self, done, total):
        nxt = total
        for p in self._host_periods:
            nxt = min(nxt, (done // p + 1) * p)
        return nxt

    def _ring(self, n: int):
        """One window of the ring (JAX's ``ring``): ``n`` stat periods on
        the plan, each followed by its stat row into the device ring (with
        ``rdf_from_outer`` a full rebuild starts each superblock of
        ``min(k_super, n)`` periods), then one copy of the n rows to the
        host.  Returns the pending host rows (``HostRows.fetch``)."""
        if self.comm is not None:
            (self.state, self.hist, self.nhist, fr, ir) = self._ring_fn(
                self.state, self.hist, self.nhist, self.ff, n)
            if self.rcfg is not None and self.p_rdf:
                self.rdf_count += n * (self.p_stat // self.p_rdf)
            return self._host_rows.fetch(fr, ir)
        run, current = self.multi.start(self.state, self.ff)
        run("ring_reset")
        self.state = current()
        plan = self._ring_plan
        k = min(plan["k_super"], n) if plan["rdf_from_outer"] else 1
        for j in range(n):
            self._ring_period(j % k == 0)
        return self._host_rows.fetch(*self._rows.rows(n))

    def _ring_period(self, full: bool):
        """One stat period on the plan, as the JAX ring's ``stat_block``
        (``runner.py:465-553``), and its stat row: ``full`` starts a
        superblock (``rdf_from_outer``)."""
        plan = self._ring_plan
        run, current = self.multi.start(self.state, self.ff)
        n_blocks = self.p_stat // self.p_rdf if self.fuse_rdf else 0
        if plan["rdf_from_outer"]:
            if full:
                run("rebuild")
        elif self.use_list:
            run("rdf_list")
        if not plan["rdf_from_outer"] and plan["refine_blocks"] \
                and not plan["rdf_covers_outer"]:
            run("rebuild")
        if not self.fuse_rdf:
            self.multi.schedule(run, self.p_stat)
        sample = self._rdf_plan if self.use_list else getattr(self, "_rdf",
                                                              None)
        for _ in range(n_blocks):
            if plan["refine_blocks"]:
                run("refine")
                run("step", self.p_rdf)
            else:
                self.multi.schedule(run, self.p_rdf)
            self.hist, self.nhist = sample(current(), self.hist, self.nhist)
        self.rdf_count += n_blocks
        run("row")
        self.state = current()

    def _flush_rows(self, pending):
        """Wait for one window's sample rows (span ``wait``), then decode
        them into the stat writers and read its monitors (span
        ``sampling``)."""
        fr, ir = self._staged("wait", self._host_rows.wait, pending)
        self._staged("sampling", self._flush_window, fr, ir)

    def _flush_window(self, fr, ir):
        """Decode one window's rows, then read its monitors (the max over
        its rows)."""
        self.n_flush += 1
        over = np.max(ir[:, self._isl["over"]], axis=0)
        self._decode_rows(fr, ir)
        self._check_monitors([int(v) for v in over])

    def _decode_rows(self, fr, ir):
        fsl, isl = self._fsl, self._isl
        nsp = self.cfg.n_spec
        for k in range(fr.shape[0]):
            f, i = fr[k], ir[k]
            step = int(i[isl["step"]][0])
            t = step * self.cfg.dt
            eng = dict(zip(statring.ENG_KEYS, f[fsl["eng"]].tolist()))
            press = float(f[fsl["press"]][0])
            n_bond = int(i[isl["nbond"]][0])
            self.w_stat.write_row(t, step, eng, f[fsl["pos_mom"]],
                                  f[fsl["neg_mom"]], press, i[isl["spec"]])
            cpos = i[isl["cpos"]].reshape(nsp, 3)
            cneg = i[isl["cneg"]].reshape(nsp, 3)
            if self.w_bnd:
                self.w_bnd.write_row(t, step, n_bond, i[isl["btc"]],
                                     f[fsl["bt_r"]], f[fsl["bt_lt"]])
            self.w_msd.write_row(t, step, cpos, cneg)
            if self.w_jmp:
                self.w_jmp.write_row(t, step, int(i[isl["njump"]][0]),
                                     int(i[isl["jpos"]][0]),
                                     int(i[isl["jneg"]][0]))
            self.w_msdd.write_row_msd(t, step, f[fsl["msd"]], cneg, cpos)
            if not self.quiet:
                self._console(step, eng, float(f[fsl["x1"]][0]), press,
                              n_bond)

    def _zero_hist(self):
        """Restart the RDF window, in place (the captured sample keeps its
        buffers)."""
        self.hist.zero_()
        if self.nhist is not None:
            self.nhist.zero_()
        self.rdf_count = 0

    def _advance(self, n: int):
        self.n_dispatch += 1
        if self.rcfg is not None and self.rdf_in_chunk:
            n_blocks, rem = divmod(n, self.p_rdf)
            for _ in range(n_blocks):
                self.state = self.multi(self.state, self.ff, self.p_rdf)
                self._rdf_sample()
            if rem:
                self.state = self.multi(self.state, self.ff, rem)
            self.rdf_count += n_blocks
        else:
            self.state = self.multi(self.state, self.ff, n)

    def _rdf_sample(self):
        """One RDF sample of the run's state into the histograms (the
        cell-candidate or all-pairs sampler, or the mesh's)."""
        self.hist, self.nhist = self._rdf(self.state, self.hist, self.nhist)

    # ------------------------------------------------------------------
    def _sample(self, step: int):
        if self.p_stat and step % self.p_stat == 0:
            self._stat_row(step)
        self._sample_rest(step)

    def _stat_row(self, step: int):
        """The host loop's stat row of ``step`` (JAX's ``_sample``, where
        the ring's gate fails or ``AZTOTMD_NO_RING`` is set): read from
        the state in its dtype, then the capacity monitors."""
        st = self._view()
        t = step * self.cfg.dt
        E = st.energies
        eng = {k: float(getattr(E, k)) for k in statring.ENG_KEYS}
        pos_mom = _host(st.pos_mom)
        neg_mom = _host(st.neg_mom)
        pressure = float(st.pressure)
        cross_pos = _host(st.cross_pos)
        cross_neg = _host(st.cross_neg)
        pos = _host(st.pos)
        n_bond = int(st.n_bond)
        self.w_stat.write_row(t, step, eng, pos_mom, neg_mom, pressure,
                              _host(st.spec_number))
        if self.w_bnd:
            self.w_bnd.write_row(t, step, n_bond, _host(st.bt_count),
                                 _host(st.bt_r_mean),
                                 _host(st.bt_lt_mean))
        self.w_msd.write_row(t, step, cross_pos, cross_neg)
        if self.w_jmp:
            self.w_jmp.write_row(t, step, int(st.n_jump),
                                 int(st.jump_pos), int(st.jump_neg))
        self.w_msdd.write_row(t, step, pos, cross_neg, cross_pos)
        if not self.quiet:
            self._console(step, eng, float(pos[0, 0]), pressure, n_bond)
        self._check_monitors(self._monitors())

    def _monitors(self):
        """The state's capacity monitors, in the order of the stat row's
        over slots (``statring.OVER_KEYS``; on the slab mesh
        ``slab.SLAB_OVER_KEYS``): the host loop's read."""
        if self.comm is not None:
            from ..parallel.slab import SLAB_OVER_KEYS as keys
        else:
            keys = statring.OVER_KEYS
        return [int(getattr(self.state, k)) for k in keys]

    def _check_monitors(self, over):
        """Check the monitors of the over slots: a window's max over its
        rows (the ring) or the state's (``_monitors``, the host loop).
        The slab rows carry the slab health monitors there
        (``parallel/slab.py::_make_local_stat_row``)."""
        if self.comm is not None:
            return self._check_slab_health(*over[:4])
        self._check_overflow(*over)

    def _check_overflow(self, occ, nbr_over, nbr_viol, nbrow_over,
                        nbr2_over, rdf_over, orow_over):
        """The capacity monitors, in the order of ``statring.OVER_KEYS``,
        with the JAX runner's formulas and warnings; a regrow rebuilds
        the programs.

        Block-sparse engine in f32: ``cell_overflow`` (``occ``) carries
        the tile-pair worklist length the steps needed; past
        ``sparse_pair_cap`` those steps lost tile pairs.  Every other case
        (the block engine, the pallas engine, and the sparse engine in
        f64, which runs the cell-block engine): it is the fullest cell's
        occupancy (0 from the dense pass); past ``grid.cap`` those steps
        dropped atoms.  A new ``cap`` changes the modeled block cost, so
        the pallas dispatcher may take another branch afterwards.  The
        Verlet-list engine reads its list monitors first, and its
        occupancy is that of ``nb_grid``."""
        if self.cfg.pair_engine == "neighbor":
            self._check_neighbor_monitors(nbr_viol, nbr_over, nbrow_over,
                                          nbr2_over, orow_over)
        self._check_rdf_monitor(rdf_over)
        cfg = self.cfg
        if cfg.pair_engine == "sparse" and cfg.dtype != "f64":
            if occ > cfg.sparse_pair_cap:
                new_cap = _round_up(occ + max(64, occ // 4), 64)
                print(f"WARNING: sparse tile-pair count {occ} exceeded "
                      f"capacity {cfg.sparse_pair_cap}; rebuilding with "
                      f"pair_cap={new_cap}", file=sys.stderr)
                self.cfg = dataclasses.replace(cfg, sparse_pair_cap=new_cap)
                self._build_programs()
            return
        # the Verlet-list engine bins on its own grid, nb_grid
        key = "nb_grid" if cfg.pair_engine == "neighbor" else "grid"
        g = getattr(cfg, key)
        if occ > g.cap:
            new_cap = _round_up(occ + max(2, occ // 4), 4)
            print(f"WARNING: cell occupancy {occ} exceeded capacity "
                  f"{g.cap}; rebuilding with cap={new_cap}",
                  file=sys.stderr)
            self.cfg = dataclasses.replace(
                cfg, **{key: dataclasses.replace(g, cap=new_cap)})
            self._build_programs()
            self._note_route()

    def _reset_lists(self, **cap):
        """Replace ``cfg``'s list capacities ``cap``, give the state empty
        lists of the new shapes and a reference position that forces a
        rebuild, and rebuild the step."""
        self.n_regrow += 1
        self.cfg = cfg = dataclasses.replace(self.cfg, **cap)
        N = cfg.n_at
        full = lambda *shape: torch.full(shape, N, dtype=torch.int32,
                                         device=self.device)
        upd = {}
        if "n_neigh" in cap:
            upd["nbr_idx"] = full(N, cfg.n_neigh)
        if cfg.nb_rowcap and ("n_neigh" in cap or "nb_rowcap" in cap):
            # nbrow rows carry [atom id | K neighbor ids]
            upd["nbrow_idx"] = full(cfg.nb_rowcap, 1 + cfg.n_neigh)
        if "n_neigh2" in cap:
            upd["nbr2_idx"] = full(N, cfg.n_neigh2)
        if "nb_orowcap" in cap:
            upd["orow_idx"] = full(cfg.nb_orowcap)
        st = self._gather(self.state)
        self.state = self._shard(st.replace(nbr_ref=st.nbr_ref + 1e9, **upd))
        self._view_cache = None
        self._build_programs()

    def _check_neighbor_monitors(self, viol, over, rover, over2, oover):
        """The Verlet-list monitors, with the JAX runner's formulas and
        warnings: the escalating skin monitor (``viol``), then the inner
        neighbor count (K, ``over``), the occupied rows (nb_rowcap,
        ``rover``), the outer-occupied rows (nb_orowcap, ``oover``) and
        the outer count (K2, ``over2``)."""
        if viol and viol > self._viol_seen:
            # warn on the first window of violations, react if they keep
            # accruing at later checks
            self._viol_seen = viol
            self._viol_hits += 1
            if self._viol_hits == 1:
                print(f"WARNING: {viol} neighbor-skin violations so far; "
                      "will thicken nb_skin if they keep accruing",
                      file=sys.stderr)
            else:
                self._escalate_skin(viol)
        if over > self.cfg.n_neigh:
            new_k = _round_up(over + max(4, over // 4), 4)
            print(f"WARNING: neighbor count {over} exceeded capacity "
                  f"{self.cfg.n_neigh}; rebuilding with K={new_k}",
                  file=sys.stderr)
            self._reset_lists(n_neigh=new_k)
        if self.cfg.nb_rowcap:
            if rover > self.cfg.nb_rowcap:
                new_cap = min(_round_up(rover + max(128, rover // 4), 128),
                              self.cfg.n_at)
                print(f"WARNING: occupied-row count {rover} exceeded row "
                      f"capacity {self.cfg.nb_rowcap}; rebuilding with "
                      f"rowcap={new_cap}", file=sys.stderr)
                self._reset_lists(nb_rowcap=new_cap)
        if self.cfg.nb_orowcap:
            if oover > self.cfg.nb_orowcap:
                new_cap = min(_round_up(oover + max(128, oover // 4), 128),
                              self.cfg.n_at)
                print(f"WARNING: outer-occupied row count {oover} exceeded "
                      f"capacity {self.cfg.nb_orowcap}; rebuilding with "
                      f"orowcap={new_cap}", file=sys.stderr)
                self._reset_lists(nb_orowcap=new_cap)
        if self.cfg.nb_outer > 1:
            if over2 > self.cfg.n_neigh2:
                new_k2 = _round_up(over2 + max(4, over2 // 4), 8)
                print(f"WARNING: outer neighbor count {over2} exceeded "
                      f"capacity {self.cfg.n_neigh2}; rebuilding with "
                      f"K2={new_k2}", file=sys.stderr)
                self._reset_lists(n_neigh2=new_k2)

    def _check_rdf_monitor(self, rover):
        """The RDF lists' monitor ``rdf_over``, with the JAX runner's
        formula and warning: the fullest
        row's count; past ``k_cap`` the list dropped pairs (and, with
        ``rdf_covers_outer``, so did the outer list refined from it)."""
        if self.rcfg is not None and self.rcfg.k_cap > 0:
            if rover > self.rcfg.k_cap:
                new_k = _round_up(rover + max(8, rover // 4), 8)
                print(f"WARNING: RDF-list neighbor count {rover} exceeded "
                      f"capacity {self.rcfg.k_cap}; rebuilding with "
                      f"k_cap={new_k}", file=sys.stderr)
                self.rcfg = dataclasses.replace(self.rcfg, k_cap=new_k)
                self._build_programs()

    def _escalate_skin(self, viol):
        """Skin violations kept accruing after the first warning: grow
        nb_skin 1.5x (and K by the reach-volume ratio), capped at the
        outer reach with the two-level list, where the cap instead halves
        nb_rebuild.  At most 3 reactions; after that a warning with the
        count each time."""
        cfg = self.cfg
        self._viol_hits = 0
        if self._skin_grown >= 3:
            print(f"WARNING: {viol} neighbor-skin violations and the "
                  "auto-escalation budget is spent; trajectory may miss "
                  "pairs — re-tune nb_skin/nb_rebuild", file=sys.stderr)
            return
        self._skin_grown += 1
        old = cfg.nb_skin
        new = old * 1.5
        if cfg.nb_outer > 1:
            # the inner reach r_max + nb_skin must stay within the outer
            new = min(new, cfg.nb_skin2)
        if new <= old + 1e-9:
            if cfg.nb_rebuild > 1:
                new_r = max(1, cfg.nb_rebuild // 2)
                print(f"WARNING: {viol} neighbor-skin violations keep "
                      f"accruing; shortening nb_rebuild "
                      f"{cfg.nb_rebuild} -> {new_r}", file=sys.stderr)
                self.cfg = dataclasses.replace(cfg, nb_rebuild=new_r)
                self._build_programs()
            else:
                print(f"WARNING: {viol} neighbor-skin violations with "
                      "nb_skin at the outer reach and per-step rebuilds; "
                      "re-tune nb_skin2/nb_outer", file=sys.stderr)
            return
        ratio = ((cfg.r_max + new) / (cfg.r_max + old)) ** 3
        new_k = _round_up(int(math.ceil(cfg.n_neigh * ratio)) + 4, 4)
        print(f"WARNING: {viol} neighbor-skin violations keep accruing; "
              f"growing nb_skin {old:.3f} -> {new:.3f} "
              f"(K {cfg.n_neigh} -> {new_k})", file=sys.stderr)
        self._reset_lists(nb_skin=new, n_neigh=new_k)

    def _sample_rest(self, step: int):
        """Non-stat sampling: hist/vaf/rdf/traj/revcon/checkpoint."""
        st = self._view()
        if self.w_hist and step % self.p_hist == 0:
            i1 = 1 if self.cfg.n_at > 1 else 0
            temp = 2.0 * float(st.energies.kin) / (
                units.KB * max(self.cfg.deg_free, 1))
            q1 = float(self.ff.spec_charge[int(st.types[1])]) \
                if self.cfg.n_at > 1 else 0.0
            self.w_hist.write_row(
                step * self.cfg.dt, step, float(st.energies.tot), temp,
                float(st.pos[i1, 0]), float(st.pos[i1, 1]), q1,
                _host(st.neg_mom), _host(st.pos_mom))

        if self.w_vaf and step % self.p_vaf == 0:
            self.w_vaf.write_row(step * self.cfg.dt, step, _host(st.vel))

        if self.rcfg is not None and self.p_rdf and not self.rdf_in_chunk \
                and not self._ring_plan and step % self.p_rdf == 0:
            self._rdf_sample()
            self.rdf_count += 1
        if self.rcfg is not None and self.p_rdf_out \
                and step % self.p_rdf_out == 0:
            self._write_rdf(os.path.join(self.out_dir, f"rdf{step}.dat"))
        # overfill reset after any intermediate write at this step
        if self.rcfg is not None and not self.rdf_in_chunk \
                and self.rdf_count > 500:
            self._zero_hist()

        if self.w_traj and step >= self.ctl.st_traj \
                and step % self.p_traj == 0:
            self.w_traj.write_row(step * self.cfg.dt, step, _host(st.pos),
                                  _host(st.types), _host(st.parents))

        if self.w_bindtraj and step >= self.ctl.bindtraj_start \
                and step % self.p_bindtraj == 0:
            self.w_bindtraj.write_row(
                step * self.cfg.dt, step, self.bindtraj_idx,
                _host(st.pos), _host(st.types), _host(st.nbonds),
                _host(st.parents), self.cfg.box)

        if self.p_revcon and step % self.p_revcon == 0:
            self._write_revcon(suffix=str(step))

        if self.checkpoint_every and step % self.checkpoint_every == 0:
            save_checkpoint(os.path.join(self.out_dir, "checkpoint.npz"),
                            self.mdstate(), {"step": step})

    def _console(self, step, eng, x1, pressure, n_bond):
        parts = [f"{step} x1={x1:.2f}"]
        if self.cfg.elec_type:
            parts.append(f"C1={eng['coul1']:.3G}, C2={eng['coul2']:.3G}")
        if self.cfg.use_bnd == 2:
            parts.append(f"nBnd={n_bond}")
        if self.cfg.use_bnd:
            parts.append(f"bndEng={eng['bond']:.3G}")
        parts.append(f"Kin={eng['kin']:.3G} Vdw={eng['vdw']:.3G} "
                     f"Tot={eng['tot']:.3G} P={pressure:.0f}")
        if self.cfg.tstat_type == TSTAT_RADI:
            parts.append(f"U={eng['temp']:.3G}")
        print(" ".join(parts), flush=True)

    # ------------------------------------------------------------------
    def _write_rdf(self, path, final=False):
        if self.rcfg is None:
            return
        hist, nhist, count = self.hist, self.nhist, self.rdf_count
        if count == 0:
            if not (final and self._rdf_last is not None):
                return
            hist, nhist, count = self._rdf_last
        # copies: a CPU tensor's numpy() shares its memory, and the live
        # histograms are zeroed in place
        hist = hist.cpu().numpy().copy() if torch.is_tensor(hist) else hist
        gr = ops_rdf.normalize_rdf(self.rcfg, hist, count)
        W.write_rdf_file(path, self.rcfg, gr,
                         [s.name for s in self.fld.species])
        if self.rcfg.nuclei:
            nhist = (nhist.cpu().numpy().copy() if torch.is_tensor(nhist)
                     else nhist)
            ngr = ops_rdf.normalize_rdf(self.rcfg, nhist, count, nuclei=True)
            # rdfN.dat -> rdf_nN.dat beside it (in the file's name only: a
            # directory may hold "rdf" too)
            head, name = os.path.split(path)
            W.write_rdf_file(os.path.join(head, name.replace("rdf", "rdf_n",
                                                             1)),
                             self.rcfg, ngr, list(self.fld.nnames))
        self._rdf_last = (hist, nhist, count)

    def finalize(self):
        """End-of-run outputs."""
        st = self._view()
        fld, ctl, cfg = self.fld, self.ctl, self.cfg
        j = lambda p: os.path.join(self.out_dir, p)
        for w in (self.w_stat, self.w_bnd, self.w_msd, self.w_jmp,
                  self.w_traj, self.w_bindtraj, self.w_hist, self.w_vaf,
                  self.w_msdd):
            if w:
                w.close()
        self._write_rdf(j("rdf.dat"), final=True)

        pos = _host(st.pos)
        vel = _host(st.vel)
        types = _host(st.types)
        names = [fld.species[t].name for t in types]
        W.write_atoms_xyz(j("revcon.xyz"), names, pos, cfg.box)
        if cfg.use_bnd:
            nb = int(st.n_bond)
            at1 = st.bond_at1[:nb].cpu().numpy()
            at2 = st.bond_at2[:nb].cpu().numpy()
            bt = st.bond_type[:nb].cpu().numpy()
            W.write_bondlist(j("revbonds.txt"), at1, at2, bt)
            W.write_bond_lengths(j("lengths.dat"), fld, at1, at2, bt, pos,
                                 cfg.box)
        if cfg.use_angl:
            na = int(st.n_angle)
            W.write_anglelist(j("revangles.txt"),
                              st.ang_central[:na].cpu().numpy(),
                              st.ang_lig1[:na].cpu().numpy(),
                              st.ang_lig2[:na].cpu().numpy(),
                              st.ang_type[:na].cpu().numpy())
        W.write_velocities(j("velocities.dat"), fld, types, vel)
        if cfg.tstat_type == TSTAT_RADI:
            W.write_thermal_chars(j("tchars.dat"), fld, types,
                                  _host(st.engs), _host(st.radii))
        W.write_cn(j("CN.dat"), fld, ctl, types, pos, cfg.box)
        W.write_ncn(j("nCN.dat"), fld, ctl, types, pos, cfg.box)
        if not self.quiet:
            print(f"Finish. elapsed time: {time.time() - self._t0:.0f} s",
                  flush=True)

    def _write_revcon(self, suffix=""):
        st = self._view()
        types = _host(st.types)
        names = [self.fld.species[t].name for t in types]
        W.write_atoms_xyz(os.path.join(self.out_dir, f"revcon{suffix}.xyz"),
                          names, _host(st.pos), self.cfg.box)

    # ------------------------------------------------------------------
    # mesh mode

    def _shard(self, state):
        """An atom-sharded run's row shards of a single-device state,
        with the shardings derived anew from its shapes (a regrow changes
        the lists'); the state itself elsewhere."""
        if self._atoms_mesh is None:
            return state
        from ..parallel import mesh as _mesh
        self._atoms_spec = _mesh.state_shardings(self._atoms_mesh, state,
                                                 self.cfg.n_at)
        return _mesh.shard_state(self._atoms_mesh, state, self._atoms_spec)

    def _gather(self, state):
        """The single-device state of an atom-sharded run's ``state``
        (its rows gathered: views over a ``LocalRing``); the state itself
        elsewhere."""
        if self._atoms_mesh is None:
            return state
        from ..parallel import mesh as _mesh
        return _mesh.gather_state(self._atoms_mesh, state, self._atoms_spec)

    def _view(self):
        """What the writers read: the MDState on one device, or of an
        atom-sharded run its rows gathered (once a step); on a slab mesh
        an MDState-shaped view whose per-atom arrays are gathered
        host-side in global-id order (once a step), whose replicated
        scalars are the slab state's, and whose topology is the replicated
        tables of a reactive deck or, on a constant-topology deck, the
        template's (they never change)."""
        if self._atoms_mesh is not None:
            step = int(self.state.step)
            if self._view_cache is None or self._view_cache[0] != step:
                self._view_cache = (step, self._gather(self.state))
            return self._view_cache[1]
        if self.comm is None:
            return self.state
        from types import SimpleNamespace
        from ..parallel import slab as _slab
        st = self.state
        step = int(st.step)
        if self._view_cache is not None and self._view_cache[0] == step:
            return self._view_cache[1]
        cfg = self.cfg
        g = _slab.gather_state(st, cfg.n_at, self.comm)
        nbt = max(cfg.n_bond_types, 1)
        z = np.zeros((), np.int32)
        rg = st.rg
        if rg is not None:
            topo, n_bond = rg, rg.n_bond
            rows = dict(spec_number=rg.spec_number, bt_count=rg.bt_count,
                        bt_r_mean=rg.bt_r_mean, bt_lt_mean=rg.bt_lt_mean,
                        n_jump=rg.n_jump, jump_pos=rg.jump_pos,
                        jump_neg=rg.jump_neg, parents=rg.parents,
                        nbonds=rg.nbonds)
        else:
            topo = self._mdstate_template if (cfg.use_bnd or cfg.use_angl) \
                else None
            n_bond = z
            if cfg.use_bnd:
                # each bond has a record on both sides
                live = self.comm.psum((st.bnd_type != 0).sum(
                    (1, 2), dtype=torch.int32))
                n_bond = np.asarray((int(live) + 1) // 2, np.int32)
            rows = dict(spec_number=self._slab_spec_number,
                        bt_count=np.zeros(nbt, np.int32),
                        bt_r_mean=np.zeros(nbt, np.float32),
                        bt_lt_mean=np.zeros(nbt, np.float32), n_jump=z,
                        jump_pos=z, jump_neg=z,
                        parents=np.full(cfg.n_at, -1, np.int32),
                        nbonds=np.zeros(cfg.n_at, np.int32))
        if topo is not None:
            # the finalize writers' bond and angle tables
            for k in ("bond_at1", "bond_at2", "bond_type", "ang_central",
                      "ang_lig1", "ang_lig2", "ang_type", "n_angle"):
                rows[k] = getattr(topo, k)
        view = SimpleNamespace(
            energies=st.energies, pos_mom=st.pos_mom, neg_mom=st.neg_mom,
            pressure=st.pressure, cross_pos=st.cross_pos,
            cross_neg=st.cross_neg, n_bond=n_bond, step=st.step, **rows,
            **g)
        self._view_cache = (step, view)
        return view

    def mdstate(self):
        """The run's state as a single-device MDState: the state itself,
        or on a mesh the slab state reassembled in global-id order, with a
        reactive deck's live topology tables (the mesh-independent
        checkpoint and the redistribution after a capacity regrow); of an
        atom-sharded run its rows gathered."""
        if self.comm is None:
            return self._gather(self.state)
        from ..parallel import slab as _slab
        from ..parallel.slab_react import merge_into_state
        st = self.state
        t = self._mdstate_template
        if st.rg is not None:
            # the live replicated topology supersedes the template's
            # initial tables (types come from the gathered slots, which the
            # step keeps in step with rg.types)
            t = merge_into_state(t, st.rg)
        dev = t.pos.device
        g = _slab.gather_state(st, self.cfg.n_at, self.comm)
        put = lambda a, like: torch.as_tensor(a).to(device=dev,
                                                    dtype=like.dtype)
        return t.replace(
            pos=put(g["pos"], t.pos), vel=put(g["vel"], t.vel),
            frc=put(g["frc"], t.frc), engs=put(g["engs"], t.engs),
            radii=put(g["radii"], t.radii), types=put(g["types"], t.types),
            # stale after redistribution: a list engine rebuilds
            nbr_ref=put(g["pos"], t.pos) + 1e9,
            rng=st.rng, step=st.step, chit=st.chit, consint=st.consint,
            energies=st.energies, pressure=st.pressure, pos_mom=st.pos_mom,
            neg_mom=st.neg_mom, mom_buf_pos=st.mom_buf_pos,
            mom_buf_neg=st.mom_buf_neg, i_mom=st.i_mom,
            cross_pos=st.cross_pos, cross_neg=st.cross_neg)

    def _check_slab_health(self, occ, lost, defer, miss):
        """The slab monitors, read at stat rows (the mesh's
        ``_check_overflow``, with the JAX runner's rules and warnings):
        grow grid.cap when a cell overflowed (atoms of rank >= cap got no
        pair force); warn when bond or angle records lost their partner
        (``bond_miss``); raise the slot capacity 1.5x and redistribute
        when a migration deleted atoms, or when deferrals kept accruing
        over three checks."""
        cfg = self.cfg
        rebuild = False
        if occ > cfg.grid.cap:
            new_cap = _round_up(occ + max(2, occ // 4), 4)
            print(f"WARNING: slab cell occupancy {occ} exceeded capacity "
                  f"{cfg.grid.cap}; rebuilding with cap={new_cap}",
                  file=sys.stderr)
            self.cfg = dataclasses.replace(
                cfg, grid=dataclasses.replace(cfg.grid, cap=new_cap))
            rebuild = True
        if miss > self._bond_miss_seen:
            print(f"WARNING: {miss} bond/angle records had partners "
                  "outside the +-1-slab reach (stretched topology; "
                  "their forces were dropped) — the trajectory is "
                  "suspect", file=sys.stderr)
            self._bond_miss_seen = miss
        seen = self._slab_mig_seen
        if (lost, defer) > seen:
            self._slab_mig_seen = (lost, defer)
            if lost > seen[0]:
                print(f"WARNING: slab migration DELETED {lost - seen[0]} "
                      "atoms (receiver slots full); raising capacity and "
                      "redistributing", file=sys.stderr)
                self._slab_cap_factor *= 1.5
                rebuild = True
            elif defer > seen[1]:
                self._defer_hits += 1
                hits = self._defer_hits
                if hits == 1:
                    print(f"WARNING: {defer} deferred slab migrations so "
                          "far (sender buffer full); atoms retry next "
                          "step but sit out one pair pass",
                          file=sys.stderr)
                elif hits >= 3:
                    print(f"WARNING: migrations still deferring after "
                          f"{hits} checks ({defer} total); raising "
                          "capacity and redistributing", file=sys.stderr)
                    self._slab_cap_factor *= 1.5
                    rebuild = True
        if rebuild:
            from ..parallel import slab as _slab
            md = self.mdstate()
            self._build_programs()
            self.state = _slab.make_slab_state(
                self.cfg, md, self.comm, cap_factor=self._slab_cap_factor)
            self._view_cache = None
            # the fresh state restarts its counters from zero
            self._slab_mig_seen = (0, 0)
            self._defer_hits = 0


def _host(a):
    """A numpy array of a tensor or of a host array."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def run_deck(deck_dir: str, out_dir: str = ".", n_steps: int | None = None,
             dtype: str = "f32", seed: int = 12345, quiet: bool = False,
             checkpoint_every: int = 0, device=None):
    """Load a reference deck directory and run it to completion, on the
    card unless ``device`` says otherwise (``default_device``)."""
    from .setup import default_device, load_deck_dir
    sysd = load_deck_dir(deck_dir, dtype=dtype, seed=seed,
                         device=default_device(device))
    runner = MDRunner(sysd, out_dir=out_dir, quiet=quiet,
                      checkpoint_every=checkpoint_every)
    runner.run(n_steps)
    runner.finalize()
    return runner
