"""The run orchestrator (port of the single-device chunk loop of
``aztotmd_tpu/runtime/runner.py``: ``_run_loop``, ``_advance``,
``_sample``, ``_sample_rest`` and ``finalize``).

Steps run in chunks sized to the greatest common divisor of the output
periods, so every sampling step lands on a chunk boundary.  RDF samples
are taken inside the chunk every ``fr_rdf`` steps, with the JAX runner's
sample steps and its reset of the histogram after 500 samples.  The
output files and their rows are the JAX runner's, with stat_bnd.dat and
jumps.dat for reactive decks and revbonds.txt and lengths.dat at the
end of a run with bonds.  At each stat row the
runner reads the engine's capacity monitor (the block-sparse worklist
length or the fullest cell's occupancy) and regrows the capacity
(``_check_overflow``).  The JAX package's on-device stat ring,
mesh, debug and profile paths are not ported.
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
from ..ops import rdf as ops_rdf
from .checkpoint import save_checkpoint
from .step import make_multi_step, torch_engine_reason

_ENG_KEYS = ("tot", "kin", "vdw", "coul1", "coul2", "bond", "angle", "temp")


def _gcd_all(values):
    g = 0
    for v in values:
        if v and v > 0:
            g = math.gcd(g, int(v))
    return g


class MDRunner:
    """Drive a loaded system to completion and write its output files."""

    def __init__(self, sysd: dict, out_dir: str = ".", quiet: bool = False,
                 checkpoint_every: int = 0, append: bool = False):
        self.cfg = cfg = sysd["cfg"]
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

        self.multi = make_multi_step(cfg, self.aux)
        self._route_note = None
        self._note_route()
        self.loop_seconds = 0.0
        self.steps_run = 0
        self._t0 = time.time()

    def _note_route(self):
        """One line on stderr when a run on the card will take the torch
        cell-block engine instead of a kernel, with the reason; again only
        when a regrow changes it."""
        note = None
        if self.device.type == "cuda":
            note = torch_engine_reason(self.cfg, self.state.pos.dtype)
        if note and note != self._route_note:
            print("NOTE: the pair pass runs the torch cell-block engine on "
                  f"the card, not a CUDA kernel: {note}", file=sys.stderr)
        self._route_note = note

    # ------------------------------------------------------------------
    def run(self, n_steps: int | None = None):
        """Advance to ``n_steps`` (default: the deck's nstep); Ctrl-C stops
        after the current chunk and finalize() still writes the outputs."""
        total = n_steps if n_steps is not None else self.ctl.n_step
        done = int(self.state.step)
        t_loop = time.perf_counter()
        try:
            self._run_loop(total, done)
        except KeyboardInterrupt:
            print(f"interrupted at step {int(self.state.step)}; writing "
                  "final outputs", file=sys.stderr)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.loop_seconds += time.perf_counter() - t_loop
        self.steps_run += int(self.state.step) - done
        return self.state

    def _run_loop(self, total, done):
        while done < total:
            n = min(self.chunk, total - done)
            self._advance(n)
            done += n
            self._sample(done)
            if self.rcfg is not None and self.rdf_in_chunk \
                    and self.rdf_count > 500:
                self.hist, self.nhist = ops_rdf.zero_hist(
                    self.rcfg, device=self.device)
                self.rdf_count = 0

    def _advance(self, n: int):
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
        st = self.state
        self.hist, self.nhist = ops_rdf.rdf_sample(
            self.cfg, self.rcfg, st.pos, st.types, st.spec_number,
            self._spec_nuclei, self._nucl_number, self.hist, self.nhist)

    # ------------------------------------------------------------------
    def _sample(self, step: int):
        if self.p_stat and step % self.p_stat == 0:
            st = self.state
            t = step * self.cfg.dt
            E = st.energies
            eng = {k: float(getattr(E, k)) for k in _ENG_KEYS}
            pos_mom = st.pos_mom.cpu().numpy()
            neg_mom = st.neg_mom.cpu().numpy()
            pressure = float(st.pressure)
            cross_pos = st.cross_pos.cpu().numpy()
            cross_neg = st.cross_neg.cpu().numpy()
            pos = st.pos.cpu().numpy()
            n_bond = int(st.n_bond)
            self.w_stat.write_row(t, step, eng, pos_mom, neg_mom, pressure,
                                  st.spec_number.cpu().numpy())
            if self.w_bnd:
                self.w_bnd.write_row(t, step, n_bond,
                                     st.bt_count.cpu().numpy(),
                                     st.bt_r_mean.cpu().numpy(),
                                     st.bt_lt_mean.cpu().numpy())
            self.w_msd.write_row(t, step, cross_pos, cross_neg)
            if self.w_jmp:
                self.w_jmp.write_row(t, step, int(st.n_jump),
                                     int(st.jump_pos), int(st.jump_neg))
            self.w_msdd.write_row(t, step, pos, cross_neg, cross_pos)
            if not self.quiet:
                self._console(step, eng, float(pos[0, 0]), pressure, n_bond)
            self._check_overflow()
        self._sample_rest(step)

    def _check_overflow(self):
        """The capacity monitors, read at stat rows, with the JAX
        runner's formulas and warnings; a regrow rebuilds the step.

        Block-sparse engine in f32: ``cell_overflow`` carries the
        tile-pair worklist length the steps needed; past
        ``sparse_pair_cap`` those steps lost tile pairs.  Every other
        case (the block engine, the pallas engine, and the sparse engine
        in f64, which runs the cell-block engine): ``cell_overflow`` is
        the fullest cell's occupancy (0 from the dense pass); past
        ``grid.cap`` those steps dropped atoms.  A new ``cap`` changes
        the modeled block cost, so the pallas dispatcher may take
        another branch afterwards."""
        cfg = self.cfg
        if cfg.pair_engine == "sparse" and cfg.dtype != "f64":
            need = int(self.state.cell_overflow)
            if need > cfg.sparse_pair_cap:
                new_cap = _round_up(need + max(64, need // 4), 64)
                print(f"WARNING: sparse tile-pair count {need} exceeded "
                      f"capacity {cfg.sparse_pair_cap}; rebuilding with "
                      f"pair_cap={new_cap}", file=sys.stderr)
                self.cfg = dataclasses.replace(cfg, sparse_pair_cap=new_cap)
                self.multi = make_multi_step(self.cfg, self.aux)
            return
        occ = int(self.state.cell_overflow)
        if occ > cfg.grid.cap:
            new_cap = _round_up(occ + max(2, occ // 4), 4)
            print(f"WARNING: cell occupancy {occ} exceeded capacity "
                  f"{cfg.grid.cap}; rebuilding with cap={new_cap}",
                  file=sys.stderr)
            self.cfg = dataclasses.replace(
                cfg, grid=dataclasses.replace(cfg.grid, cap=new_cap))
            self.multi = make_multi_step(self.cfg, self.aux)
            self._note_route()

    def _sample_rest(self, step: int):
        """Non-stat sampling: hist/vaf/rdf/traj/revcon/checkpoint."""
        st = self.state
        if self.w_hist and step % self.p_hist == 0:
            i1 = 1 if self.cfg.n_at > 1 else 0
            temp = 2.0 * float(st.energies.kin) / (
                units.KB * max(self.cfg.deg_free, 1))
            q1 = float(self.ff.spec_charge[int(st.types[1])]) \
                if self.cfg.n_at > 1 else 0.0
            self.w_hist.write_row(
                step * self.cfg.dt, step, float(st.energies.tot), temp,
                float(st.pos[i1, 0]), float(st.pos[i1, 1]), q1,
                st.neg_mom.cpu().numpy(), st.pos_mom.cpu().numpy())

        if self.w_vaf and step % self.p_vaf == 0:
            self.w_vaf.write_row(step * self.cfg.dt, step,
                                 st.vel.cpu().numpy())

        if self.rcfg is not None and self.p_rdf and not self.rdf_in_chunk \
                and step % self.p_rdf == 0:
            self._rdf_sample()
            self.rdf_count += 1
        if self.rcfg is not None and self.p_rdf_out \
                and step % self.p_rdf_out == 0:
            self._write_rdf(os.path.join(self.out_dir, f"rdf{step}.dat"))
        # overfill reset after any intermediate write at this step
        if self.rcfg is not None and not self.rdf_in_chunk \
                and self.rdf_count > 500:
            self.hist, self.nhist = ops_rdf.zero_hist(self.rcfg,
                                                      device=self.device)
            self.rdf_count = 0

        if self.w_traj and step >= self.ctl.st_traj \
                and step % self.p_traj == 0:
            self.w_traj.write_row(step * self.cfg.dt, step,
                                  st.pos.cpu().numpy(),
                                  st.types.cpu().numpy(),
                                  st.parents.cpu().numpy())

        if self.w_bindtraj and step >= self.ctl.bindtraj_start \
                and step % self.p_bindtraj == 0:
            self.w_bindtraj.write_row(
                step * self.cfg.dt, step, self.bindtraj_idx,
                st.pos.cpu().numpy(), st.types.cpu().numpy(),
                st.nbonds.cpu().numpy(), st.parents.cpu().numpy(),
                self.cfg.box)

        if self.p_revcon and step % self.p_revcon == 0:
            self._write_revcon(suffix=str(step))

        if self.checkpoint_every and step % self.checkpoint_every == 0:
            save_checkpoint(os.path.join(self.out_dir, "checkpoint.npz"),
                            st, {"step": step})

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
        hist = hist.cpu().numpy() if torch.is_tensor(hist) else hist
        gr = ops_rdf.normalize_rdf(self.rcfg, hist, count)
        W.write_rdf_file(path, self.rcfg, gr,
                         [s.name for s in self.fld.species])
        if self.rcfg.nuclei:
            nhist = nhist.cpu().numpy() if torch.is_tensor(nhist) else nhist
            ngr = ops_rdf.normalize_rdf(self.rcfg, nhist, count, nuclei=True)
            W.write_rdf_file(path.replace("rdf", "rdf_n", 1), self.rcfg,
                             ngr, list(self.fld.nnames))
        self._rdf_last = (hist, nhist, count)

    def finalize(self):
        """End-of-run outputs."""
        st = self.state
        fld, ctl, cfg = self.fld, self.ctl, self.cfg
        j = lambda p: os.path.join(self.out_dir, p)
        for w in (self.w_stat, self.w_bnd, self.w_msd, self.w_jmp,
                  self.w_traj, self.w_bindtraj, self.w_hist, self.w_vaf,
                  self.w_msdd):
            if w:
                w.close()
        self._write_rdf(j("rdf.dat"), final=True)

        pos = st.pos.cpu().numpy()
        vel = st.vel.cpu().numpy()
        types = st.types.cpu().numpy()
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
        W.write_velocities(j("velocities.dat"), fld, types, vel)
        if cfg.tstat_type == TSTAT_RADI:
            W.write_thermal_chars(j("tchars.dat"), fld, types,
                                  st.engs.cpu().numpy(),
                                  st.radii.cpu().numpy())
        W.write_cn(j("CN.dat"), fld, ctl, types, pos, cfg.box)
        W.write_ncn(j("nCN.dat"), fld, ctl, types, pos, cfg.box)
        if not self.quiet:
            print(f"Finish. elapsed time: {time.time() - self._t0:.0f} s",
                  flush=True)

    def _write_revcon(self, suffix=""):
        st = self.state
        types = st.types.cpu().numpy()
        names = [self.fld.species[t].name for t in types]
        W.write_atoms_xyz(os.path.join(self.out_dir, f"revcon{suffix}.xyz"),
                          names, st.pos.cpu().numpy(), self.cfg.box)
