"""System assembly: parsed decks -> (SimConfig, ForceField, MDState, aux)
(port of ``aztotmd_tpu/runtime/setup.py``, with the Ewald k-vector
table and constant energy of an Ewald deck).  Host init is NumPy with
the JAX package's draws in the same order, so both packages start from
the same state.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..io import (parse_atoms_file, parse_control_file,
                  parse_device_cfg_dir, parse_field_file)
from ..io.control import (ELEC_EWALD, INITVEL_CONST, INITVEL_ENG,
                          INITVEL_GAUSS, TSTAT_RADI, ControlSpec)
from ..io.toplists import parse_anglelist_file, parse_bondlist_file

from ..core.config import build_sim_config, device_pair_engine
from ..core.ffield import build_forcefield
from ..core.state import init_state
from ..ops.elec import ewald_self_energy, make_kvectors
from ..ops.thermostat import sample_photon_energies
from .step import StepAux


def _gauss_velocities(masses, te_kin, deg_free, rng):
    """Gaussian velocities, drift removed, scaled to the target kinetic
    energy."""
    n = len(masses)
    v = rng.normal(size=(n, 3)) / np.sqrt(masses)[:, None]
    v -= v.mean(axis=0, keepdims=True)
    kin = 0.5 * np.sum(masses[:, None] * v * v)
    if kin > 0:
        v *= np.sqrt(te_kin / kin)
    return v


def build_system(ctl: ControlSpec, fld, atoms, bonds=None, angles=None,
                 dtype: str = "f32", seed: int = 12345,
                 target_occupancy: float = 4.0, max_cells: int = 1 << 21,
                 extras: dict | None = None, pair_engine: str = "auto",
                 bond_equil_hack: bool = True, device=None):
    """Returns (cfg, ff, state, aux) with tensors on ``device``.

    ``extras`` receives host init byproducts (``vel0``, the NumPy initial
    velocities; ``cost_engine``, the cost model's engine, where the
    device's rule below changed it).  ``pair_engine="auto"`` takes the
    cost model's choice (the JAX package's) and then
    ``core/config.py::device_pair_engine`` for ``device``'s type: on a
    CUDA device a cell-block deck that the stacked kernel (K3) takes runs
    on ``"pallas"``.  ``bond_equil_hack`` False turns off the reference's
    zeroing of the velocities of reactive bond partners near force
    equilibrium (``cfg.bond_equil_hack``).
    """
    n_at = atoms.n_atoms
    types = np.array([fld.spec_id(nm) for nm in atoms.names])
    if any(t is None for t in types):
        raise ValueError("unknown atom species in atoms deck")
    types = types.astype(np.int32)

    n_bonds_init = bonds.n_bonds if bonds is not None else 0
    cfg = build_sim_config(ctl, fld, atoms.box, n_at,
                           n_bonds_init=n_bonds_init, dtype=dtype,
                           target_occupancy=target_occupancy,
                           max_cells=max_cells, pos=atoms.pos,
                           pair_engine=pair_engine)
    dev_type = torch.device(device).type if device is not None else "cpu"
    engine = device_pair_engine(cfg, dev_type, pair_engine)
    if engine != cfg.pair_engine:
        if extras is not None:
            extras["cost_engine"] = cfg.pair_engine
        cfg = dataclasses.replace(cfg, pair_engine=engine)
    if not bond_equil_hack:
        cfg = dataclasses.replace(cfg, bond_equil_hack=False)
    if ctl.elec.type == ELEC_EWALD:
        # the constant part of the Ewald sum needs the atoms' charges
        q = np.array([fld.species[t].charge for t in types])
        cfg = dataclasses.replace(
            cfg, eng_ewald_const=ewald_self_energy(q, cfg))
    tdt = cfg.torch_dtype
    ff = build_forcefield(fld, ctl.t_step, eps=ctl.elec.eps, dtype=tdt,
                          device=device)

    rng = np.random.default_rng(seed)
    masses = np.array([fld.species[t].mass for t in types])
    vel = None
    if ctl.init_vel == INITVEL_GAUSS:
        vel = _gauss_velocities(masses, cfg.te_kin, cfg.deg_free, rng)
    elif ctl.init_vel == INITVEL_CONST:
        vel = np.tile(np.asarray(ctl.init_vel_vec), (n_at, 1))
    elif ctl.init_vel == INITVEL_ENG:
        speed = np.sqrt(2.0 * ctl.init_vel_ekin / masses)
        u = rng.normal(size=(n_at, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        vel = speed[:, None] * u

    state = init_state(
        cfg, types, atoms.pos, vel=vel,
        parents=bonds.parents if bonds is not None else None,
        nbonds=bonds.nbonds if bonds is not None else None,
        bonds=bonds, angles=angles, seed=seed, device=device)
    if extras is not None:
        extras["vel0"] = vel

    aux = StepAux()
    if cfg.tstat_type == TSTAT_RADI:
        ph = sample_photon_energies(n_at, ctl.tstat.temp, rng)
        aux = StepAux(photons=torch.as_tensor(ph, dtype=tdt, device=device))
    if cfg.elec_type == ELEC_EWALD:
        rk, w = make_kvectors(cfg)
        aux = StepAux(photons=aux.photons,
                      rk=torch.as_tensor(rk, dtype=tdt, device=device),
                      kweights=torch.as_tensor(w, dtype=tdt, device=device))
    return cfg, ff, state, aux


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; None picks the current CUDA device
    and raises where there is none (``device="cpu"`` runs on the CPU).
    The package API (``load``, ``run``, ``run_deck``, ``entry``) takes its
    device from here."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("aztotmd_tpu_torch: no CUDA device is available; "
                           "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def load_deck_dir(path, dtype: str = "f32", seed: int = 12345,
                  device=None, **kw):
    """Load a deck directory (control.txt + field.txt + atoms.xyz
    [+ bonds.txt, angles.txt, cuda.txt])."""
    fld = parse_field_file(os.path.join(path, "field.txt"))
    ctl = parse_control_file(os.path.join(path, "control.txt"),
                             charged_spec=fld.charged_spec)
    atoms = parse_atoms_file(os.path.join(path, "atoms.xyz"))
    types = np.array([fld.spec_id(nm) for nm in atoms.names], dtype=np.int32)

    bonds = angles = None
    bpath = os.path.join(path, "bonds.txt")
    if fld.has_bond_list and os.path.exists(bpath):
        bonds = parse_bondlist_file(bpath, types, fld.bonds)
    apath = os.path.join(path, "angles.txt")
    if fld.has_angle_list and os.path.exists(apath):
        angles = parse_anglelist_file(apath, types, fld.angles)

    dev = parse_device_cfg_dir(path)
    extras: dict = {}
    cfg, ff, state, aux = build_system(ctl, fld, atoms, bonds, angles,
                                       dtype=dtype, seed=seed,
                                       extras=extras, device=device, **kw)
    return dict(cfg=cfg, ff=ff, state=state, aux=aux, ctl=ctl, fld=fld,
                atoms=atoms, dev=dev, bonds=bonds, angles=angles,
                vel0=extras.get("vel0"),
                cost_engine=extras.get("cost_engine"))
