"""Entry points of the port (the counterpart of the JAX package's
``__graft_entry__.py``):

``entry(device=None)``  -> (step, (state, ff)): the single-device MD step
                           on the flagship system, 4,096 argon atoms
                           (``systems.build_lj_argon``);
``dryrun_multichip(n, device=None)`` -> runs the multi-shard paths over
                           ``n`` shards and returns None, or raises.

Both run on the card unless ``device="cpu"``.  The JAX package runs its
dryrun in a subprocess to get ``n`` virtual CPU devices; a ``LocalRing``
holds any number of shards in this process, so the port needs none.

    python -m aztotmd_tpu_torch.entry [--cpu]
"""

from __future__ import annotations

import os

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def entry(device=None):
    """(step, (state, ff)) on ``build_lj_argon(n_atoms=4096)``."""
    from .runtime.setup import default_device
    from .runtime.step import make_step
    from .systems import build_lj_argon

    cfg, ff, state, aux = build_lj_argon(n_atoms=4096,
                                         device=default_device(device))
    return make_step(cfg, aux), (state, ff)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The multi-shard paths over a ``LocalRing`` of ``n_devices`` shards:
    (1) one atom-sharded step; (2) the domain-decomposed pair pass where
    the grid allows it; (3) ``run_domain_step_demo``; (4) a small argon
    deck through ``MDRunner`` over min(n, 4) slabs; (4b) the block-sparse
    engine under the atom-sharded step, forces equal to the one-device
    step's; (4c) the clustered system through 3 slab steps on the dense
    slab pass; (5) for n >= 3, examples/ejump_redox through the runner
    over 3 slabs (reactive topology on the mesh).  Raises on failure."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from .core.config import build_sim_config, make_block_grid
    from .core.ffield import build_forcefield
    from .core.state import init_state
    from .io.control import ControlSpec, ElecSpec, TStatSpec
    from .io.field import VDW_LJ, FieldSpec, SpeciesSpec, VdWSpec
    from .parallel import (has_domain_step, make_mesh, make_sharded_step,
                           pair_forces_domain, run_domain_step_demo)
    from .parallel import slab
    from .parallel.comm import LocalRing
    from .parallel.mesh import gather_state, state_shardings
    from .runtime.runner import MDRunner
    from .runtime.setup import default_device, load_deck_dir
    from .runtime.step import make_step
    from . import units
    from .systems import build_lj_argon, clustered_slab_system, write_lj_deck

    dev = default_device(device)
    n_at = max(128, 16 * n_devices)
    n_at += (-n_at) % n_devices
    cfg, ff, state, aux = build_lj_argon(n_atoms=n_at, density=0.012,
                                         device=dev)
    # 1) atom-sharded full MD step over the shards
    mesh = make_mesh(n_devices, device=dev)
    step, sstate, sff = make_sharded_step(cfg, aux, mesh, state, ff)
    sstate = step(sstate, sff)
    assert int(sstate.step) == 1
    # 2) spatial domain decomposition of the pair pass (x-slab halos)
    grid = make_block_grid(cfg.box, cfg.r_max, cfg.n_at)
    # floor to a shard multiple: shrinking ncx only grows the cell edge,
    # so the 27-point stencil stays sufficient
    ncx = (grid.dims[0] // n_devices) * n_devices
    grid = dataclasses.replace(
        grid, dims=(max(ncx, n_devices),) + grid.dims[1:],
        edge=(cfg.box[0] / max(ncx, n_devices),) + grid.edge[1:])
    if ncx >= n_devices and min(grid.dims[1:]) >= 3 and all(
            abs(o) <= 1 for off in grid.stencil for o in off):
        dcfg = dataclasses.replace(cfg, grid=grid)
        frc, _, _ = pair_forces_domain(dcfg, ff, state.pos, state.types,
                                       mesh)
        assert bool(torch.isfinite(frc).all())
    # 3) spatially sharded full step loop (slab ownership + migration)
    if has_domain_step():
        run_domain_step_demo(n_devices, device=dev)
    # 4) the runner in slab mode (run --mesh N): a small argon deck end
    # to end, the whole run one dispatch of the mesh's stat ring, as the
    # JAX dryrun asserts
    with tempfile.TemporaryDirectory() as td:
        deck = os.path.join(td, "deck")
        os.makedirs(deck)
        write_lj_deck(deck, n_side=6, box=28.0, steps=100)
        r = MDRunner(load_deck_dir(deck, dtype="f32", device=dev),
                     out_dir=os.path.join(td, "out"), quiet=True,
                     mesh_devices=min(n_devices, 4))
        r.run()
        r.finalize()
        assert int(r.state.mig_lost) == 0
        assert r.ring_ok and r.n_dispatch == 1, (r.ring_ok, r.n_dispatch)
    # 4b) the block-sparse pair engine under the atom-sharded step: one
    # sharded step, exactly the single-device step
    rng = np.random.default_rng(5)
    n_sp = max(256, 32 * n_devices)
    n_sp += (-n_sp) % n_devices
    ctrs = np.asarray([[20.0, 20, 20], [70.0, 70, 70], [20.0, 70, 20]])
    pos_sp = np.concatenate([
        c + rng.uniform(-8, 8, (n_sp // 3, 3)) for c in ctrs]
        + [rng.uniform(0, 90.0, (n_sp - 3 * (n_sp // 3), 3))]) % 90.0
    fsp = FieldSpec()
    fsp.species = [SpeciesSpec(name="S0", nuclei=0,
                               mass=39.9 * units.M_SCALE, charge=0.0,
                               energy=0.0)]
    fsp.nnames = ["S0"]
    fsp.nnumbers = [0]
    fsp.pairpots = [VdWSpec(type=VDW_LJ, spec1=0, spec2=0, r2cut=25.0,
                            p0=4 * 0.01, p1=3.4 * 3.4, p2=24 * 0.01)]
    fsp.vdw_index = [[0]]
    fsp.maxRvdw = 5.0
    sctl = ControlSpec(t_step=0.001, n_step=1,
                       tstat=TStatSpec(type=0, temp=100.0),
                       elec=ElecSpec(type=0, r_real=5.0))
    scfg = build_sim_config(sctl, fsp, (90.0,) * 3, n_sp, dtype="f32",
                            pos=pos_sp, pair_engine="sparse")
    sf = build_forcefield(fsp, sctl.t_step, dtype=torch.float32, device=dev)
    sst = init_state(scfg, np.zeros((n_sp,), np.int32),
                     pos_sp.astype(np.float32), device=dev)
    ref1 = make_step(scfg, None)(sst, sf)
    sstep, s2, sf2 = make_sharded_step(scfg, None, mesh, sst, sf)
    s2 = gather_state(mesh, sstep(s2, sf2),
                      state_shardings(mesh, sst, scfg.n_at))
    assert torch.equal(ref1.frc, s2.frc)
    # 4c) the dense rectangular slab pair pass (clustered decks under run
    # --mesh N take _pair_pass_dense): a clustered LJ system through the
    # slab step loop
    if n_devices >= 2:
        nd = min(n_devices, 4)
        dcfg, dff, dstate, daux = clustered_slab_system(n_dev=nd, device=dev)
        assert dcfg.pair_engine == "pallas"
        comm = LocalRing(nd, dev)
        ds = slab.make_slab_state(dcfg, dstate, comm)
        dout = slab.make_slab_multi_step(dcfg, daux, comm)(ds, dff, 3)
        assert int(dout.mig_lost) == 0
    # 5) reactive topology on the slab mesh (replicated tables, sharded
    # geometry): the ejump redox example end to end through the runner
    if n_devices >= 3:
        deck = os.path.join(EXAMPLES, "ejump_redox")
        with tempfile.TemporaryDirectory() as td:
            r = MDRunner(load_deck_dir(deck, dtype="f32", device=dev),
                         out_dir=td, quiet=True, mesh_devices=3)
            r.run(100)
            r.finalize()
            assert r.state.rg is not None
            assert int(r.state.mig_lost) == 0


def _entry_selftest(device=None) -> None:
    fn, args = entry(device)
    out = fn(*args)
    print("entry ok; energies.tot =", float(out.energies.tot))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the port's entry points")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("-n", type=int, default=4,
                    help="shards of dryrun_multichip (default 4)")
    a = ap.parse_args()
    dev = "cpu" if a.cpu else None
    _entry_selftest(dev)
    dryrun_multichip(a.n, device=dev)
    print(f"dryrun_multichip({a.n}) ok")
