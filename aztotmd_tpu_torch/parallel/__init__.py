"""Multi-shard execution (port of ``aztotmd_tpu/parallel/``), over the
communicators of ``comm.py`` (``LocalRing``: every shard in one process on
one device; ``DistRing``: one a rank over ``torch.distributed``):

* **atom-sharded** (``mesh.py``): per-atom arrays in equal row shards, the
  unchanged one-device step over their gather; every feature, reactive
  topology included;
* **slab decomposition** (``slab.py``): x-slabs of the cell grid owning
  their atoms, with migration, the constant-topology records and, for
  reactive decks, the replicated topology of ``slab_react.py``;
* **domain decomposition of the pair pass** (``domain.py``): x-slabs of
  the cell grid with a halo exchange over replicated positions.
"""

from .comm import DistRing, LocalRing, init_dist, make_comm
from .domain import pair_forces_domain
from .mesh import (ff_shardings, make_mesh, make_sharded_step, shard_system,
                   state_shardings)


def has_domain_step() -> bool:
    """True: the spatially sharded full step loop is ``slab.py``."""
    return True


def run_domain_step_demo(n_devices: int, device=None) -> None:
    """The slab-ownership step loop with migration over a ``LocalRing``
    of ``n_devices`` slabs on ``device`` (the card when None): a small
    argon system distributed by x-slab, 20 steps; the atoms must survive
    and the step counter advance.  Returns without running where the box
    is too small for ``n_devices`` slabs."""
    import dataclasses

    import numpy as np

    from . import slab
    from ..core.config import make_block_grid
    from ..runtime.setup import default_device
    from ..systems import build_lj_argon

    n_at = max(128, 16 * n_devices)
    cfg, ff, state, aux = build_lj_argon(n_atoms=n_at, density=0.012,
                                         device=default_device(device))
    grid = make_block_grid(cfg.box, cfg.r_max, cfg.n_at)
    ncx = max((grid.dims[0] // n_devices) * n_devices, n_devices)
    grid = dataclasses.replace(grid, dims=(ncx,) + grid.dims[1:],
                               edge=(cfg.box[0] / ncx,) + grid.edge[1:])
    if min(grid.dims) < 3 or any(abs(o) > 1 for off in grid.stencil
                                 for o in off):
        return                       # box too small for n_devices slabs
    cfg = dataclasses.replace(cfg, grid=grid, pair_engine="block")
    comm = LocalRing(n_devices, state.pos.device)
    sstate = slab.make_slab_state(cfg, state, comm)
    out = slab.make_slab_multi_step(cfg, aux, comm)(sstate, ff, 20)
    g = slab.gather_state(out, cfg.n_at, comm)
    assert int(out.step) == int(state.step) + 20
    assert int(out.mig_lost) == 0
    assert np.isfinite(g["pos"]).all()
    n_live = int((out.gid >= 0).sum())
    assert n_live == cfg.n_at, f"lost atoms: {n_live}/{cfg.n_at}"


__all__ = ["make_mesh", "state_shardings", "ff_shardings",
           "make_sharded_step", "shard_system", "pair_forces_domain",
           "has_domain_step", "run_domain_step_demo", "DistRing",
           "LocalRing", "init_dist", "make_comm"]
