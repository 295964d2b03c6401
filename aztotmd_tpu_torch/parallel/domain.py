"""Spatial domain decomposition of the pair pass with a halo exchange
(port of ``aztotmd_tpu/parallel/domain.py``).

The box is split into x-slabs of the cell grid, one per slab of the
communicator (``parallel/comm.py``; the JAX package's ``x`` mesh axis).
Each slab bins the atoms that fall inside it into its block structure,
exchanges one boundary x-plane of blocks with each neighbour slab (the
periodic box shift on the wrap-around links), runs the 27-offset roll
pass on the extended slab (minimum image on y and z) and scatters its
forces back to atom order; ``psum`` adds the slabs' forces (each atom is
owned by exactly one slab) and energies.  That is the slab step's
stencil pass (``slab.stencil_pass``) over positions and types replicated
on every slab: the work and the cell structure are decomposed, not the
atoms.  As the JAX package's pass (XLA, no Pallas kernel), it is torch
ops; radius-dependent pairs are not evaluated, as there.
"""

from __future__ import annotations

import torch

from .slab import stencil_pass


def pair_forces_domain(cfg, ff, pos, types, comm):
    """Domain-decomposed pair forces over ``comm``'s slabs: (frc (N, 3),
    eng_vdw, eng_coul), the same on every rank.  Requires
    ``cfg.grid.dims[0]`` divisible by the number of slabs and a 27-point
    stencil (cell edge >= cutoff, dims >= 3)."""
    ndev = comm.n_dev
    grid = cfg.grid
    if grid.dims[0] % ndev:
        raise ValueError(f"ncx={grid.dims[0]} not divisible by {ndev} "
                         "devices")
    if min(grid.dims) < 3 or any(abs(o) > 1 for off in grid.stencil
                                 for o in off):
        raise ValueError("domain decomposition needs a 27-point stencil")
    L, N = comm.n_local, cfg.n_at
    rep = lambda a: a.expand((L,) + tuple(a.shape))
    frc, e_vdw, e_coul, _ = stencil_pass(
        cfg, ff, comm, {"pos": rep(pos), "types": rep(types)},
        torch.ones((L, N), dtype=torch.bool, device=pos.device))
    return comm.psum(frc), comm.psum(e_vdw), comm.psum(e_coul)
