"""The port's domain-decomposed pair pass (aztotmd_tpu_torch/parallel/
domain.py) against the JAX package's (aztotmd_tpu/parallel/domain.py, a
shard_map over the conftest's virtual CPU mesh) and against the port's
all-pairs pass; ``DistRing`` on two gloo processes against ``LocalRing``;
the refusals; the slab-ownership demo of ``parallel/__init__.py``."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from aztotmd_tpu.ops.cellblock import make_block_grid as j_make_block_grid
from aztotmd_tpu.parallel import make_mesh as j_make_mesh
from aztotmd_tpu.parallel import run_domain_step_demo as j_demo
from aztotmd_tpu.parallel.domain import pair_forces_domain as j_domain
from aztotmd_tpu.systems import build_lj_argon as j_build_lj_argon
from aztotmd_tpu_torch.core.config import make_block_grid
from aztotmd_tpu_torch.ops.pairs import all_pairs_forces
from aztotmd_tpu_torch.parallel import (LocalRing, has_domain_step,
                                        pair_forces_domain,
                                        run_domain_step_demo)
from aztotmd_tpu_torch.systems import build_lj_argon

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _regrid(cfg, grid, n):
    """cfg on ``grid`` with ncx floored to a multiple of n (as
    tests/test_parallel.py does): only the cell edge grows."""
    ncx = max((grid.dims[0] // n) * n, n)
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        grid, dims=(ncx,) + tuple(grid.dims[1:]),
        edge=(cfg.box[0] / ncx,) + tuple(grid.edge[1:])))


def _domain_cfgs(n, seed=21, n_atoms=512):
    cfg, ff, st, aux = build_lj_argon(n_atoms=n_atoms, density=0.012,
                                      dtype="f64", seed=seed)
    jcfg, jff, jst, _ = j_build_lj_argon(n_atoms=n_atoms, density=0.012,
                                         dtype="f64", seed=seed)
    dcfg = _regrid(cfg, make_block_grid(cfg.box, cfg.r_max, cfg.n_at), n)
    jdcfg = _regrid(jcfg, j_make_block_grid(jcfg.box, jcfg.r_max,
                                            jcfg.n_at), n)
    assert dcfg.grid.dims == tuple(jdcfg.grid.dims)
    return (cfg, dcfg, ff, st), (jdcfg, jff, jst)


def test_domain_pass_matches_jax_and_all_pairs():
    """build_lj_argon(512, f64, seed=21) over 4 x-slabs: forces rtol 1e-9
    / atol 1e-11 and e_vdw rel 1e-10 against JAX's domain pass over
    make_mesh(4, axis="x") and against the port's all-pairs pass
    (tests/test_parallel.py:45-72)."""
    (cfg, dcfg, ff, st), (jdcfg, jff, jst) = _domain_cfgs(4)
    frc, e_vdw, e_coul = pair_forces_domain(dcfg, ff, st.pos, st.types,
                                            LocalRing(4))
    jfrc, je_vdw, _ = jax.jit(lambda p, t: j_domain(
        jdcfg, jff, p, t, j_make_mesh(4, axis="x")))(jst.pos, jst.types)
    pr = all_pairs_forces(cfg, ff, st.pos, st.types)
    assert frc.shape == (cfg.n_at, 3) and float(e_coul) == 0.0
    assert float(frc.abs().max()) > 0.0
    for want, ev in ((np.asarray(jfrc), float(je_vdw)),
                     (pr.frc.numpy(), float(pr.eng_vdw))):
        np.testing.assert_allclose(frc.numpy(), want, rtol=1e-9, atol=1e-11)
        assert float(e_vdw) == pytest.approx(ev, rel=1e-10)


def test_domain_refusals_have_jax_texts():
    """ncx not divisible by the slabs, and a stencil wider than 27 cells:
    the JAX package's ValueError texts."""
    (cfg, dcfg, ff, st), (jdcfg, jff, jst) = _domain_cfgs(4)
    odd = dataclasses.replace(dcfg.grid, dims=(7,) + dcfg.grid.dims[1:])
    wide = dataclasses.replace(dcfg.grid, stencil=dcfg.grid.stencil
                               + ((2, 0, 0),))
    jodd = dataclasses.replace(jdcfg.grid, dims=(7,) + tuple(
        jdcfg.grid.dims[1:]))
    jwide = dataclasses.replace(jdcfg.grid, stencil=tuple(
        jdcfg.grid.stencil) + ((2, 0, 0),))
    for grid, jgrid in ((odd, jodd), (wide, jwide)):
        with pytest.raises(ValueError) as got:
            pair_forces_domain(dataclasses.replace(dcfg, grid=grid), ff,
                               st.pos, st.types, LocalRing(4))
        with pytest.raises(ValueError) as want:
            j_domain(dataclasses.replace(jdcfg, grid=jgrid), jff, jst.pos,
                     jst.types, j_make_mesh(4, axis="x"))
        assert str(got.value) == str(want.value)


_DIST_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from aztotmd_tpu_torch.parallel.comm import DistRing, init_dist
    from aztotmd_tpu_torch.parallel.domain import pair_forces_domain
    torch.set_num_threads(1)
    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_dist("cpu", init_method="file://" + store, rank=rank,
              world_size=2, timeout_s=60)
    d = torch.load(inp, weights_only=False)
    frc, ev, ec = pair_forces_domain(d["cfg"], d["ff"], d["pos"],
                                     d["types"], DistRing())
    np.save(out + f".{rank}.npy", np.concatenate(
        [frc.numpy().reshape(-1), [float(ev), float(ec)]]))
    dist.destroy_process_group()
""")


def test_dist_ring_on_gloo_equals_local_ring(tmp_path):
    """The domain pass over two gloo processes (one slab each; halo planes
    by isend/irecv, forces and energies by all_reduce) against both slabs
    in one process: equal on both ranks, forces atol 1e-12 (one add in
    another order at most)."""
    (_, dcfg, ff, st), _ = _domain_cfgs(2, seed=4, n_atoms=256)
    inp = tmp_path / "system.pt"
    torch.save(dict(cfg=dcfg, ff=ff, pos=st.pos, types=st.types), inp)
    out = str(tmp_path / "res")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r),
         str(tmp_path / "store"), str(inp), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    frc, ev, ec = pair_forces_domain(dcfg, ff, st.pos, st.types,
                                     LocalRing(2))
    want = np.concatenate([frc.numpy().reshape(-1), [float(ev), float(ec)]])
    r0, r1 = np.load(out + ".0.npy"), np.load(out + ".1.npy")
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_allclose(r0, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_domain_step_demo_runs_as_jax(n):
    """``run_domain_step_demo`` (the slab-ownership loop, 20 steps over n
    slabs, no atom lost) on the CPU, as JAX's on n virtual devices."""
    assert has_domain_step()
    run_domain_step_demo(n, device="cpu")
    j_demo(n)
