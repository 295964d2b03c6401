"""The port's atom-sharded mode (aztotmd_tpu_torch/parallel/mesh.py)
against the JAX package's (aztotmd_tpu/parallel/mesh.py) on the
conftest's virtual 8-device CPU mesh: which fields are sharded, the
sharded step against JAX's sharded step and JAX's one-device step on
argon and on the reactive decks (integer fields and RNG words exactly),
the refusals, and ``DistRing`` on two gloo processes against
``LocalRing``.  The runner's atoms mode is in test_torch_runner_atoms.py."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from aztotmd_tpu.parallel import make_mesh as j_make_mesh
from aztotmd_tpu.parallel import make_sharded_step as j_make_sharded_step
from aztotmd_tpu.parallel.mesh import state_shardings as j_state_shardings
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.runtime.step import make_step as j_make_step
from aztotmd_tpu.systems import build_lj_argon as j_build_lj_argon
from aztotmd_tpu_torch.parallel import (LocalRing, make_mesh,
                                        make_sharded_step, state_shardings)
from aztotmd_tpu_torch.parallel.mesh import (gather_state,
                                             make_sharded_multi_step,
                                             shard_state, shard_system)
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_step
from aztotmd_tpu_torch.systems import build_lj_argon

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _systems(name):
    """(port system, JAX system) of the same arguments, f64."""
    if name == "lj_argon":
        return (build_lj_argon(n_atoms=512, density=0.012, dtype="f64",
                               seed=11),
                j_build_lj_argon(n_atoms=512, density=0.012, dtype="f64",
                                 seed=11))
    path = os.path.join(EX, name)
    p, j = load_deck_dir(path, dtype="f64"), j_load_deck_dir(path,
                                                             dtype="f64")
    return tuple((d["cfg"], d["ff"], d["state"], d["aux"]) for d in (p, j))


@pytest.mark.parametrize("name", ["lj_argon", "bonded_fluid", "ejump_redox"])
def test_per_atom_fields_equal_jax(name):
    """The fields ``state_shardings`` shards (JAX's rule: first axis
    n_at), with their specs, are JAX's on the same system."""
    (cfg, _, st, _), (jcfg, _, jst, _) = _systems(name)
    got = {k: v for k, v in state_shardings(LocalRing(8), st,
                                            cfg.n_at).items() if v}
    jsh = j_state_shardings(j_make_mesh(8), jst, jcfg.n_at)
    want = {".".join(k.name for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]
            if tuple(s.spec)}
    assert "pos" in got and "bond_at1" not in got
    assert got == want


def test_sharded_step_matches_jax_sharded_step():
    """One step of build_lj_argon(512, f64, seed=11) over 8 row shards
    against JAX's make_sharded_step over make_mesh(8): positions rtol
    1e-12 / atol 1e-12, forces rtol 1e-9 / atol 1e-11, energies.tot rel
    1e-10 (tests/test_parallel.py's bounds); and exactly the port's
    one-device step."""
    (cfg, ff, st, aux), (jcfg, jff, jst, jaux) = _systems("lj_argon")
    mesh = make_mesh(8)
    step, sst, sff = make_sharded_step(cfg, aux, mesh, st, ff)
    assert sst.pos.shape == (8, 64, 3) and sst.bond_at1.shape == \
        st.bond_at1.shape
    out = gather_state(mesh, step(sst, sff), state_shardings(mesh, st,
                                                             cfg.n_at))
    jstep, jsst, jsff = j_make_sharded_step(jcfg, jaux, j_make_mesh(8), jst,
                                            jff, donate=False)
    ref = jstep(jsst, jsff)
    np.testing.assert_allclose(_np(out.pos), np.asarray(ref.pos),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(out.frc), np.asarray(ref.frc),
                               rtol=1e-9, atol=1e-11)
    assert float(out.energies.tot) == pytest.approx(
        float(ref.energies.tot), rel=1e-10)
    one = make_step(cfg, aux)(st, ff)
    for k in ("pos", "vel", "frc", "nbr_idx"):
        assert torch.equal(getattr(out, k), getattr(one, k)), k
    assert torch.equal(out.energies.tot, one.energies.tot)


def test_sharded_multi_step_runs():
    """5 sharded steps over 4 shards: finite, step == 5."""
    cfg, ff, st, aux = build_lj_argon(n_atoms=256, density=0.012,
                                      dtype="f64", seed=3)
    mesh = make_mesh(4)
    step, sst, sff = make_sharded_step(cfg, aux, mesh, st, ff)
    for _ in range(5):
        sst = step(sst, sff)
    assert int(sst.step) == 5
    assert sst.pos.shape == (4, 64, 3)
    assert bool(torch.isfinite(sst.pos).all())


@pytest.mark.parametrize("deck", ["bonded_fluid", "ejump_redox"])
def test_sharded_reactive_decks_match_jax_single_device(deck):
    """20 atom-sharded steps over 8 shards (f64) against 20 steps of JAX's
    one-device step: positions rtol 1e-12; types, bond tables, jump
    counters and the RNG words exactly (tests/test_parallel.py:412-452)."""
    (cfg, ff, st, aux), (jcfg, jff, jst, jaux) = _systems(deck)
    assert cfg.n_at % 8 == 0
    jstep = jax.jit(j_make_step(jcfg, jaux))
    ref = jst
    for _ in range(20):
        ref = jstep(ref, jff)
    mesh = make_mesh(8)
    step, out, sff = make_sharded_step(cfg, aux, mesh, st, ff)
    for _ in range(20):
        out = step(out, sff)
    out = gather_state(mesh, out, state_shardings(mesh, st, cfg.n_at))
    np.testing.assert_allclose(_np(out.pos), np.asarray(ref.pos),
                               rtol=1e-12, atol=1e-12, err_msg=deck)
    for k in ("types", "bond_at1", "bond_at2", "bond_type", "n_bond",
              "n_jump", "jump_pos", "jump_neg", "parents", "nbonds",
              "ang_type", "n_angle"):
        np.testing.assert_array_equal(_np(getattr(out, k)),
                                      np.asarray(getattr(ref, k)), k)
    np.testing.assert_array_equal(_np(out.rng),
                                  np.asarray(ref.rng).astype(np.int64))
    assert float(out.energies.tot) == pytest.approx(
        float(ref.energies.tot), rel=1e-10), deck
    if deck == "ejump_redox":
        assert int(out.n_jump) > 0


def test_refusals_have_jax_texts():
    """n_at not divisible by the mesh: the same ValueError text as JAX's
    make_sharded_step."""
    cfg, ff, st, aux = build_lj_argon(n_atoms=250, dtype="f64", seed=3)
    jcfg, jff, jst, jaux = j_build_lj_argon(n_atoms=250, dtype="f64", seed=3)
    with pytest.raises(ValueError) as got:
        make_sharded_step(cfg, aux, make_mesh(8), st, ff)
    with pytest.raises(ValueError) as want:
        j_make_sharded_step(jcfg, jaux, j_make_mesh(8), jst, jff)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        make_sharded_multi_step(cfg, aux, make_mesh(8), {})
    assert str(got.value) == str(want.value)


def test_shard_and_gather_are_views_over_local_ring():
    """Over a LocalRing the shards are views of the single-device fields
    and their gather a view of the shards: no copy."""
    cfg, ff, st, aux = build_lj_argon(n_atoms=128, dtype="f32", seed=3)
    mesh = make_mesh(4)
    spec = state_shardings(mesh, st, cfg.n_at)
    sst = shard_state(mesh, st, spec)
    g = gather_state(mesh, sst, spec)
    assert sst.pos.data_ptr() == st.pos.data_ptr() == g.pos.data_ptr()
    assert sst.rng is st.rng and g.pos.shape == st.pos.shape


_DIST_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from aztotmd_tpu_torch.parallel.comm import DistRing, init_dist
    from aztotmd_tpu_torch.parallel.mesh import (gather_state,
                                                 make_sharded_multi_step,
                                                 shard_system)
    torch.set_num_threads(1)
    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_dist("cpu", init_method="file://" + store, rank=rank,
              world_size=2, timeout_s=60)
    d = torch.load(inp, weights_only=False)
    comm = DistRing()
    st, ff, spec, _ = shard_system(comm, d["state"], d["ff"], d["cfg"].n_at)
    assert st.pos.shape[0] == 1 and st.pos.shape[1] == d["cfg"].n_at // 2
    multi = make_sharded_multi_step(d["cfg"], d["aux"], comm, spec)
    assert multi.graph is False
    g = gather_state(comm, multi(st, ff, 6), spec)
    if rank == 0:
        np.save(out, np.stack([g.pos.numpy(), g.vel.numpy()]))
        np.save(out + ".types.npy", g.types.numpy())
    dist.destroy_process_group()
""")


def test_dist_ring_on_gloo_equals_local_ring(tmp_path):
    """bonded_fluid (constant bonds and angles, the Verlet-list engine)
    over two gloo processes, one shard each (the rows all-gathered), 6
    steps against both shards in one process: positions and velocities
    exactly equal, as every rank runs the one-device step on the same
    gathered arrays."""
    d = load_deck_dir(os.path.join(EX, "bonded_fluid"), dtype="f32")
    inp = tmp_path / "system.pt"
    torch.save({k: d[k] for k in ("cfg", "ff", "state", "aux")}, inp)
    out = tmp_path / "pv.npy"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r),
         str(tmp_path / "store"), str(inp), str(out)], env=env,
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

    comm = LocalRing(2)
    cfg = d["cfg"]
    st, ff, spec, _ = shard_system(comm, d["state"], d["ff"], cfg.n_at)
    g = gather_state(comm, make_sharded_multi_step(cfg, d["aux"], comm, spec)(
        st, ff, 6), spec)
    got = np.load(out)
    np.testing.assert_array_equal(got[0], g.pos.numpy())
    np.testing.assert_array_equal(got[1], g.vel.numpy())
    np.testing.assert_array_equal(np.load(str(out) + ".types.npy"),
                                  g.types.numpy())
