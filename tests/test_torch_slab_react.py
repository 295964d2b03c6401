"""Reactive topology on the port's slab mesh
(``aztotmd_tpu_torch/parallel/slab_react.py``: replicated tables over
sharded geometry) against the JAX package's slab step on the conftest's
virtual CPU mesh: an A/B fluid whose atoms cross slab boundaries while
bonds form and examples/ejump_redox's electron jumps, topology tables,
jump counters and RNG words exactly; ``DistRing`` on two gloo processes
against ``LocalRing``; `run --mesh 2 --cpu` against the JAX runner's mesh
run; a mesh checkpoint resumed on one device with its live topology."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.io.atoms import AtomsData
from aztotmd_tpu.io.control import ControlSpec, ElecSpec, TStatSpec
from aztotmd_tpu.io.field import parse_field
from aztotmd_tpu.parallel import make_mesh
from aztotmd_tpu.parallel import slab as jslab
from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import build_system
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.parallel import slab
from aztotmd_tpu_torch.parallel.comm import LocalRing
from aztotmd_tpu_torch.runtime.checkpoint import load_checkpoint
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_multi_step

from test_torch_runner import _table
from test_torch_slab import _port

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")

# two species; an A-B bond forms within 1.8 A and breaks past 2.5 A
FIELD = """
spec 2
A\tA\t20.0\t0.0\t0.0
B\tB\t20.0\t0.0\t0.0
red-ox 0
vdw 1
A\tA\tlnjs\t4.0\t0.005\t2.0
bonds 1
1 A B harm 10.0 1.5 con br 2.5 A B
linkage 1
A B 1.8 1
"""

_TABLES = ("bond_at1", "bond_at2", "bond_type", "n_bond", "types",
           "parents", "nbonds", "bt_count", "spec_number", "n_jump",
           "jump_pos", "jump_neg")


def _both(cfg, ff, state, aux, n_dev, n):
    """(JAX slab state, port slab state, port comm) after n steps."""
    mesh = make_mesh(n_dev, axis="x")
    jst = jslab.make_slab_multi_step(cfg, aux, mesh)(
        jslab.make_slab_state(cfg, state, mesh), ff, n)
    pcfg, pff, pst, paux = _port(cfg, ff, state, aux)
    comm = LocalRing(n_dev)
    st = slab.make_slab_multi_step(pcfg, paux, comm)(
        slab.make_slab_state(pcfg, pst, comm), pff, n)
    return jst, st, comm


def _reactive_fluid(n_dev=4, seed=7):
    """The JAX package's reactive slab recipe: 216 A atoms on a jittered
    lattice in a 32 A box, half of them with a B at 1.2-2.2 A, so that
    bonds form and break; f64, grid.cap + 8, an x-drift of 3 A/ps so that
    atoms and their bonds cross slab boundaries."""
    box = 32.0
    n_side = 6
    rng = np.random.default_rng(seed)
    g = (np.arange(n_side) + 0.5) * (box / n_side)
    base = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    base += rng.uniform(-0.3, 0.3, base.shape)
    nb = len(base) // 2
    off = rng.normal(size=(nb, 3))
    off *= (rng.uniform(1.2, 2.2, (nb, 1))
            / np.linalg.norm(off, axis=1, keepdims=True))
    pos = np.concatenate([base, (base[:nb] + off) % box])
    names = ["A"] * len(base) + ["B"] * nb
    ctl = ControlSpec(t_step=0.0005, n_step=10,
                      tstat=TStatSpec(type=0, temp=50.0),
                      elec=ElecSpec(type=0))
    atoms = AtomsData(names=names, pos=pos, box=(box, box, box))
    cfg, ff, state, aux = build_system(ctl, parse_field(FIELD), atoms,
                                       dtype="f64", seed=seed)
    cfg = jslab.prepare_slab_cfg(cfg, n_dev)
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, cap=cfg.grid.cap + 8))
    vel = rng.normal(0.0, 2.0, pos.shape) + np.array([3.0, 0.0, 0.0])
    state = state.replace(vel=jnp.asarray(vel),
                          nbr_ref=jnp.asarray(pos + 1e9))
    return cfg, ff, state, aux


def _same_topology(rg, jrg, names=_TABLES):
    for k in names:
        np.testing.assert_array_equal(getattr(rg, k).numpy(),
                                      np.asarray(getattr(jrg, k)), err_msg=k)


def test_reactive_fluid_slab_steps_match_jax():
    """40 f64 steps of the reactive fluid over 4 slabs: the replicated
    tables (bond table, types, parents, bond counts, statistics' counts)
    equal JAX's exactly with bonds formed, the per-slot type cache equals
    the table, positions and velocities atol 1e-8, the bond energy rel
    1e-9."""
    cfg, ff, state, aux = _reactive_fluid()
    assert cfg.use_bnd == 2 and cfg.use_linkage
    jst, st, comm = _both(cfg, ff, state, aux, 4, 40)
    assert st.rg is not None and int(st.mig_lost) == 0
    assert int(st.mig_total) > 0
    _same_topology(st.rg, jst.rg)
    assert int(st.rg.n_bond) > 0
    np.testing.assert_array_equal(st.rg.bt_lt_count.numpy(),
                                  np.asarray(jst.rg.bt_lt_count))
    g = slab.gather_state(st, cfg.n_at, comm)
    jg = jslab.gather_state(jst, cfg.n_at)
    np.testing.assert_array_equal(g["types"], st.rg.types.numpy())
    np.testing.assert_allclose(g["pos"], jg["pos"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(g["vel"], jg["vel"], rtol=0, atol=1e-8)
    assert float(st.energies.bond) == pytest.approx(
        float(jst.energies.bond), rel=1e-9, abs=1e-12)


def test_ejump_redox_slab_steps_match_jax():
    """examples/ejump_redox (Nose-Hoover, direct Coulomb, five Metropolis
    jump passes a step, bond-free: the sharded environment-dU sweep) over
    3 slabs, 40 f64 steps: the jump counters, types, species counts and
    the threaded RNG words equal JAX's exactly with jumps made; positions
    atol 1e-8."""
    d = j_load_deck_dir(os.path.join(EX, "ejump_redox"), dtype="f64")
    cfg = jslab.prepare_slab_cfg(d["cfg"], 3)
    assert cfg.ejtype and not cfg.use_bnd and cfg.ejump_freq > 4
    jst, st, comm = _both(cfg, d["ff"], d["state"], d["aux"], 3, 40)
    _same_topology(st.rg, jst.rg)
    assert int(st.rg.n_jump) > 0
    np.testing.assert_array_equal(st.rng.numpy(),
                                  np.asarray(jst.rng).astype(np.int64))
    g = slab.gather_state(st, cfg.n_at, comm)
    jg = jslab.gather_state(jst, cfg.n_at)
    np.testing.assert_array_equal(g["types"], jg["types"])
    np.testing.assert_allclose(g["pos"], jg["pos"], rtol=0, atol=1e-8)


_DIST_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from aztotmd_tpu_torch.parallel import slab
    from aztotmd_tpu_torch.parallel.comm import DistRing, init_dist
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    torch.set_num_threads(1)
    rank, store, deck, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_dist("cpu", init_method="file://" + store, rank=rank,
              world_size=2, timeout_s=60)
    d = load_deck_dir(deck)
    cfg = slab.prepare_slab_cfg(d["cfg"], 2)
    comm = DistRing()
    st = slab.make_slab_state(cfg, d["state"], comm)
    assert st.pos.shape[0] == 1 and st.rg is not None
    st = slab.make_slab_multi_step(cfg, d["aux"], comm)(st, d["ff"], 10)
    g = slab.gather_state(st, cfg.n_at, comm)
    np.savez(out + f".{rank}.npz", pos=g["pos"],
             **{k: getattr(st.rg, k).numpy() for k in
                ("bond_at1", "bond_at2", "bond_type", "n_bond", "types",
                 "parents", "bt_count")})
    dist.destroy_process_group()
""")


def test_dist_ring_on_gloo_equals_local_ring(tmp_path):
    """examples/reactive_polymer (f32) over two gloo processes, one slab
    each, every rank running the replicated reactive work: after 10 steps
    both ranks hold the same topology tables, equal to both slabs in one
    process, and positions atol 1e-6 A."""
    deck = os.path.join(EX, "reactive_polymer")
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r),
         str(tmp_path / "store"), deck, out], env=env,
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

    d = load_deck_dir(deck)
    cfg = slab.prepare_slab_cfg(d["cfg"], 2)
    comm = LocalRing(2)
    st = slab.make_slab_multi_step(cfg, d["aux"], comm)(
        slab.make_slab_state(cfg, d["state"], comm), d["ff"], 10)
    ranks = [np.load(f"{out}.{r}.npz") for r in range(2)]
    for k in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        if k != "pos":
            np.testing.assert_array_equal(ranks[0][k],
                                          getattr(st.rg, k).numpy(),
                                          err_msg=k)
    g = slab.gather_state(st, cfg.n_at, comm)
    np.testing.assert_allclose(ranks[0]["pos"], g["pos"], rtol=0, atol=1e-6)


def test_mesh2_reactive_run_matches_jax_runner(tmp_path, monkeypatch):
    """`run --mesh 2 --cpu --dtype f64` on examples/reactive_polymer for
    60 steps with a stat row every 30 against the JAX runner's 2-device
    mesh run: stat.dat and stat_bnd.dat rtol 1e-8 (bond counts and
    statistics from the replicated tables), revbonds.txt and lengths.dat
    equal byte for byte, bonds formed; both runners on their host chunk
    loop (AZTOTMD_NO_RING)."""
    deck = str(tmp_path / "deck")
    os.makedirs(deck)
    for name in ("atoms.xyz", "field.txt", "control.txt"):
        with open(os.path.join(EX, "reactive_polymer", name)) as f:
            text = f.read()
        with open(os.path.join(deck, name), "w") as f:
            f.write(text.replace("stat\t100", "stat\t30"))
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    r = main(["run", deck, "--mesh", "2", "--cpu", "--dtype", "f64",
              "--steps", "60", "-o", out_t, "--quiet"])
    assert r.comm.n_dev == 2 and r.state.rg is not None
    assert int(r.state.rg.n_bond) > 0
    j = JRunner(j_load_deck_dir(deck, dtype="f64"), out_dir=out_j,
                quiet=True, mesh_devices=2)
    j.run(60)
    j.finalize()
    for name in ("stat.dat", "stat_bnd.dat", "msd.dat"):
        a = _table(os.path.join(out_t, name))
        b = _table(os.path.join(out_j, name))
        assert a.shape == b.shape and a.shape[0] == 2, name
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=name)
    assert _table(os.path.join(out_t, "stat_bnd.dat"))[-1, 2] > 0
    for name in ("revbonds.txt", "lengths.dat"):
        with open(os.path.join(out_t, name)) as f, \
                open(os.path.join(out_j, name)) as g:
            assert f.read() == g.read(), name


def test_mesh_checkpoint_of_reactive_deck_resumes_on_one_device(tmp_path):
    """A checkpoint of a `--mesh 2` f64 run of examples/reactive_polymer at
    step 20 carries the live topology (merge_into_state): resumed on one
    device it reaches the mesh run's step 40 with the same bond table,
    types and parents, positions atol 1e-7 A."""
    deck = os.path.join(EX, "reactive_polymer")
    rm = MDRunner(load_deck_dir(deck, dtype="f64"),
                  out_dir=str(tmp_path / "mesh"), quiet=True,
                  mesh_devices=2, checkpoint_every=20)
    rm.run(20)
    ck = str(tmp_path / "step20.npz")
    os.replace(tmp_path / "mesh" / "checkpoint.npz", ck)
    rg20 = int(rm.state.rg.n_bond)
    rm.run(40)
    ref = rm.mdstate()

    d = load_deck_dir(deck, dtype="f64")
    st = load_checkpoint(ck, d["state"])
    assert int(st.step) == 20 and int(st.n_bond) == rg20 > 0
    st = make_multi_step(d["cfg"], d["aux"])(st, d["ff"], 20)
    for k in ("bond_at1", "bond_at2", "bond_type", "n_bond", "types",
              "parents", "nbonds"):
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    np.testing.assert_allclose(st.pos.numpy(), ref.pos.numpy(), rtol=0,
                               atol=1e-7)
