"""The port's slab-decomposed step (aztotmd_tpu_torch/parallel/) against
the JAX package's (aztotmd_tpu/parallel/slab.py) on the conftest's virtual
CPU mesh: the rectangular dense pass K2 (plain version against JAX's
Pallas kernel in interpret mode), the slab layout, migration, the dense
and stencil slab steps, the RDF sample on the mesh, the refusals, and the
two communicators (LocalRing against DistRing on gloo).  Slot ids,
migration counters and RDF counts are compared exactly."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.core.ffield import build_forcefield as j_build_forcefield
from aztotmd_tpu.ops.pallas_pair import (
    pair_forces_allpairs as j_allpairs,
    pair_forces_allpairs_rect as j_rect)
from aztotmd_tpu.parallel import make_mesh
from aztotmd_tpu.parallel import slab as jslab
from aztotmd_tpu.systems import clustered_slab_system
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.ops.allpairs import (pair_forces_allpairs_rect,
                                            pair_forces_allpairs_rect_plain)
from aztotmd_tpu_torch.parallel import slab
from aztotmd_tpu_torch.parallel.comm import LocalRing
from aztotmd_tpu_torch.runtime.step import StepAux

from test_parallel import _slab_system

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(cfg, ff, state, aux):
    """The port's cfg, ff, MDState and StepAux of the JAX package's."""
    t = lambda a: None if a is None else torch.as_tensor(np.array(a))
    paux = StepAux(photons=t(aux.photons), rk=t(aux.rk),
                   kweights=t(aux.kweights)) if aux is not None else None
    return (convert.config_from(cfg), convert.forcefield_from_numpy(ff),
            convert.state_from_numpy(state), paux)


def _jax_slab(cfg, ff, state, aux, n_dev, n):
    mesh = make_mesh(n_dev, axis="x")
    st = jslab.make_slab_state(cfg, state, mesh)
    if n:
        st = jslab.make_slab_multi_step(cfg, aux, mesh)(st, ff, n)
    return st, jslab.gather_state(st, cfg.n_at)


def _port_slab(cfg, ff, state, aux, n_dev, n):
    pcfg, pff, pst, paux = _port(cfg, ff, state, aux)
    comm = LocalRing(n_dev)
    st = slab.make_slab_state(pcfg, pst, comm)
    if n:
        st = slab.make_slab_multi_step(pcfg, paux, comm)(st, pff, n)
    return st, slab.gather_state(st, pcfg.n_at, comm)


def _same_layout(pst, jst):
    """Equal slot layout and migration counters."""
    np.testing.assert_array_equal(pst.gid.reshape(-1).numpy(),
                                  np.asarray(jst.gid))
    for k in ("mig_total", "mig_lost", "mig_defer", "slab_occ"):
        assert int(getattr(pst, k)) == int(getattr(jst, k)), k


# --- K2: the rectangular pass ---

_RECT_CASES = {
    "lj-nsp1": dict(nsp=1, elec=0),
    "direct-nsp2": dict(nsp=2, elec=1),
    "ewald-nsp3": dict(nsp=3, elec=2),
    "fennel-nsp3": dict(nsp=3, elec=3),
    "surkov-radii-nsp2-fennel": dict(nsp=2, elec=3, radii=True),
}


@pytest.mark.parametrize("case", sorted(_RECT_CASES))
def test_rect_plain_matches_jax_interpret_kernel(case):
    """Ni = 200 (not a multiple of 128) owned slots against Nj = 300 slots
    with ~20% empty slots scattered on both sides: forces on the filled
    i slots atol 3e-5*max|F|, energies rel 1e-4."""
    ctl, f, box, pos, types, rad = systems.clustered_specs(
        n_atoms=300, seed=4, **_RECT_CASES[case])
    rng = np.random.default_rng(6)
    valid = rng.uniform(size=300) > 0.2
    pos = np.where(valid[:, None], pos, 0.0).astype(np.float32)
    types = np.where(valid, types, 0).astype(np.int32)
    if rad is not None:
        rad = np.where(valid, rad, 1.0).astype(np.float32)
    jcfg = j_build_sim_config(ctl, f, (box,) * 3, 300, pos=pos,
                              pair_engine="pallas")
    jff = j_build_forcefield(f, ctl.t_step, dtype=np.float32)
    ni = 200
    r_i = jnp.asarray(rad[:ni]) if rad is not None else None
    r_j = jnp.asarray(rad) if rad is not None else None
    jf, jev, jec = j_rect(jcfg, jff, jnp.asarray(pos[:ni]),
                          jnp.asarray(types[:ni]), jnp.asarray(valid[:ni]),
                          jnp.asarray(pos), jnp.asarray(types),
                          jnp.asarray(valid), radii_i=r_i, radii_j=r_j,
                          interpret=True)
    cfg, ff, *_ = systems.pair_system((ctl, f, box, pos, types, rad))
    t = torch.as_tensor
    pf, pev, pec = pair_forces_allpairs_rect(
        cfg, ff, t(pos[:ni]), t(types[:ni]), t(valid[:ni]), t(pos),
        t(types), t(valid), radii_i=t(rad[:ni]) if rad is not None else None,
        radii_j=t(rad) if rad is not None else None)
    jf = np.asarray(jf)
    scale = float(np.abs(jf).max())
    assert scale > 0.0
    np.testing.assert_allclose(pf.numpy()[valid[:ni]], jf[valid[:ni]],
                               rtol=0, atol=3e-5 * scale)
    assert not pf.numpy()[~valid[:ni]].any()
    assert float(pev) == pytest.approx(float(jev), rel=1e-4, abs=1e-6)
    assert float(pec) == pytest.approx(float(jec), rel=1e-4, abs=1e-6)
    # the slab axis: two slabs at once give each slab's result
    pf2, pev2, _ = pair_forces_allpairs_rect_plain(
        cfg, ff, t(pos[:ni]).expand(2, -1, -1), t(types[:ni]).expand(2, -1),
        t(valid[:ni]).expand(2, -1), t(pos).expand(2, -1, -1),
        t(types).expand(2, -1), t(valid).expand(2, -1),
        radii_i=t(rad[:ni]).expand(2, -1) if rad is not None else None,
        radii_j=t(rad).expand(2, -1) if rad is not None else None)
    assert torch.equal(pf2[0], pf) and torch.equal(pf2[1], pf)
    assert float(pev2[1]) == float(pev)


# --- the slab layout and migration ---

def _deck_system(name, n_dev):
    """A deck of examples/ loaded by the JAX package, slab-prepared."""
    from aztotmd_tpu.runtime.setup import load_deck_dir as j_load
    d = j_load(os.path.join(ROOT, "examples", name), dtype="f32")
    return (jslab.prepare_slab_cfg(d["cfg"], n_dev), d["ff"], d["state"],
            d["aux"])


@pytest.mark.parametrize("name,n_dev,C", [("surkov_cluster", 2, 3208),
                                          ("nanoclusters", 4, 5024),
                                          ("clustered", 4, 184)])
def test_make_slab_state_and_gather_match_jax(name, n_dev, C):
    """The slab layout of the mesh decks and of the clustered system: C
    (nanoclusters: grown from 4,808 to its worst slab's 4,455 atoms plus
    headroom), M and the gid of every slot equal to JAX's; gather_state
    inverts it."""
    cfg, ff, state, aux = (clustered_slab_system(n_dev=n_dev)
                           if name == "clustered"
                           else _deck_system(name, n_dev))
    jst, jg = _jax_slab(cfg, ff, state, aux, n_dev, 0)
    pst, g = _port_slab(cfg, ff, state, aux, n_dev, 0)
    assert np.asarray(jst.gid).shape[0] == n_dev * C
    assert tuple(pst.pos.shape) == (n_dev, C, 3)
    assert slab.slab_caps(convert.config_from(cfg), n_dev) \
        == jslab.slab_caps(cfg, n_dev)
    _same_layout(pst, jst)
    for k in ("pos", "vel", "types", "radii"):
        np.testing.assert_array_equal(g[k], jg[k], err_msg=k)
    np.testing.assert_array_equal(g["pos"], np.asarray(state.pos))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_migration_step_matches_jax(n_dev):
    """Atoms drifting +x across the slab boundaries (one lattice plane
    parked on a boundary): after 3 f64 stencil steps the slot layout and
    the counters n_recv (mig_total), n_lost, n_defer equal JAX's."""
    cfg, ff, state, aux = _slab_system(n_atoms=256, n_dev=n_dev)
    vel = np.asarray(state.vel) + np.array([6.0, 0.0, 0.0])
    state = state.replace(vel=jnp.asarray(vel))
    jst, jg = _jax_slab(cfg, ff, state, aux, n_dev, 3)
    pst, g = _port_slab(cfg, ff, state, aux, n_dev, 3)
    assert int(pst.mig_total) > 0
    _same_layout(pst, jst)
    np.testing.assert_allclose(g["pos"], jg["pos"], rtol=0, atol=1e-8)


def test_sender_overflow_defers_like_jax():
    """60 atoms cross one boundary on the same step, past the M-row
    buffer: the excess stays put (mig_defer) and retries; nothing is lost,
    and the layout and counters equal JAX's after 5 steps."""
    cfg, ff, state, aux = _slab_system(n_atoms=512, n_dev=4)
    pos = np.array(state.pos)
    vel = np.array(state.vel)
    pos[:60, 0] = cfg.box[0] / 4 - 0.01
    vel[:60, 0] = 20.0
    state = state.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                          pos0=jnp.asarray(pos.copy()),
                          nbr_ref=jnp.asarray(pos + 1e9))
    jst, _ = _jax_slab(cfg, ff, state, aux, 4, 5)
    pst, _ = _port_slab(cfg, ff, state, aux, 4, 5)
    _same_layout(pst, jst)
    live = pst.gid[pst.gid >= 0]
    assert len(live) == cfg.n_at and len(torch.unique(live)) == cfg.n_at
    assert int(pst.mig_defer) > 0 and int(pst.mig_lost) == 0


# --- the dense slab step (K2's route) ---

@pytest.mark.parametrize("n_dev", [2, 4])
def test_dense_slab_steps_match_jax(n_dev):
    """The clustered slab system (432 atoms in two clusters across slab
    boundaries) on the dense rectangular pass, 6 steps: positions atol
    5e-4 A and velocities atol 1e-4*max|v| of JAX's slab step (the
    bounds of JAX's slab-vs-single-chip test), nothing lost."""
    cfg, ff, state, aux = clustered_slab_system(n_dev=n_dev)
    assert cfg.pair_engine == "pallas"
    jst, jg = _jax_slab(cfg, ff, state, aux, n_dev, 6)
    pst, g = _port_slab(cfg, ff, state, aux, n_dev, 6)
    assert int(pst.step) == 6 and int(pst.mig_lost) == 0
    vscale = float(np.abs(jg["vel"]).max()) or 1.0
    np.testing.assert_allclose(g["pos"], jg["pos"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(g["vel"], jg["vel"], rtol=0,
                               atol=1e-4 * vscale)
    assert float(pst.energies.vdw) == pytest.approx(
        float(jst.energies.vdw), rel=1e-4)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_dense_pair_pass_matches_jax_kernel(n_dev):
    """One dense slab pair pass (K2's plain version over [own; halos]),
    gathered by gid, against JAX's dense kernel on the whole system:
    forces atol 3e-5*max|F|, the psummed energy rel 1e-4; two slabs
    exchange one halo copy (a second would double the cross-slab
    pairs)."""
    cfg, ff, state, aux = clustered_slab_system(n_dev=n_dev)
    jr = jax.jit(lambda p, t: j_allpairs(cfg, ff, p, t, interpret=True))(
        state.pos, state.types)
    pcfg, pff, pst, _ = _port(cfg, ff, state, aux)
    comm = LocalRing(n_dev)
    st = slab.make_slab_state(pcfg, pst, comm)
    valid = st.gid >= 0
    frc, ev, _, _ = slab._pair_pass(pcfg, pff, comm,
                                    {k: getattr(st, k) for k in
                                     slab.PER_SLOT}, valid)
    g = slab.gather_state(st.replace(frc=frc), pcfg.n_at, comm, ("frc",))
    jf = np.asarray(jr.frc)
    np.testing.assert_allclose(g["frc"], jf, rtol=0,
                               atol=3e-5 * float(np.abs(jf).max()))
    assert float(comm.psum(ev)) == pytest.approx(float(jr.eng_vdw),
                                                 rel=1e-4)


# --- the stencil slab step in f64 ---

def _nacl_slab():
    import dataclasses
    from aztotmd_tpu.ops.cellblock import make_block_grid
    from test_elec import nacl_system
    cfg, ff, state, aux = nacl_system(n_side=4, kmax=6, jitter=0.3, seed=5,
                                      r_real=5.0, alpha=0.45)
    grid = make_block_grid(cfg.box, cfg.r_max, cfg.n_at)
    ncx = max((grid.dims[0] // 4) * 4, 4)
    grid = dataclasses.replace(grid, dims=(ncx,) + grid.dims[1:],
                               edge=(cfg.box[0] / ncx,) + grid.edge[1:])
    return dataclasses.replace(cfg, grid=grid, pair_engine="block"), ff, \
        state, aux


def _stencil_case(name):
    from aztotmd_tpu.io.control import TSTAT_RADI
    if name == "nve-lj":
        return _slab_system(), 4, 15
    if name == "radiative":
        return _slab_system(tstat=TSTAT_RADI, temp=120.0), 8, 10
    return _nacl_slab(), 4, 10


@pytest.mark.parametrize("name", ["nve-lj", "radiative", "ewald-nacl"])
def test_stencil_slab_steps_f64_match_jax(name):
    """f64 slab steps on the cell-block stencil pass against JAX's: NVE LJ
    with migration (positions atol 1e-8 A, mig_total equal), the radiative
    thermostat (engs atol 1e-9) and Ewald on the NaCl crystal (coul2 rel
    1e-9): the same f64 operations."""
    (cfg, ff, state, aux), n_dev, n = _stencil_case(name)
    jst, jg = _jax_slab(cfg, ff, state, aux, n_dev, n)
    pst, g = _port_slab(cfg, ff, state, aux, n_dev, n)
    _same_layout(pst, jst)
    np.testing.assert_allclose(g["pos"], jg["pos"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(g["engs"], jg["engs"], rtol=0, atol=1e-9)
    for k in ("kin", "vdw", "coul1", "coul2", "temp", "tot"):
        assert float(getattr(pst.energies, k)) == pytest.approx(
            float(getattr(jst.energies, k)), rel=1e-9, abs=1e-12), k
    if name == "nve-lj":
        assert int(pst.mig_total) > 0
    if name == "radiative":
        assert float(pst.energies.temp) > 0.0
    if name == "ewald-nacl":
        assert abs(float(pst.energies.coul2)) > 1.0


# --- the RDF sample on the mesh ---

@pytest.mark.parametrize("name", ["allpairs", "cells"])
def test_rdf_sample_on_mesh_equals_jax(name):
    """One step, then the RDF sample on the mesh: histogram exactly JAX's
    slab sample (integer counts psummed, the same weights), through the
    all-pairs rows and the cell-candidate rows."""
    from aztotmd_tpu.core.config import make_cell_grid as j_make_cell_grid
    from aztotmd_tpu.ops.rdf import RdfConfig as JRdf
    from aztotmd_tpu.ops.rdf import zero_hist as j_zero_hist
    from aztotmd_tpu_torch.ops.rdf import RdfConfig
    if name == "allpairs":
        (cfg, ff, state, aux), r_rdf = clustered_slab_system(n_dev=4), 10.0
    else:
        (cfg, ff, state, aux), r_rdf = _slab_system(), 6.0
    n_dev = 4
    grid = j_make_cell_grid(cfg.box, r_rdf, cfg.n_at,
                            pos=np.asarray(state.pos))
    kw = dict(n_bin=int(r_rdf / 0.05), d_rdf=0.05, r2_max=r_rdf * r_rdf,
              n_spec=cfg.n_spec, n_nucl=cfg.n_nucl, nuclei=False)
    jr = JRdf(grid=grid, **kw)
    assert (cfg.n_at > len(grid.stencil) * grid.cap) == (name == "cells")
    snuc = np.zeros(cfg.n_spec, np.int32)
    nnum = np.full(max(cfg.n_nucl, 1), cfg.n_at, np.int32)
    mesh = make_mesh(n_dev, axis="x")
    chunk = jslab.make_slab_rdf_chunk(cfg, jr, aux, mesh, snuc, nnum, 1)
    h, nh = j_zero_hist(jr)
    jst, jh, _ = chunk(jslab.make_slab_state(cfg, state, mesh), h, nh, ff, 1)

    pcfg, pff, pst, paux = _port(cfg, ff, state, aux)
    comm = LocalRing(n_dev)
    st = slab.make_slab_multi_step(pcfg, paux, comm)(
        slab.make_slab_state(pcfg, pst, comm), pff, 1)
    rcfg = RdfConfig(grid=convert._grid(grid), **kw)
    sample = slab.make_slab_rdf_sample(pcfg, rcfg, comm, torch.as_tensor(snuc),
                                       torch.as_tensor(nnum))
    ph, _ = sample(st, torch.zeros((rcfg.n_bin, rcfg.n_pair)), None)
    assert float(ph.sum()) > 0.0
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))


# --- refusals and routing ---

def test_prepare_slab_cfg_refusals_and_routing(capsys):
    """molten_salt (a 3^3 grid) and a single slab are refused with JAX's
    messages; the nanoclusters deck is routed to the dense pass with
    JAX's note; an f64 pallas deck stays on the stencil pass; reactive and
    bonded decks are routed as in JAX (the stencil pass) and build their
    slab steps."""
    from aztotmd_tpu.runtime.setup import load_deck_dir as j_load
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    salt = os.path.join(ROOT, "examples", "molten_salt")
    for n_dev, msg in ((2, "27-point stencil"), (1, ">= 2 devices")):
        jcfg = j_load(salt, dtype="f32")["cfg"]
        pcfg = load_deck_dir(salt, dtype="f32")["cfg"]
        errs = []
        for fn, c in ((jslab.prepare_slab_cfg, jcfg),
                      (slab.prepare_slab_cfg, pcfg)):
            with pytest.raises(ValueError, match=msg) as e:
                fn(c, n_dev)
            errs.append(str(e.value))
        assert errs[0] == errs[1]

    capsys.readouterr()
    nano = os.path.join(ROOT, "examples", "nanoclusters")
    jcfg = jslab.prepare_slab_cfg(j_load(nano, dtype="f32")["cfg"], 4)
    jerr = capsys.readouterr().err
    pcfg = slab.prepare_slab_cfg(load_deck_dir(nano, dtype="f32")["cfg"], 4)
    perr = capsys.readouterr().err
    assert pcfg.pair_engine == jcfg.pair_engine == "pallas"
    assert perr == jerr and "dense rectangular pair pass" in perr
    assert pcfg.grid.dims == tuple(jcfg.grid.dims) == (20, 22, 22)
    assert pcfg.grid.cap == jcfg.grid.cap

    f64 = load_deck_dir(nano, dtype="f64")["cfg"]
    assert slab.prepare_slab_cfg(f64, 4).pair_engine == "block"

    for deck in ("reactive_polymer", "bonded_fluid"):
        path = os.path.join(ROOT, "examples", deck)
        d = load_deck_dir(path)
        cfg = slab.prepare_slab_cfg(d["cfg"], 2)
        jcfg = jslab.prepare_slab_cfg(j_load(path)["cfg"], 2)
        assert cfg.pair_engine == jcfg.pair_engine == "block"
        assert cfg.grid.dims == tuple(jcfg.grid.dims)
        assert callable(slab.make_slab_step(cfg, d["aux"], LocalRing(2)))


# --- the two communicators ---

_DIST_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from aztotmd_tpu_torch.parallel import slab
    from aztotmd_tpu_torch.parallel.comm import DistRing, init_dist
    torch.set_num_threads(1)
    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_dist("cpu", init_method="file://" + store, rank=rank,
              world_size=2, timeout_s=60)
    d = torch.load(inp, weights_only=False)
    comm = DistRing()
    st = slab.make_slab_state(d["cfg"], d["state"], comm)
    assert st.pos.shape[0] == 1
    st = slab.make_slab_multi_step(d["cfg"], d["aux"], comm)(st, d["ff"], 6)
    g = slab.gather_state(st, d["cfg"].n_at, comm)
    if rank == 0:
        np.save(out, g["pos"])
    dist.destroy_process_group()
""")


def test_dist_ring_on_gloo_equals_local_ring(tmp_path):
    """The clustered slab system on the dense pass over two gloo processes
    (one slab each, shifts by isend/irecv, psums by all_reduce) against
    both slabs in one process: positions atol 1e-6 A after 6 steps.  A
    rank that dies makes the run fail within the timeout, not hang."""
    cfg, ff, state, aux = clustered_slab_system(n_dev=2)
    pcfg, pff, pst, paux = _port(cfg, ff, state, aux)
    inp = tmp_path / "system.pt"
    torch.save(dict(cfg=pcfg, ff=pff, state=pst, aux=paux), inp)
    out = tmp_path / "pos.npy"
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
    st = slab.make_slab_multi_step(pcfg, paux, comm)(
        slab.make_slab_state(pcfg, pst, comm), pff, 6)
    g = slab.gather_state(st, pcfg.n_at, comm)
    np.testing.assert_allclose(np.load(out), g["pos"], rtol=0, atol=1e-6)
