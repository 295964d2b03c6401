"""Constant bonds and angles on the port's slab mesh
(``aztotmd_tpu_torch/parallel/slab.py``: the per-atom topology records of
``make_slab_state`` and ``_bonded_pass``) against the JAX package's slab
step on the conftest's virtual CPU mesh: the records exactly, 40 f64 steps
of examples/bonded_fluid parked on a slab boundary, the count of records
whose partner lies beyond one slab and the runner's warning for it, and
`run --mesh 4 --cpu` against the JAX runner's mesh run."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.parallel import make_mesh
from aztotmd_tpu.parallel import slab as jslab
from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.parallel import slab
from aztotmd_tpu_torch.parallel.comm import LocalRing
from aztotmd_tpu_torch.parallel.slab_react import _FIELDS
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

from test_torch_runner import _table
from test_torch_slab import _port

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")
_TOPO = ("bnd_partner", "bnd_type", "ang_c", "ang_l1", "ang_l2", "ang_t")


def _deck(name, n_dev, dtype="f64"):
    """An example deck loaded by the JAX package, slab-prepared."""
    d = j_load_deck_dir(os.path.join(EX, name), dtype=dtype)
    return (jslab.prepare_slab_cfg(d["cfg"], n_dev), d["ff"], d["state"],
            d["aux"])


def _both(cfg, ff, state, aux, n_dev, n):
    """(JAX slab state, port slab state, port comm) after n steps."""
    mesh = make_mesh(n_dev, axis="x")
    jst = jslab.make_slab_state(cfg, state, mesh)
    if n:
        jst = jslab.make_slab_multi_step(cfg, aux, mesh)(jst, ff, n)
    pcfg, pff, pst, paux = _port(cfg, ff, state, aux)
    comm = LocalRing(n_dev)
    st = slab.make_slab_state(pcfg, pst, comm)
    if n:
        st = slab.make_slab_multi_step(pcfg, paux, comm)(st, pff, n)
    return jst, st, comm


@pytest.mark.parametrize("name,n_dev,widths", [
    ("bonded_fluid", 4, (2, 1)), ("reactive_polymer", 2, (1, 1)),
    ("ejump_redox", 3, (1, 1))])
def test_slab_state_topology_records_match_jax(name, n_dev, widths):
    """make_slab_state's per-atom records (partner, type; central, two
    ligands, type) and their widths B and A equal JAX's slot for slot; on
    the reactive decks they are JAX's 1-wide empty records and ``rg``
    equals the MDState's tables (JAX's make_globals)."""
    cfg, ff, state, aux = _deck(name, n_dev)
    jst, st, _ = _both(cfg, ff, state, aux, n_dev, 0)
    for k in _TOPO:
        got = getattr(st, k).reshape((-1,) + tuple(getattr(st, k).shape[2:]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jst, k)),
                                      err_msg=k)
    assert (st.bnd_type.shape[2], st.ang_t.shape[2]) == widths
    if name == "bonded_fluid":
        assert st.rg is None and jst.rg is None
        # each live bond has a record on both sides, each angle three
        assert int((st.bnd_type != 0).sum()) == 2 * int(
            (np.asarray(state.bond_type) != 0).sum()) > 0
        assert int((st.ang_t != 0).sum()) == 3 * int(
            (np.asarray(state.ang_type) != 0).sum()) > 0
        return
    assert int((st.bnd_type != 0).sum()) == 0
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(st.rg, k).numpy(),
                                      np.asarray(getattr(jst.rg, k)),
                                      err_msg=k)


def _parked_bonded_fluid(n_dev=4):
    """examples/bonded_fluid in f64 with its median x moved onto a slab
    boundary and an x-drift of 4 A/ps on every atom, so that whole
    molecules cross slabs (JAX's bonded slab test), grid.cap + 8."""
    cfg, ff, state, aux = _deck("bonded_fluid", n_dev)
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, cap=cfg.grid.cap + 8))
    pos = np.asarray(state.pos)
    xs = np.sort(pos[:, 0])
    shift = cfg.box[0] / n_dev - xs[len(xs) // 2]
    pos = (pos + np.array([shift, 0.0, 0.0])) % np.asarray(cfg.box)
    vel = np.asarray(state.vel) + np.array([4.0, 0.0, 0.0])
    state = state.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                          pos0=jnp.asarray(pos.copy()),
                          nbr_ref=jnp.asarray(pos + 1e9))
    return cfg, ff, state, aux


def test_bonded_slab_steps_match_jax():
    """40 f64 steps of the parked bonded fluid over 4 slabs: the slot
    layout and the records that migrated with their atoms equal JAX's,
    positions and velocities atol 1e-8, the bond and angle energies rel
    1e-9; no record lost its partner and molecules crossed slabs."""
    cfg, ff, state, aux = _parked_bonded_fluid()
    jst, st, comm = _both(cfg, ff, state, aux, 4, 40)
    assert int(st.bond_miss) == int(jst.bond_miss) == 0
    assert int(st.mig_total) == int(jst.mig_total) > 0
    assert int(st.mig_lost) == 0
    np.testing.assert_array_equal(st.gid.reshape(-1).numpy(),
                                  np.asarray(jst.gid))
    for k in _TOPO:
        got = getattr(st, k).reshape((-1,) + tuple(getattr(st, k).shape[2:]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jst, k)),
                                      err_msg=k)
    g = slab.gather_state(st, cfg.n_at, comm)
    jg = jslab.gather_state(jst, cfg.n_at)
    np.testing.assert_allclose(g["pos"], jg["pos"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(g["vel"], jg["vel"], rtol=0, atol=1e-8)
    for k in ("bond", "angle"):
        assert float(getattr(st.energies, k)) == pytest.approx(
            float(getattr(jst.energies, k)), rel=1e-9, abs=1e-12), k
        assert float(getattr(st.energies, k)) > 0.0
    assert float(st.energies.tot) == pytest.approx(float(jst.energies.tot),
                                                   rel=1e-9)


def test_bonded_dense_slab_steps_match_jax():
    """bonded_fluid in f32 on "pallas" over 4 slabs: both packages route
    it to the dense rectangular pass (K2's plain version here, JAX's
    interpret kernel there) with the bonded pass after it; 6 steps,
    positions atol 5e-4 A (the bounds of JAX's dense slab test), the bond
    and angle energies rel 1e-4, no record lost."""
    d = j_load_deck_dir(os.path.join(EX, "bonded_fluid"), dtype="f32",
                        pair_engine="pallas")
    cfg = jslab.prepare_slab_cfg(d["cfg"], 4)
    assert cfg.pair_engine == "pallas"
    jst, st, comm = _both(cfg, d["ff"], d["state"], d["aux"], 4, 6)
    assert int(st.bond_miss) == int(jst.bond_miss) == 0
    g = slab.gather_state(st, cfg.n_at, comm)
    np.testing.assert_allclose(g["pos"], jslab.gather_state(
        jst, cfg.n_at)["pos"], rtol=0, atol=5e-4)
    for k in ("bond", "angle"):
        assert float(getattr(st.energies, k)) == pytest.approx(
            float(getattr(jst.energies, k)), rel=1e-4), k


def test_stretched_bond_counts_misses_like_jax(tmp_path, capsys):
    """One bonded atom moved half a box along x, two slabs from its
    partner: after 2 steps the records that could not find a partner in
    the +-1-slab table (both sides of its bond and the angle records that
    name it) count as in JAX, their forces are dropped in both, and the
    runner's warning reads as the JAX runner's."""
    cfg, ff, state, aux = _deck("bonded_fluid", 4)
    at1 = int(np.asarray(state.bond_at1)[0])
    pos = np.array(state.pos)
    pos[at1, 0] = (pos[at1, 0] + cfg.box[0] / 2) % cfg.box[0]
    state = state.replace(pos=jnp.asarray(pos), nbr_ref=jnp.asarray(pos + 1e9))
    jst, st, comm = _both(cfg, ff, state, aux, 4, 2)
    assert int(st.bond_miss) == int(jst.bond_miss) > 0
    g = slab.gather_state(st, cfg.n_at, comm)
    np.testing.assert_allclose(g["pos"], jslab.gather_state(
        jst, cfg.n_at)["pos"], rtol=0, atol=1e-8)

    miss = torch.tensor(int(st.bond_miss), dtype=torch.int32)
    r = MDRunner(load_deck_dir(os.path.join(EX, "bonded_fluid")),
                 out_dir=str(tmp_path / "t"), quiet=True, mesh_devices=4)
    j = JRunner(j_load_deck_dir(os.path.join(EX, "bonded_fluid")),
                out_dir=str(tmp_path / "j"), quiet=True, mesh_devices=4)
    capsys.readouterr()
    r.state = r.state.replace(bond_miss=miss)
    r._check_monitors(r._monitors())
    r._check_monitors(r._monitors())    # warns once per new count
    err_t = capsys.readouterr().err
    j.state = j.state.replace(bond_miss=jnp.asarray(int(miss), jnp.int32))
    j._check_slab_health()
    err_j = capsys.readouterr().err
    assert err_t == err_j and "outside the +-1-slab reach" in err_t


def _read(path):
    with open(path) as f:
        return f.read()


def test_mesh4_bonded_fluid_run_matches_jax_runner(tmp_path, monkeypatch):
    """`run --mesh 4 --cpu --dtype f64` on examples/bonded_fluid for 200
    steps (a stat row every 100) against the JAX runner's 4-device mesh
    run: stat.dat (bond and angle energies included) and stat_bnd.dat rtol
    1e-8, revbonds.txt, revangles.txt and lengths.dat equal; both runners
    on their host chunk loop (AZTOTMD_NO_RING)."""
    deck = os.path.join(EX, "bonded_fluid")
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    r = main(["run", deck, "--mesh", "4", "--cpu", "--dtype", "f64",
              "--steps", "200", "-o", out_t, "--quiet"])
    assert r.comm.n_dev == 4 and r.state.rg is None
    assert int(r.state.bond_miss) == 0
    j = JRunner(j_load_deck_dir(deck, dtype="f64"), out_dir=out_j,
                quiet=True, mesh_devices=4)
    j.run(200)
    j.finalize()
    for name in ("stat.dat", "stat_bnd.dat"):
        a = _table(os.path.join(out_t, name))
        b = _table(os.path.join(out_j, name))
        assert a.shape == b.shape and a.shape[0] == 2, name
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=name)
    for name in ("revbonds.txt", "revangles.txt", "lengths.dat"):
        assert _read(os.path.join(out_t, name)) == _read(
            os.path.join(out_j, name)), name
    assert len(_read(os.path.join(out_t, "revangles.txt")).splitlines()) > 1


def test_regrow_redistributes_the_records(tmp_path, capsys):
    """A slot-capacity regrow on bonded_fluid over 4 slabs (a deletion
    reported by the migration counters) redistributes every atom with its
    B- and A-wide records: each atom's records are the same after it, and
    the run goes on without a miss."""
    r = MDRunner(load_deck_dir(os.path.join(EX, "bonded_fluid"),
                               dtype="f64"),
                 out_dir=str(tmp_path / "o"), quiet=True, mesh_devices=4)
    r.run(10)

    def records(st):
        gid = st.gid.reshape(-1)
        live = gid >= 0
        return {k: getattr(st, k).reshape((-1,) + tuple(
            getattr(st, k).shape[2:]))[live][torch.argsort(gid[live])]
            for k in _TOPO}

    before, C0 = records(r.state), r.state.pos.shape[1]
    r.state = r.state.replace(mig_lost=torch.tensor(1, dtype=torch.int32))
    r._check_monitors(r._monitors())
    assert "DELETED 1 atoms" in capsys.readouterr().err
    assert r.state.pos.shape[1] > C0
    assert r.state.bnd_type.shape[2] == 2 and r.state.ang_t.shape[2] == 1
    after = records(r.state)
    for k in _TOPO:
        assert torch.equal(after[k], before[k]), k
    r.run(20)
    assert int(r.state.bond_miss) == 0 and int(r.state.step) == 20
