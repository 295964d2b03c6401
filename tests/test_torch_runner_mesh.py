"""`run --mesh N` of the port (the slab-decomposed step through the
runner and the CLI, on the CPU) against the JAX package's runner with
``mesh_devices=N`` on the conftest's virtual CPU mesh: output files,
mesh-independent checkpoints that either package resumes on one device,
the slab health monitors and the refusals."""

import os

import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime.checkpoint import load_checkpoint as j_load_ckpt
from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.runtime.checkpoint import load_checkpoint
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.systems import write_lj_deck, write_surkov_cluster_deck

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(path):
    return np.loadtxt(path, skiprows=2, ndmin=2)


@pytest.fixture(scope="module")
def lj_deck(tmp_path_factory):
    """729 Ar atoms, radiative thermostat, Fennel, RDF every 50 steps,
    stat every 100: the JAX package's mesh runner fixture."""
    d = str(tmp_path_factory.mktemp("lj_deck"))
    write_lj_deck(d)
    return d


@pytest.fixture(scope="module")
def cluster_deck(tmp_path_factory):
    """240 Surkov atoms of the slice deck's writer at its 0.43 atoms/A^3
    in a 26 A box (four 6 A cells across, so two slabs fit), 40 steps with
    a stat row every 20: a dense deck, so the mesh takes K2's route."""
    d = str(tmp_path_factory.mktemp("surkov_mesh"))
    write_surkov_cluster_deck(d, n_atoms=240, box=26.0, steps=40,
                              n_equil=20)
    ctl = os.path.join(d, "control.txt")
    with open(ctl) as f:
        text = f.read()
    with open(ctl, "w") as f:
        f.write(text.replace("stat\t200", "stat\t20"))
    return d


def _compare_outputs(out_t, out_j, rows):
    s_t, s_j = _table(os.path.join(out_t, "stat.dat")), _table(
        os.path.join(out_j, "stat.dat"))
    assert s_t.shape == s_j.shape and s_t.shape[0] == rows
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4, atol=2e-5)
    g_t, g_j = _table(os.path.join(out_t, "rdf.dat")), _table(
        os.path.join(out_j, "rdf.dat"))
    assert g_t.shape == g_j.shape and g_t[:, 1].max() > 0.0
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-4)


def test_mesh4_run_matches_jax_runner(lj_deck, tmp_path):
    """`run --mesh 4 --cpu` on the LJ deck (the stencil pass) against the
    JAX runner over a 4-device mesh: stat.dat rtol 1e-4 atol 2e-5, rdf.dat
    rtol 1e-4 atol 1e-4; nothing lost, no cell over capacity."""
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    r = main(["run", lj_deck, "--mesh", "4", "--cpu", "-o", out_t,
              "--quiet"])
    assert r.comm.n_dev == 4 and r.cfg.pair_engine == "block"
    assert int(r.state.step) == 300
    j = JRunner(j_load_deck_dir(lj_deck, dtype="f32"), out_dir=out_j,
                quiet=True, mesh_devices=4)
    j.run()
    j.finalize()
    _compare_outputs(out_t, out_j, 3)
    assert int(r.state.mig_lost) == 0
    assert int(r.state.slab_occ) <= r.cfg.grid.cap
    for name in ("revcon.xyz", "velocities.dat", "tchars.dat", "msd.dat"):
        assert os.path.getsize(os.path.join(out_t, name)) > 0


def test_mesh2_dense_run_matches_jax_runner(cluster_deck, tmp_path):
    """`run --mesh 2 --cpu` on the dense cluster deck: both packages route
    it to the dense rectangular pass (K2's plain version here, JAX's
    interpret kernel there), one halo copy on two slabs; stat.dat and
    rdf.dat within the tolerances above after 40 f32 steps."""
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    r = main(["run", cluster_deck, "--mesh", "2", "--cpu", "-o", out_t,
              "--quiet"])
    assert r.cfg.pair_engine == "pallas" and r.cfg.use_radii
    j = JRunner(j_load_deck_dir(cluster_deck, dtype="f32"), out_dir=out_j,
                quiet=True, mesh_devices=2)
    assert j.cfg.pair_engine == "pallas"
    j.run()
    j.finalize()
    _compare_outputs(out_t, out_j, 2)
    assert int(r.state.mig_lost) == 0


def test_mesh_checkpoint_resumes_on_one_device_in_both(tmp_path):
    """A checkpoint of a `--mesh 4` run at step 60 is a single-device
    MDState: the port and the JAX package resume it on one device (the
    block engine, whose neighbor-list fields the checkpoint carries) and
    reach the mesh run's positions at step 120 within f32 tolerance (atol
    1e-4 A)."""
    deck = str(tmp_path / "deck")
    os.makedirs(deck)
    write_lj_deck(deck, steps=120)
    rm = MDRunner(load_deck_dir(deck, dtype="f32", pair_engine="block"),
                  out_dir=str(tmp_path / "mesh"), quiet=True,
                  mesh_devices=4, checkpoint_every=30)
    rm.run(60)
    ck = str(tmp_path / "step60.npz")
    os.replace(tmp_path / "mesh" / "checkpoint.npz", ck)
    rm.run()
    ref = rm.mdstate().pos.numpy()

    sysd = load_deck_dir(deck, dtype="f32", pair_engine="block")
    sysd["state"] = load_checkpoint(ck, sysd["state"])
    assert int(sysd["state"].step) == 60
    rp = MDRunner(sysd, out_dir=str(tmp_path / "port"), quiet=True,
                  append=True)
    rp.run()
    np.testing.assert_allclose(rp.state.pos.numpy(), ref, rtol=0, atol=1e-4)

    jsys = j_load_deck_dir(deck, dtype="f32", pair_engine="block")
    jsys["state"] = j_load_ckpt(ck, jsys["state"])
    rj = JRunner(jsys, out_dir=str(tmp_path / "jax"), quiet=True,
                 append=True)
    rj.run()
    assert int(rj.state.step) == 120
    np.testing.assert_allclose(np.asarray(rj.state.pos), ref, rtol=0,
                               atol=1e-4)


def test_slab_health_regrows_and_redistributes(lj_deck, tmp_path, capsys):
    """The slab monitors with the JAX runner's rules: a deletion and a cell
    over capacity grow grid.cap and the slot capacity and redistribute
    every live atom with fresh counters; deferrals warn once, then raise
    the capacity on the third check in a row; the run then goes on."""
    r = MDRunner(load_deck_dir(lj_deck, dtype="f32"),
                 out_dir=str(tmp_path / "out"), quiet=True, mesh_devices=4)
    C0, cap0 = r.state.pos.shape[1], r.cfg.grid.cap
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    r.state = r.state.replace(mig_lost=i32(3), slab_occ=i32(cap0 + 5))
    r._check_monitors(r._monitors())
    err = capsys.readouterr().err
    assert "slab cell occupancy" in err and "DELETED 3 atoms" in err
    assert r.cfg.grid.cap > cap0 and r.state.pos.shape[1] > C0
    assert int((r.state.gid >= 0).sum()) == r.cfg.n_at
    assert int(r.state.mig_lost) == 0

    C1 = r.state.pos.shape[1]
    for hit, defer in enumerate((2, 5, 9)):
        r.state = r.state.replace(mig_defer=i32(defer))
        r._check_monitors(r._monitors())
        assert (r.state.pos.shape[1] > C1) == (hit == 2)
    assert "still deferring after 3 checks" in capsys.readouterr().err
    assert int(r.state.mig_defer) == 0
    r.run(40)
    assert int(r.state.mig_lost) == 0
    assert int((r.state.gid >= 0).sum()) == r.cfg.n_at


def test_mesh_cli_refusals(lj_deck, tmp_path):
    """The atom-sharded mode refuses 729 atoms over 4 shards with the JAX
    runner's text (unequal shards); molten_salt's 3^3 grid is refused as
    in the JAX package; a reactive deck, once refused, now runs on the
    mesh (a short run whose bond table the replicated topology
    carries)."""
    out = str(tmp_path / "o")
    with pytest.raises(ValueError, match="n_at=729 not divisible by mesh "
                       r"size 4 \(atom-sharded mode needs equal shards\)"):
        main(["run", lj_deck, "--mesh", "4", "--mesh-mode", "atoms",
              "--cpu", "-o", out])
    with pytest.raises(ValueError, match="27-point stencil"):
        main(["run", os.path.join(ROOT, "examples", "molten_salt"),
              "--mesh", "2", "--cpu", "-o", out])
    r = main(["run", os.path.join(ROOT, "examples", "reactive_polymer"),
              "--mesh", "2", "--cpu", "--steps", "4", "-o", out, "--quiet"])
    assert int(r.state.step) == 4 and r.state.rg is not None
    assert int(r.state.rg.n_bond) > 0
    assert os.path.getsize(os.path.join(out, "revbonds.txt")) > 0


def test_dist_cli_under_torchrun_equals_one_process(lj_deck, tmp_path):
    """`run --mesh 2 --dist --cpu` under torchrun (two gloo processes, one
    slab each, a free port picked by --standalone) writes the stat.dat
    and rdf.dat of `run --mesh 2 --cpu` in one process, byte for byte;
    rank 1 writes its own copy under <out>/rank1."""
    import subprocess
    import sys
    out_d, out_l = tmp_path / "dist", tmp_path / "local"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "aztotmd_tpu_torch", "run", lj_deck,
         "--mesh", "2", "--dist", "--cpu", "--steps", "100", "-o",
         str(out_d), "--quiet"], env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    main(["run", lj_deck, "--mesh", "2", "--cpu", "--steps", "100", "-o",
          str(out_l), "--quiet"])
    for name in ("stat.dat", "rdf.dat"):
        local = (out_l / name).read_text()
        assert (out_d / name).read_text() == local, name
        assert (out_d / "rank1" / name).read_text() == local, name
