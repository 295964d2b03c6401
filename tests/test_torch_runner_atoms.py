"""`run --mesh N --mesh-mode atoms` of the port (the atom-sharded step of
parallel/mesh.py through the runner and the CLI, on the CPU) against the
JAX package's one-device runner and the port's own: output files,
checkpoints that either package resumes on one device, a list regrow,
the refusals and ``--dist`` under torchrun.  Over a ``LocalRing`` the
atom-sharded run is the one-device run in another layout, so its files
are the one-device run's byte for byte."""

import os
import subprocess
import sys

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

from test_torch_graph import _salt_deck

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BONDED = os.path.join(ROOT, "examples", "bonded_fluid")
OUTPUTS = ("stat.dat", "rdf.dat", "msd.dat", "msd_d.dat", "revcon.xyz",
           "velocities.dat")


def _table(path):
    return np.loadtxt(path, skiprows=2, ndmin=2)


def _same_files(a, b, names):
    for name in names:
        with open(os.path.join(a, name)) as f, \
                open(os.path.join(b, name)) as g:
            text = f.read()
            assert text and text == g.read(), name


def test_atoms_run_matches_jax_and_one_device(tmp_path):
    """examples/molten_salt's rock salt cut to 512 ions (its control and
    field: Ewald, Nose-Hoover), 200 steps f32 through `run --mesh 8
    --mesh-mode atoms --cpu`: stat.dat within rtol 2e-4 / atol 5e-4 of the
    JAX package's one-device runner (tests/test_parallel.py:454-485), and
    every output file equal to the port's one-device run byte for byte."""
    deck = str(tmp_path / "salt")
    _salt_deck(deck)
    out8, out1, outj = (str(tmp_path / k) for k in ("atoms", "one", "jax"))
    r8 = main(["run", deck, "--mesh", "8", "--mesh-mode", "atoms", "--cpu",
               "--steps", "200", "-o", out8, "--quiet"])
    assert r8._atoms_mesh is not None and r8.comm is None
    assert r8.state.pos.shape == (8, 64, 3) and int(r8.state.step) == 200
    r1 = main(["run", deck, "--cpu", "--steps", "200", "-o", out1,
               "--quiet"])
    _same_files(out8, out1, OUTPUTS)
    j = JRunner(j_load_deck_dir(deck, dtype="f32"), out_dir=outj,
                quiet=True)
    j.run(200)
    j.finalize()
    s8, sj = _table(os.path.join(out8, "stat.dat")), _table(
        os.path.join(outj, "stat.dat"))
    assert s8.shape == sj.shape == (2, s8.shape[1]) and np.isfinite(s8).all()
    np.testing.assert_allclose(s8, sj, rtol=2e-4, atol=5e-4)
    assert r1.cfg.elec_type == 2 and s8[:, 6].min() != 0.0   # engCoul2


def test_atoms_regrow_gives_one_device_outputs(tmp_path, capsys):
    """examples/bonded_fluid over 4 shards, 800 steps f32: its inner list
    regrows (K 24 -> 36, the largest count of the run's one ring window
    of 8 stat periods, as the JAX runner's stat ring regrows it) with the
    one-device run's warning; the run gathers, regrows and shards again,
    and writes the one-device run's files byte for byte (revangles.txt
    and revbonds.txt too)."""
    out4, out1 = str(tmp_path / "atoms"), str(tmp_path / "one")
    r4 = main(["run", BONDED, "--mesh", "4", "--mesh-mode", "atoms",
               "--cpu", "--steps", "800", "-o", out4, "--quiet"])
    warn4 = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("WARNING")]
    r1 = main(["run", BONDED, "--cpu", "--steps", "800", "-o", out1,
               "--quiet"])
    warn1 = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("WARNING")]
    assert r4.cfg.n_neigh == r1.cfg.n_neigh == 36
    assert warn4 == warn1 and any("K=36" in w for w in warn4)
    assert r4.state.nbr_idx.shape == (4, 48, 36)
    _same_files(out4, out1, OUTPUTS + ("revangles.txt", "revbonds.txt"))


def test_atoms_checkpoint_resumes_on_one_device_in_both(tmp_path):
    """A checkpoint of an atoms-mode run over 4 shards at step 100 is a
    single-device MDState: the port resumes it on one device and reaches
    the atoms run's state at step 200 exactly; the JAX package resumes it
    too, within f32 tolerance (atol 1e-4 A)."""
    rm = MDRunner(load_deck_dir(BONDED, dtype="f32"),
                  out_dir=str(tmp_path / "atoms"), quiet=True,
                  mesh_devices=4, mesh_mode="atoms", checkpoint_every=100)
    rm.run(100)
    ck = str(tmp_path / "step100.npz")
    os.replace(tmp_path / "atoms" / "checkpoint.npz", ck)
    rm.run(200)
    ref = rm.mdstate()
    assert ref.pos.shape == (192, 3)

    sysd = load_deck_dir(BONDED, dtype="f32")
    sysd["state"] = load_checkpoint(ck, sysd["state"])
    assert int(sysd["state"].step) == 100
    rp = MDRunner(sysd, out_dir=str(tmp_path / "port"), quiet=True,
                  append=True)
    rp.run(200)
    for k in ("pos", "vel", "types", "bond_type", "nbr_idx"):
        assert torch.equal(getattr(rp.state, k), getattr(ref, k)), k

    jsys = j_load_deck_dir(BONDED, dtype="f32")
    jsys["state"] = j_load_ckpt(ck, jsys["state"])
    rj = JRunner(jsys, out_dir=str(tmp_path / "jax"), quiet=True,
                 append=True)
    rj.run(200)
    assert int(rj.state.step) == 200
    np.testing.assert_allclose(np.asarray(rj.state.pos), ref.pos.numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_dev, mode", [(5, "atoms"), (4, "rings")])
def test_atoms_refusals_have_jax_texts(n_dev, mode, tmp_path):
    """192 atoms over 5 shards, and an unknown mesh mode: the JAX
    runner's ValueError texts."""
    with pytest.raises(ValueError) as got:
        MDRunner(load_deck_dir(BONDED, dtype="f32"), out_dir=str(tmp_path),
                 quiet=True, mesh_devices=n_dev, mesh_mode=mode)
    with pytest.raises(ValueError) as want:
        JRunner(j_load_deck_dir(BONDED, dtype="f32"), out_dir=str(tmp_path),
                quiet=True, mesh_devices=n_dev, mesh_mode=mode)
    assert str(got.value) == str(want.value)


def test_atoms_dist_cli_under_torchrun_equals_one_process(tmp_path):
    """`run --mesh 2 --mesh-mode atoms --dist --cpu` under torchrun (two
    gloo processes, one row shard each, the rows all-gathered every step)
    writes the stat.dat and rdf.dat of the one-process atoms run, byte for
    byte; rank 1 writes its own copy under <out>/rank1."""
    out_d, out_l = tmp_path / "dist", tmp_path / "local"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "aztotmd_tpu_torch", "run", BONDED,
         "--mesh", "2", "--mesh-mode", "atoms", "--dist", "--cpu",
         "--steps", "100", "-o", str(out_d), "--quiet"], env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    main(["run", BONDED, "--mesh", "2", "--mesh-mode", "atoms", "--cpu",
          "--steps", "100", "-o", str(out_l), "--quiet"])
    for name in ("stat.dat", "rdf.dat"):
        local = (out_l / name).read_text()
        assert (out_d / name).read_text() == local, name
        assert (out_d / "rank1" / name).read_text() == local, name
