"""The port's run CLI against the JAX CLI, checkpoints across packages,
and the port's independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aztotmd_tpu.__main__ import main as j_main
from aztotmd_tpu.runtime.checkpoint import load_checkpoint as j_load_ckpt
from aztotmd_tpu.runtime.checkpoint import save_checkpoint as j_save_ckpt
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.runtime.step import make_multi_step as j_make_multi_step
from aztotmd_tpu_torch import convert
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.runtime.checkpoint import load_checkpoint
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import make_multi_step
from aztotmd_tpu_torch.systems import (write_ejump_redox_deck,
                                       write_nanoclusters_deck,
                                       write_reactive_polymer_deck,
                                       write_surkov_cluster_deck)

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them (these
# systems are a few hundred atoms).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """240 Surkov atoms in a 11.7 A cluster (0.15 atoms/A^3) in an 18 A
    box.  An f64 run takes the cell-block engine, whose cost goes with
    the square of the fullest cell's capacity: at the slice deck's 0.43
    atoms/A^3 the capacity is 102 slots and 400 CPU steps take minutes,
    at 0.15 it is 28.  ``dense_deck`` keeps one comparison at 0.43."""
    d = str(tmp_path_factory.mktemp("surkov_run"))
    write_surkov_cluster_deck(d, n_atoms=240, box=18.0, density=0.15,
                              steps=400, n_equil=100)
    return d


@pytest.fixture(scope="module")
def dense_deck(tmp_path_factory):
    """The same cluster at the slice deck's 0.43 atoms/A^3 (a 3x3x3 grid of
    102 slots a cell), cut to 40 steps with a stat row every 20."""
    d = str(tmp_path_factory.mktemp("surkov_dense"))
    write_surkov_cluster_deck(d, n_atoms=240, box=18.0, steps=40, n_equil=20)
    ctl = os.path.join(d, "control.txt")
    with open(ctl) as f:
        text = f.read()
    assert "stat\t200" in text
    with open(ctl, "w") as f:
        f.write(text.replace("stat\t200", "stat\t20"))
    return d


@pytest.fixture(scope="module")
def nose_deck(tmp_path_factory):
    """Three 128-atom Ar LJ clusters, Nose-Hoover (nanoclusters' shape)."""
    d = str(tmp_path_factory.mktemp("nose_clusters"))
    write_nanoclusters_deck(d, n_clusters=3, per=128, box=50.0,
                            min_sep=25.0, steps=200)
    return d


@pytest.fixture(scope="module")
def reactive_decks(tmp_path_factory):
    """The two reactive examples' writers cut to 216 and 176 atoms (the
    smallest cuts that keep the dense pair engine)."""
    d = tmp_path_factory.mktemp("reactive")
    rp, ej = str(d / "reactive_polymer"), str(d / "ejump_redox")
    write_reactive_polymer_deck(rp, n_side=6, steps=100)
    write_ejump_redox_deck(ej, n_side=6, n_fe2=48, n_fe3=32, n_o=96,
                           steps=100)
    return rp, ej


def _table(path):
    """Numeric rows of a tab-separated output file (header rows skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append([float(v) for v in line.split()])
            except ValueError:
                continue
    return np.asarray(rows)


def test_run_cli_matches_jax_cli(deck, tmp_path, monkeypatch):
    """stat.dat / rdf.dat / msd.dat of a 400-step f64 run from both CLIs,
    both on their host chunk loop (AZTOTMD_NO_RING: the stat rows read
    from the f64 state; tests/test_torch_runner_ring.py holds the stat
    rings' float32 rows against each other)."""
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    runner = main(["run", deck, "--cpu", "--dtype", "f64", "-o", out_t,
                   "--quiet"])
    assert int(runner.state.step) == 400
    j_main(["--cpu", "run", deck, "-o", out_j, "--dtype", "f64", "--quiet"])
    for name in ("stat.dat", "rdf.dat", "msd.dat", "msd_d.dat"):
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=1e-8, err_msg=name)
    assert _table(os.path.join(out_t, "stat.dat")).shape[0] == 2
    assert _table(os.path.join(out_t, "rdf.dat"))[:, 1].max() > 0.0
    for name in ("revcon.xyz", "velocities.dat", "tchars.dat"):
        assert os.path.getsize(os.path.join(out_t, name)) > 0


def test_run_cli_matches_jax_cli_at_slice_density(dense_deck, tmp_path,
                                                  monkeypatch):
    """The f64 route (the cell-block engine in both packages) at the slice
    deck's density: stat.dat, rdf.dat and msd.dat of 40 steps from both
    CLIs, both on their host chunk loop (AZTOTMD_NO_RING)."""
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    runner = main(["run", dense_deck, "--cpu", "--dtype", "f64", "-o", out_t,
                   "--quiet"])
    assert int(runner.state.step) == 40
    assert runner.cfg.grid.cap == 102
    j_main(["--cpu", "run", dense_deck, "-o", out_j, "--dtype", "f64",
            "--quiet"])
    for name in ("stat.dat", "rdf.dat", "msd.dat", "msd_d.dat"):
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=1e-8, err_msg=name)
    assert _table(os.path.join(out_t, "stat.dat")).shape[0] == 2
    # cell_overflow is the fullest cell's occupancy, not a worklist length
    assert 28 < int(runner.state.cell_overflow) <= 102


@pytest.mark.parametrize("which", [0, 1], ids=["reactive_polymer",
                                              "ejump_redox"])
def test_reactive_run_cli_matches_jax_cli(reactive_decks, which, tmp_path,
                                          monkeypatch):
    """stat.dat, stat_bnd.dat or jumps.dat, msd.dat and rdf.dat of f64
    runs of the cut reactive decks from both CLIs, rtol 1e-8, and
    revbonds.txt and lengths.dat equal byte for byte; both CLIs on their
    host chunk loop (AZTOTMD_NO_RING)."""
    deck = reactive_decks[which]
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    runner = main(["run", deck, "--cpu", "--dtype", "f64", "-o", out_t,
                   "--quiet"])
    j_main(["--cpu", "run", deck, "-o", out_j, "--dtype", "f64", "--quiet"])
    extra = ("stat_bnd.dat",) if which == 0 else ("jumps.dat",)
    for name in ("stat.dat", "msd.dat", "rdf.dat") + extra:
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=1e-8, err_msg=name)
    if which == 0:
        assert int(runner.state.n_bond) > 0
        assert _table(os.path.join(out_t, "stat_bnd.dat"))[-1, 2] > 0
        for name in ("revbonds.txt", "lengths.dat"):
            with open(os.path.join(out_t, name)) as f, \
                    open(os.path.join(out_j, name)) as g:
                assert f.read() == g.read(), name
    else:
        assert int(runner.state.n_jump) > 0
        assert _table(os.path.join(out_t, "jumps.dat"))[-1, 2] > 0
        assert not os.path.exists(os.path.join(out_t, "stat_bnd.dat"))


def test_reactive_checkpoint_resumes_across_packages(reactive_decks,
                                                     tmp_path):
    """A reactive_polymer checkpoint with bonds formed: the bond table,
    n_bond, statistics, parents, nbonds and RNG words pass through the
    other package unchanged, and both continue with the same topology."""
    deck = reactive_decks[0]
    out = str(tmp_path / "ck")
    main(["run", deck, "--cpu", "--dtype", "f64", "-o", out, "--quiet",
          "--steps", "20", "--checkpoint-every", "20"])
    ck = os.path.join(out, "checkpoint.npz")
    j = j_load_deck_dir(deck, dtype="f64")
    js = j_load_ckpt(ck, j["state"])
    p = load_deck_dir(deck, dtype="f64")
    ps = load_checkpoint(ck, p["state"])
    assert int(ps.n_bond) > 0 and int(js.n_bond) == int(ps.n_bond)
    js = j_make_multi_step(j["cfg"], j["aux"])(js, j["ff"], 10)
    ps = make_multi_step(p["cfg"], p["aux"])(ps, p["ff"], 10)
    got = convert.state_to_numpy(ps)
    for name in ("types", "bond_at1", "bond_at2", "bond_type", "n_bond",
                 "parents", "nbonds", "bt_count", "bt_r_count", "rng"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)),
                                      err_msg=name)
    ck2 = str(tmp_path / "jax_ck.npz")
    j_save_ckpt(ck2, js, {"step": 30})
    back = convert.state_to_numpy(load_checkpoint(ck2, p["state"]))
    for name, arr in back.items():
        if name != "energies":
            np.testing.assert_array_equal(arr, np.asarray(getattr(js, name)),
                                          err_msg=name)


def test_checkpoints_resume_across_packages(deck, tmp_path):
    """A port checkpoint resumes in JAX and a JAX checkpoint in the port,
    and both continue on the same trajectory."""
    out = str(tmp_path / "ck")
    runner = main(["run", deck, "--cpu", "--dtype", "f64", "-o", out,
                   "--quiet", "--steps", "20", "--checkpoint-every", "10"])
    ck = os.path.join(out, "checkpoint.npz")
    j = j_load_deck_dir(deck, dtype="f64")
    js = j_load_ckpt(ck, j["state"])
    assert int(js.step) == 20
    np.testing.assert_array_equal(np.asarray(js.pos),
                                  runner.state.pos.numpy())
    np.testing.assert_array_equal(np.asarray(js.rng),
                                  convert.state_to_numpy(runner.state)["rng"])

    js = j_make_multi_step(j["cfg"], j["aux"])(js, j["ff"], 5)
    p = load_deck_dir(deck, dtype="f64")
    ps = load_checkpoint(ck, p["state"])
    ps = make_multi_step(p["cfg"], p["aux"])(ps, p["ff"], 5)
    np.testing.assert_allclose(ps.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=1e-8)

    ck2 = str(tmp_path / "jax_ck.npz")
    j_save_ckpt(ck2, js, {"step": 25})
    back = convert.state_to_numpy(load_checkpoint(ck2, p["state"]))
    for name, arr in back.items():
        if name != "energies":
            np.testing.assert_array_equal(arr, np.asarray(getattr(js, name)),
                                          err_msg=name)
    out2 = str(tmp_path / "resumed")
    r2 = main(["run", deck, "--cpu", "--dtype", "f64", "-o", out2,
               "--quiet", "--steps", "30", "--resume", ck2])
    assert int(r2.state.step) == 30


_NO_JAX = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "aztotmd_tpu")
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
import torch
torch.set_num_threads(1)
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
r = main(["run", sys.argv[1], "--cpu", "--steps", "4", "-o", sys.argv[3],
          "--quiet"])
assert int(r.state.step) == 4
# the block-sparse engine with Nose-Hoover (forced: auto picks it only
# above 4,096 atoms)
sysd = load_deck_dir(sys.argv[2], pair_engine="sparse")
assert sysd["cfg"].pair_engine == "sparse"
r = MDRunner(sysd, out_dir=sys.argv[3] + "_sparse", quiet=True)
r.run(4)
r.finalize()
assert int(r.state.step) == 4 and float(r.state.chit) != 0.0
# the cell-block engine (auto picks it for this deck) and an Ewald deck
r = main(["run", sys.argv[4], "--cpu", "--steps", "4", "-o",
          sys.argv[3] + "_block", "--quiet"])
assert r.cfg.pair_engine == "block" and int(r.state.cell_overflow) > 0
r = main(["run", sys.argv[5], "--cpu", "--steps", "2", "-o",
          sys.argv[3] + "_salt", "--quiet"])
assert float(r.state.energies.coul2) != 0.0
# the reactive decks: bonds, electron jumps and their outputs
for deck in sys.argv[6:]:
    r = main(["run", deck, "--cpu", "--steps", "20", "-o",
              sys.argv[3] + "_r", "--quiet", "--no-bond-equil-hack"])
    assert int(r.state.n_bond) + int(r.state.n_jump) > 0
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_cli_runs_with_jax_blocked(deck, nose_deck, reactive_decks,
                                        tmp_path):
    """The CLI on the Surkov deck, a cell-block deck (reactive_polymer
    tiled 2x2x2), examples/molten_salt (Ewald) and the reactive decks, and
    the runner on a sparse Nose-Hoover deck, with jax and the JAX package
    unimportable."""
    from aztotmd_tpu_torch.systems import tile_deck
    block_deck = str(tmp_path / "poly_x2")
    tile_deck(os.path.join(ROOT, "examples", "reactive_polymer"), block_deck,
              2)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, deck, nose_deck,
         str(tmp_path / "out"), block_deck,
         os.path.join(ROOT, "examples", "molten_salt"), *reactive_decks],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


def test_sparse_regrow_warns_and_grows(nose_deck, tmp_path, capsys):
    """A run started with sparse_pair_cap below the worklist it needs
    warns at the first stat row and grows the capacity by the JAX
    runner's formula, round_up(need + max(64, need // 4), 64)."""
    import dataclasses
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    sysd = load_deck_dir(nose_deck, pair_engine="sparse")
    cfg = sysd["cfg"]
    need = int(make_multi_step(cfg, sysd["aux"])(sysd["state"], sysd["ff"],
                                                 1).cell_overflow)
    assert need > 1
    sysd["cfg"] = dataclasses.replace(cfg, sparse_pair_cap=1)
    runner = MDRunner(sysd, out_dir=str(tmp_path), quiet=True)
    runner.run(200)
    grown = -(-(need + max(64, need // 4)) // 64) * 64
    assert runner.cfg.sparse_pair_cap == grown
    err = capsys.readouterr().err
    assert (f"WARNING: sparse tile-pair count {need} exceeded capacity 1; "
            f"rebuilding with pair_cap={grown}") in err
    # a second stat row with the grown capacity does not warn again
    runner.run(400)
    assert "WARNING" not in capsys.readouterr().err
    assert runner.cfg.sparse_pair_cap == grown


def test_cli_without_gpu_or_cpu_flag_fails_clearly(deck, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["run", deck, "-o", str(tmp_path), "--steps", "1"])
    assert "--cpu" in str(e.value.code)


def test_bench_cli_on_cpu(deck, capsys):
    res = main(["bench", deck, "--cpu", "--steps", "3", "--warmup", "1"])
    assert res["n_at"] == 240 and res["steps_per_sec"] > 0
    assert res["device"] == "cpu"
    assert '"steps_per_sec"' in capsys.readouterr().out
