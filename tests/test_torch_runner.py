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
from aztotmd_tpu_torch.systems import (write_nanoclusters_deck,
                                       write_surkov_cluster_deck)

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them (these
# systems are a few hundred atoms).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("surkov_run"))
    write_surkov_cluster_deck(d, n_atoms=240, box=18.0, steps=400,
                              n_equil=100)
    return d


@pytest.fixture(scope="module")
def nose_deck(tmp_path_factory):
    """Three 128-atom Ar LJ clusters, Nose-Hoover (nanoclusters' shape)."""
    d = str(tmp_path_factory.mktemp("nose_clusters"))
    write_nanoclusters_deck(d, n_clusters=3, per=128, box=50.0,
                            min_sep=25.0, steps=200)
    return d


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
    """stat.dat / rdf.dat / msd.dat of a 400-step f64 run from both CLIs.
    The JAX runner runs its host chunk loop (AZTOTMD_NO_RING): its
    on-device stat ring rounds stat rows to f32 and is not ported."""
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    runner = main(["run", deck, "--cpu", "--dtype", "f64", "-o", out_t,
                   "--quiet"])
    assert int(runner.state.step) == 400
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
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
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_cli_runs_with_jax_blocked(deck, nose_deck, tmp_path):
    """The CLI on the Surkov deck and the runner on a sparse Nose-Hoover
    deck, with jax and the JAX package unimportable."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, deck, nose_deck,
         str(tmp_path / "out")],
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
