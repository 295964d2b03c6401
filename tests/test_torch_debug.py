"""The port's debug checks and the CLI's ``--debug``, ``--timings`` and
``--profile`` (``aztotmd_tpu_torch/runtime/debug.py``,
``aztotmd_tpu_torch/utils/profiling.py``) against the JAX package's, on
the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime.debug import CHECKS as J_CHECKS
from aztotmd_tpu.runtime.debug import check_state as j_check_state
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import convert, systems
from aztotmd_tpu_torch.__main__ import main
from aztotmd_tpu_torch.runtime.debug import (CHECKS, assert_state_ok,
                                             check_state)
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BONDED = os.path.join(ROOT, "examples", "bonded_fluid")


def _violations(s, cfg):
    """One violation of each kind (the NaN position is also out of no
    box; the infinite velocity is also past the bound; the species id
    past the table also unbalances spec_number)."""
    N = cfg.n_at
    s["pos"][0, 0] = np.nan
    s["vel"][1, 1] = np.inf
    s["frc"][2, 2] = np.nan
    s["pos"][3, 0] = -1.0
    s["types"][4] = cfg.n_spec
    s["types"][7] = -1
    live = np.flatnonzero(s["bond_type"] != 0)
    s["bond_at1"][live[0]] = N + 5
    s["bond_type"][live[1]] = max(cfg.n_bond_types, 1)
    s["ang_lig1"][np.flatnonzero(s["ang_type"] != 0)[0]] = -1
    s["vel"][5, 0] = 2.0e5
    return s


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_check_state_counts_equal_jax(dtype):
    """examples/bonded_fluid with one violation of each kind: the same
    ten counts in both packages, every check firing; the clean state has
    none."""
    p = load_deck_dir(BONDED, dtype=dtype)
    j = j_load_deck_dir(BONDED, dtype=dtype)
    cfg = p["cfg"]
    assert CHECKS == J_CHECKS
    assert check_state(cfg, p["state"]).tolist() == [0] * len(CHECKS)
    assert_state_ok(cfg, p["state"])
    bad = _violations(convert.state_to_numpy(p["state"]), cfg)
    keys = ("pos", "vel", "frc", "types", "bond_at1", "bond_type",
            "ang_lig1")
    ps = p["state"].replace(**{k: torch.as_tensor(bad[k]) for k in keys})
    js = j["state"].replace(**{k: jnp.asarray(bad[k]) for k in keys})
    got = check_state(cfg, ps)
    want = np.asarray(j_check_state(j["cfg"], js))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    assert all(v > 0 for v in got.tolist()), dict(zip(CHECKS, got.tolist()))
    with pytest.raises(AssertionError, match="pos_finite"):
        assert_state_ok(cfg, ps)


@pytest.fixture(scope="module")
def small_deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("surkov300"))
    systems.write_surkov_cluster_deck(d, n_atoms=300, box=20.0, steps=100,
                                      n_equil=20)
    return d


@pytest.mark.parametrize("flags", [["--debug"], ["--timings"],
                                   ["--debug", "--profile", "TRACE"]])
def test_run_debug_timings_profile(small_deck, flags, tmp_path, capfd):
    """``run --debug``, ``--timings`` and ``--profile LOG_DIR`` on the
    CPU: the run finishes; with --timings or --profile the loop wall line
    and the stage report go to stderr, and --profile writes its trace."""
    flags = [str(tmp_path / "trace") if f == "TRACE" else f for f in flags]
    r = main(["run", small_deck, "--cpu", "--steps", "40", "--quiet", "-o",
              str(tmp_path / "out")] + flags)
    assert int(r.state.step) == 40 and r.debug == ("--debug" in flags)
    err = capfd.readouterr().err
    if "--debug" in flags and len(flags) == 1:
        assert "loop wall" not in err
        return
    assert "loop wall:" in err and "steps/s" in err
    assert "stage " in err and "\nsteps " in err and "\nsampling " in err
    if "--profile" in flags:
        assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
