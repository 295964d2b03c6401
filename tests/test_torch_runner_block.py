"""The runner on the cell-block engines against the JAX package's runner:
a short run of a small liquid-argon deck on "block", on "pallas" and on
"gather", and the cell-capacity regrow (with the f64 monitor of the
sparse engine, and on "gather", which regrows as the block engine
does)."""

import os

import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.systems import write_liquid_argon_deck

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them.
torch.set_num_threads(1)


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


@pytest.fixture(scope="module")
def argon_deck_d021(tmp_path_factory):
    """1,728 Ar atoms from the liquid_argon writer at the liquid's
    density with a 4 A cutoff: 10^3 cells of up to 8 atoms, a shape whose
    cell-block cost stays under the padded N^2, so that "block" stays
    "block" and "pallas" takes the stacked pass; stat and RDF every 200
    steps."""
    d = str(tmp_path_factory.mktemp("argon1728"))
    write_liquid_argon_deck(d, n_side=12, rcut=4.0, steps=400)
    return d


def _both_runners(deck, engine, out_t, out_j, dtype="f64", grid_cap=None):
    """The port's and the JAX package's runner on one deck with the
    engine set (the CLIs have no engine switch), the JAX one on its host
    chunk loop; ``grid_cap`` cuts the cell capacity of both."""
    import dataclasses
    from aztotmd_tpu.runtime.runner import MDRunner as JRunner
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    runners = []
    for load, cls, out in ((load_deck_dir, MDRunner, out_t),
                           (j_load_deck_dir, JRunner, out_j)):
        sysd = load(deck, dtype=dtype, pair_engine=engine)
        assert sysd["cfg"].pair_engine == engine
        if grid_cap is not None:
            g = sysd["cfg"].grid
            sysd["cfg"] = dataclasses.replace(
                sysd["cfg"], grid=dataclasses.replace(g, cap=grid_cap))
        runners.append(cls(sysd, out_dir=out, quiet=True))
    return runners


@pytest.mark.parametrize("engine", ["block", "pallas", "gather"])
def test_argon_run_matches_jax_runner(argon_deck_d021, engine, tmp_path,
                                      monkeypatch):
    """400 f64 steps of the small liquid-argon deck through both runners
    on the cell-block engine, on the pallas engine (whose f64 route it
    is) and on "gather": stat.dat, rdf.dat (to 10 A, two samples) and
    msd.dat rtol 1e-8."""
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    for r in _both_runners(argon_deck_d021, engine, out_t, out_j):
        r.run(400)
        r.finalize()
    for name in ("stat.dat", "rdf.dat", "msd.dat"):
        a, b = _table(os.path.join(out_t, name)), _table(
            os.path.join(out_j, name))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=1e-8, err_msg=name)
    assert _table(os.path.join(out_t, "stat.dat")).shape[0] == 2
    assert _table(os.path.join(out_t, "rdf.dat"))[:, 1].max() > 0.0


@pytest.mark.parametrize("engine,dtype", [("block", "f32"),
                                          ("pallas", "f32"),
                                          ("sparse", "f64"),
                                          ("gather", "f32")])
def test_cell_cap_regrow_matches_jax(argon_deck_d021, engine, dtype, tmp_path,
                                     capsys, monkeypatch):
    """A run started with a cell capacity of 2, below the fullest cell:
    at the first stat row both runners warn and rebuild with
    cap = round_up(occ + max(2, occ // 4), 4).  In f64 the sparse engine
    runs the cell-block engine, so its monitor is cell occupancy and the
    sparse regrow is skipped, as in JAX."""
    monkeypatch.setenv("AZTOTMD_NO_RING", "1")
    t, j = _both_runners(argon_deck_d021, engine, str(tmp_path / "torch"),
                         str(tmp_path / "jax"), dtype=dtype, grid_cap=2)
    t.run(200)
    err_t = capsys.readouterr().err
    j.run(200)
    err_j = capsys.readouterr().err
    occ = int(t.state.cell_overflow)
    assert occ == int(j.state.cell_overflow) > 2
    grown = -(-(occ + max(2, occ // 4)) // 4) * 4
    assert t.cfg.grid.cap == j.cfg.grid.cap == grown
    assert t.cfg.sparse_pair_cap == j.cfg.sparse_pair_cap
    msg = (f"WARNING: cell occupancy {occ} exceeded capacity 2; rebuilding "
           f"with cap={grown}")
    assert msg in err_t and msg in err_j
    assert "sparse tile-pair" not in err_t
    # the grown capacity holds: no second warning
    t.run(400)
    assert "WARNING" not in capsys.readouterr().err
    assert t.cfg.grid.cap == grown
