"""The port's stat ring end to end against the JAX package's runner with
its on-device stat ring (``AZTOTMD_NO_RING`` unset in both), f64 on the
CPU.

The ring computes one float32 and one int32 row a stat period on the
device (``runtime/statring.py``), moves a window's rows to the host in one
copy and decodes window k after window k+1 is enqueued, so its monitors,
and any regrow, come one window late, as JAX's do.

- Default runs of the cut decks (a 240-atom Surkov cluster, the cut
  reactive_polymer and ejump_redox, a 3,000-atom argon gas on the Verlet
  list): stat.dat and msd_d.dat byte for byte; msd.dat, stat_bnd.dat,
  jumps.dat, rdf.dat and rdf_n.dat byte for byte, or every differing
  value within one float32 ulp of JAX's (counted, printed with ``-s``);
  the same number of dispatches.
- The regrow lag: the covers-outer gas with ``k_cap`` forced to 16, one
  ``run(600)`` (one window of 3 periods): JAX's warning (the window's
  largest count) and its rdf.dat and rdf_n.dat (the whole window sampled
  from the truncated lists).
- A neighbor-capacity regrow through the ring (K, the occupied rows, K2
  and the list grid's cell capacity on the LJ deck) with JAX's warnings,
  capacities and files.
- The atom-sharded mode over 4 against JAX's one-device ring.

The slab mesh's ring is in ``tests/test_torch_runner_ring_slab.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from aztotmd_tpu.runtime.runner import MDRunner as JRunner
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.runtime.runner import MDRunner
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")
FILES = ("stat.dat", "msd.dat", "msd_d.dat", "stat_bnd.dat", "jumps.dat",
         "rdf.dat", "rdf_n.dat")


@pytest.fixture(autouse=True)
def _ring_env(monkeypatch):
    monkeypatch.delenv("AZTOTMD_NO_RING", raising=False)
    monkeypatch.delenv("AZTOTMD_RDF_ROWS", raising=False)
    monkeypatch.delenv("AZTOTMD_RING_STEPS", raising=False)


def _surkov(d):
    systems.write_surkov_cluster_deck(d, n_atoms=240, box=18.0, density=0.15,
                                      steps=400, n_equil=100)


def _lj(d):
    os.makedirs(d)
    systems.write_lj_deck(d)


def _edit(d, name, old, new):
    path = os.path.join(d, name)
    with open(path) as f:
        text = f.read()
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, new))


# deck -> (writer, steps)
DECKS = {
    "surkov_cluster": (_surkov, 400),
    "reactive_polymer": (lambda d: systems.write_reactive_polymer_deck(
        d, n_side=6, steps=100), 200),
    "ejump_redox": (lambda d: systems.write_ejump_redox_deck(
        d, n_side=6, n_fe2=48, n_fe3=32, n_o=96, steps=100), 200),
    "argon_3000": (lambda d: systems.write_argon_gas_deck(
        d, n_atoms=3000, steps=400), 400),
}


def _table(text):
    rows = []
    for line in text.splitlines():
        try:
            rows.append([float(v) for v in line.split()])
        except ValueError:
            continue
    return np.asarray(rows)


def _compare_files(out_t, out_j, names=FILES, exact=()):
    """Each file that JAX wrote equals the port's byte for byte, or (files
    not in ``exact``) each value that differs is within one float32 ulp of
    JAX's (plus the last printed digit); returns the number of differing
    values."""
    n_diff = 0
    seen = 0
    for name in names:
        pj = os.path.join(out_j, name)
        if not os.path.exists(pj):
            assert not os.path.exists(os.path.join(out_t, name)), name
            continue
        seen += 1
        with open(os.path.join(out_t, name)) as f, open(pj) as g:
            a, b = f.read(), g.read()
        if a == b:
            continue
        assert name not in exact, name
        ta, tb = _table(a), _table(b)
        assert ta.shape == tb.shape and ta.size, name
        diff = ta != tb
        ulp = np.spacing(np.abs(tb).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(ta - tb)[diff] <= (ulp + 1.5e-6)[diff]), name
        n_diff += int(diff.sum())
        print(f"{name}: {int(diff.sum())} values 1 ulp apart")
    assert seen >= 3
    return n_diff


def _deck(tmp_path, writer):
    d = str(tmp_path / "deck")
    writer(d)
    return d


def _both(deck, tmp_path, run_kw=None, j_kw=None, **load_kw):
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    pr = MDRunner(load_deck_dir(deck, dtype="f64", device="cpu", **load_kw),
                  out_t, quiet=True, **(run_kw or {}))
    jr = JRunner(j_load_deck_dir(deck, dtype="f64", **load_kw), out_j,
                 quiet=True, **(j_kw if j_kw is not None else run_kw or {}))
    assert pr.ring_ok and jr.ring_ok
    return pr, jr, out_t, out_j


def _warnings(text):
    return [ln for ln in text.splitlines() if ln.startswith("WARNING")]


@pytest.mark.parametrize("deck", list(DECKS))
def test_default_run_writes_jax_ring_files(deck, tmp_path, capfd):
    """The default run of each deck against JAX's: the stat, MSD, bond,
    jump and RDF files (stat.dat and msd_d.dat, the float32 rows, byte
    for byte), the dispatch count and every warning."""
    writer, n = DECKS[deck]
    d = _deck(tmp_path, writer)
    pr, jr, out_t, out_j = _both(d, tmp_path)
    pr.run(n)
    jr.run(n)
    pr.finalize()
    jr.finalize()
    warn = _warnings(capfd.readouterr().err)
    assert warn[:len(warn) // 2] == warn[len(warn) // 2:]
    _compare_files(out_t, out_j, exact=("stat.dat", "msd_d.dat"))
    assert pr.n_dispatch == jr.n_dispatch >= 1
    assert pr._host_rows.fetches == pr.n_dispatch


def test_k_cap_regrow_lags_one_window_as_jax(tmp_path, capfd):
    """The covers-outer gas with ``k_cap`` forced to 16 in both runners,
    one ``run(600)``: JAX makes it one window of 3 periods, samples the
    RDF from the truncated lists for the whole window and warns with the
    window's largest count; the port does the same."""
    d = str(tmp_path / "deck")
    systems.write_argon_gas_deck(d, n_atoms=2000, density=1e-3, steps=1000)
    pr, jr, out_t, out_j = _both(d, tmp_path)
    assert pr._ring_plan == jr._ring_plan and jr._ring_plan[
        "rdf_covers_outer"]
    for r in (pr, jr):
        r.rcfg = dataclasses.replace(r.rcfg, k_cap=16)
        r._build_programs()
    pr.run(600)
    jr.run(600)
    warn = _warnings(capfd.readouterr().err)
    assert len(warn) == 2 and warn[0] == warn[1], warn
    assert warn[0].startswith("WARNING: RDF-list neighbor count ") \
        and "exceeded capacity 16; rebuilding with k_cap=" in warn[0]
    assert pr.rcfg.k_cap == jr.rcfg.k_cap
    pr.finalize()
    jr.finalize()
    for name in ("rdf.dat", "rdf_n.dat"):
        with open(os.path.join(out_t, name)) as f, \
                open(os.path.join(out_j, name)) as g:
            assert f.read() == g.read(), name
    _compare_files(out_t, out_j)
    assert pr.n_dispatch == jr.n_dispatch == 1


def test_neighbor_capacity_regrow_through_the_ring(tmp_path, capfd):
    """The LJ deck on the Verlet list with K, the occupied rows, K2 and
    the list grid's cell capacity below what it needs, in both runners'
    rings: the same warnings and capacities, read from the rows one
    window late, and the same files."""
    d = _deck(tmp_path, _lj)
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    j = j_load_deck_dir(d, dtype="f64")
    p = load_deck_dir(d, dtype="f64", device="cpu")
    c = p["cfg"]
    assert c.pair_engine == "neighbor" and c.nb_outer > 1
    kw = dict(n_neigh=4, n_neigh2=24, nb_rowcap=64,
              nb_grid=dataclasses.replace(c.nb_grid, cap=8))
    c = j["cfg"] = p["cfg"] = dataclasses.replace(c, **kw)
    N = c.n_at
    lists = dict(nbr_idx=np.full((N, c.n_neigh), N, np.int32),
                 nbr2_idx=np.full((N, c.n_neigh2), N, np.int32),
                 nbrow_idx=np.full((c.nb_rowcap, 1 + c.n_neigh), N,
                                   np.int32))
    import jax.numpy as jnp
    j["state"] = j["state"].replace(
        **{k: jnp.asarray(v) for k, v in lists.items()})
    p["state"] = p["state"].replace(
        **{k: torch.as_tensor(v) for k, v in lists.items()})
    pr = MDRunner(p, out_t, quiet=True)
    jr = JRunner(j, out_j, quiet=True)
    assert pr.ring_ok and jr.ring_ok
    for n in (200, 400):
        pr.run(n)
        jr.run(n)
    warn = _warnings(capfd.readouterr().err)
    half = len(warn) // 2
    assert half >= 4 and warn[:half] == warn[half:], warn
    for text in ("WARNING: neighbor count", "occupied-row count",
                 "outer neighbor count", "cell occupancy"):
        assert any(text in w for w in warn[:half]), text
    assert dataclasses.asdict(pr.cfg) == dataclasses.asdict(jr.cfg)
    assert pr.n_dispatch == jr.n_dispatch
    pr.finalize()
    jr.finalize()
    _compare_files(out_t, out_j)


def test_atoms_mesh_ring_writes_jax_ring_files(tmp_path):
    """``--mesh 4 --mesh-mode atoms`` on the Surkov cluster: the stat row
    of each period is computed over the gathered rows inside the
    period's programs, and the files are JAX's one-device ring's."""
    d = _deck(tmp_path, _surkov)
    pr, jr, out_t, out_j = _both(d, tmp_path, {"mesh_devices": 4,
                                               "mesh_mode": "atoms"}, {})
    assert pr._atoms_mesh is not None and pr._atoms_mesh.n_dev == 4
    pr.run(400)
    jr.run(400)
    pr.finalize()
    jr.finalize()
    assert pr.n_dispatch == jr.n_dispatch
    _compare_files(out_t, out_j)
