"""The cell ``lj_liquid_32k`` (configuration ``liquid_argon_lj``: the LJ
liquid of LAMMPS ``bench/in.lj`` as examples/liquid_argon states it, under
Nose-Hoover) and its two readers, on the CPU.

Cut by ``mdbench_tiny.tiny_root`` to 512 atoms (8^3 lattice sites), the
cell passes its own limits on the CPU and the bfloat16 control fails
them.  At its full size the configuration is the deck that the card runs
on the stacked cell-block kernel (K3) through ``"auto"``: the CPU keeps
the torch cell-block engine, which the guard refuses, and the card's
choice passes it.  ``cell_bin_ms`` and ``cellblock_roofline`` are found
by name, report only in this cell, and are null where the port's names
are gone or the window launched no K3.  The accepted entries of
``BENCHMARK.json`` stay first and unchanged; the new ones follow them.
"""

import dataclasses
import json
import os
import time
from types import SimpleNamespace

import pytest

from mdbench import decks, harness, registry

from .mdbench_tiny import tiny_root

CELL = "lj_liquid_32k"
CONFIG = "liquid_argon_lj"
READERS = ("cell_bin_ms", "cellblock_roofline")
ACCEPTED_CELLS = ("cs1_argon_1080k", "cs1_argon_40k", "cs2_surkov_4k")


def test_tiny_liquid_passes_and_its_control_fails(tmp_path):
    root = tiny_root(str(tmp_path / "root"))
    w = registry.workload(CELL, root)
    assert w["config"]["generator_params"]["n_atoms"] == 512
    res = harness.run_cell(CELL, 2 ** 31 + 11, 0.1, False, "cpu",
                           time.perf_counter(), root=root, controls=True)
    assert res["correct"], res["checks"]
    failed = {k for k, v in res["control"].items() if v > w["limits"][k]}
    assert {"start", "pos_A", "rdf"} <= failed, res["control"]


def test_full_size_deck_takes_k3_on_the_card_only(tmp_path):
    """The 32,768-atom deck loaded on the CPU is on the torch cell-block
    engine, which the guard refuses; the card's choice for the same
    configuration (``core/config.py::device_pair_engine``) is the stacked
    pass, which it passes."""
    import torch

    from aztotmd_tpu_torch.core.config import device_pair_engine
    from aztotmd_tpu_torch.runtime.setup import load_deck_dir
    w = registry.workload(CELL)
    assert w["config"]["generator_params"]["n_atoms"] == 32768
    d = str(tmp_path / "deck")
    decks.make_deck(w["config"], w["traffic"], 2 ** 31 + 3, d)
    cfg = load_deck_dir(d, seed=3, device="cpu")["cfg"]
    assert cfg.n_at == 32768 and cfg.pair_engine == "block"
    with pytest.raises(RuntimeError, match='selects the "block" engine'):
        harness.torch_engine_guard(cfg, torch.float32)
    card = dataclasses.replace(cfg, pair_engine=device_pair_engine(
        cfg, "cuda"))
    assert card.pair_engine == "pallas"
    harness.torch_engine_guard(card, torch.float32)


def test_every_cell_and_metric_of_the_tree_loads():
    cells = sorted(f[:-5] for f in os.listdir(os.path.join(
        registry.ROOT, "workloads")))
    assert cells == sorted(ACCEPTED_CELLS + (CELL,))
    for c in cells:
        w = registry.workload(c)
        assert set(w["limits"]) >= {"start", "pos_A", "vel", "force",
                                    "energy", "tstat", "rdf", "rows"}
    w = registry.workload(CELL)
    assert w["config"]["name"] == CONFIG and w["chips"] == 1
    assert w["config"]["reduced"] == [] and len(w["why"]) <= 200
    assert len(w["config"]["source"]) <= 200
    for name, mod in registry.metric_modules().items():
        assert set(mod.META) == {"unit", "better", "source", "layer",
                                 "moves", "workloads"}, name
        assert callable(mod.read)


def test_new_readers_report_only_in_the_liquid():
    got = registry.metrics_for(CELL)
    assert set(READERS) <= set(got)
    assert {"pair_roofline", "rdf_sample_ms", "bare_step_ms"} <= set(got)
    for cell in ACCEPTED_CELLS:
        assert not set(READERS) & set(registry.metrics_for(cell))
    for name in READERS:
        m = got[name].META
        assert m["layer"] == "pair kernels" and m["moves"] == "ns_per_day"
        assert m["source"] == "device_trace" and m["workloads"] == [CELL]


def _ctx(launches):
    rec = {"steps": 2000, "wall_s": 1.0, "spans": {},
           "counters": {"cellblock.launches": launches}}
    timer = SimpleNamespace(calls=[rec, dict(rec, steps=1000)])
    cfg = SimpleNamespace(grid=None, use_radii=False)
    return SimpleNamespace(runner=SimpleNamespace(timer=timer, cfg=cfg),
                           win_steps=2000)


def test_readers_are_null_without_k3_or_its_names(monkeypatch):
    from aztotmd_tpu_torch.ops import cellblock
    mods = registry.metric_modules()
    # a window that launched no K3
    assert mods["cellblock_roofline"].read(_ctx(0)) is None
    # no cell grid to bin into
    assert mods["cell_bin_ms"].read(_ctx(2000)) is None
    # the port's names gone
    for name in ("cell_table", "launch"):
        monkeypatch.delattr(cellblock, name)
    for reader in READERS:
        assert mods[reader].read(_ctx(2000)) is None


def test_benchmark_json_keeps_the_accepted_entries_first():
    """``BENCHMARK.json`` holds what ``mdbench.manifest`` assembles, with
    the accepted entries in their places and the new configuration, cell
    and readers after them (the manifest orders entries by file name)."""
    from mdbench.manifest import manifest
    with open(os.path.join(os.path.dirname(registry.ROOT),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    built = manifest()
    new = {"configs": [CONFIG], "workloads": [CELL],
           "per_layer": list(READERS)}
    for key, value in built.items():
        if key not in new:
            assert bench[key] == value, key
            continue
        names = [e["name"] for e in bench[key]]
        assert names[-len(new[key]):] == new[key], key
        by_name = {e["name"]: e for e in value}
        assert sorted(names) == sorted(by_name), key
        assert all(by_name[e["name"]] == e for e in bench[key]), key
