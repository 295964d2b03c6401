"""A configuration, traffic mix, cell or per-layer metric dropped into a
copy of the tree is found by its name, with no file edited."""

import json
import os
import shutil

from mdbench import registry


def test_new_entries_are_found_by_name(tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(root, "configs", "argon_gas_cs1.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "argon_gas_other"
    with open(os.path.join(root, "configs", "argon_gas_other.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "tiled_2.json"), "w") as f:
        json.dump({"deck": "scale", "tiles": 2}, f)
    with open(os.path.join(root, "workloads", "new_cell.json"), "w") as f:
        json.dump({"config": "argon_gas_other", "traffic": "tiled_2",
                   "chips": 1, "why": "a test", "limits": {}}, f)
    with open(os.path.join(root, "metrics", "new_metric.py"), "w") as f:
        f.write('META = {"unit": "s", "better": "lower", "source": '
                '"host_clock", "layer": "setup", "moves": "setup_s", '
                '"workloads": ["new_cell"]}\n\n\ndef read(ctx):\n'
                '    return 1.0\n')
    w = registry.workload("new_cell", root)
    assert w["config"]["name"] == "argon_gas_other"
    assert w["traffic"]["tiles"] == 2 and w["traffic"]["name"] == "tiled_2"
    names = registry.metrics_for("new_cell", root)
    assert "new_metric" in names and "load_s" in names
    assert "nbr_lists_per_kstep" not in names
    assert "new_metric" not in registry.metrics_for("cs2_surkov_4k", root)


def test_every_cell_and_metric_of_the_tree_loads():
    cells = [f[:-5] for f in os.listdir(os.path.join(registry.ROOT,
                                                     "workloads"))]
    assert sorted(cells) == ["cs1_argon_1080k", "cs1_argon_40k",
                             "cs2_surkov_4k"]
    for c in cells:
        w = registry.workload(c)
        assert set(w["limits"]) >= {"start", "pos_A", "vel", "force",
                                    "energy", "tstat", "rdf", "rows"}
    for name, mod in registry.metric_modules().items():
        assert set(mod.META) == {"unit", "better", "source", "layer",
                                 "moves", "workloads"}, name
        assert callable(mod.read)


def test_benchmark_json_is_the_assembled_manifest():
    from mdbench.manifest import manifest
    with open(os.path.join(os.path.dirname(registry.ROOT),
                           "BENCHMARK.json")) as f:
        assert json.load(f) == manifest()
