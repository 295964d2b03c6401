"""Find the benchmark's entries by name: a cell in ``workloads/<name>.json``,
its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` and every per-layer metric in
``metrics/<metric>.py``.  A later change adds an entry as a new file;
nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def _load_json(root, kind, name):
    path = os.path.join(root, kind, name + ".json")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name, root=ROOT):
    """The cell ``name`` with its configuration and traffic mix:
    {"name", "config": {...}, "traffic": {...}, "chips", "why",
    "limits"}."""
    w = _load_json(root, "workloads", name)
    w["name"] = name
    w["config"] = _load_json(root, "configs", w["config"])
    w["traffic"] = dict(_load_json(root, "traffic", w["traffic"]),
                        name=w["traffic"])
    return w


def metric_modules(root=ROOT):
    """{name: module} of every per-layer metric reader in ``metrics/``."""
    out = {}
    mdir = os.path.join(root, "metrics")
    for fn in sorted(os.listdir(mdir)):
        if not fn.endswith(".py") or fn.startswith("_"):
            continue
        name = fn[:-3]
        spec = importlib.util.spec_from_file_location(
            f"mdbench_metric_{name}", os.path.join(mdir, fn))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def metrics_for(cell, root=ROOT):
    """{name: module} of the per-layer metrics that report in ``cell``:
    those whose ``META["workloads"]`` lists it, or that list none."""
    return {n: m for n, m in metric_modules(root).items()
            if m.META.get("workloads") in (None, []) or
            cell in m.META["workloads"]}
