"""Assemble ``BENCHMARK.json`` from the benchmark's own files: the command,
paths, window length and end-to-end metrics of ``head.json``, every
configuration in ``configs/``, every cell in ``workloads/`` and every
per-layer reader in ``metrics/``:

    python3 -m mdbench.manifest > BENCHMARK.json
"""

from __future__ import annotations

import json
import os

from . import registry


def manifest(root=registry.ROOT) -> dict:
    with open(os.path.join(root, "head.json")) as f:
        head = json.load(f)
    base = os.path.basename(root)
    configs = []
    for fn in sorted(os.listdir(os.path.join(root, "configs"))):
        with open(os.path.join(root, "configs", fn)) as f:
            c = json.load(f)
        configs.append({"name": c["name"], "source": c["source"],
                        "file": f"{base}/configs/{fn}",
                        "reduced": c["reduced"], "why": c["why"]})
    cells = []
    for fn in sorted(os.listdir(os.path.join(root, "workloads"))):
        with open(os.path.join(root, "workloads", fn)) as f:
            w = json.load(f)
        cells.append({"name": fn[:-5], "config": w["config"],
                      "traffic": w["traffic"], "chips": w["chips"],
                      "why": w["why"]})
    layer = []
    for name, mod in registry.metric_modules(root).items():
        m = mod.META
        e = {"name": name, "unit": m["unit"], "better": m["better"],
             "source": m["source"], "layer": m["layer"], "moves": m["moves"]}
        if m.get("workloads"):
            e["workloads"] = list(m["workloads"])
        layer.append(e)
    return {"command": head["command"], "paths": head["paths"],
            "run_seconds": head["run_seconds"], "configs": configs,
            "workloads": cells, "end_to_end": head["end_to_end"],
            "per_layer": layer}


if __name__ == "__main__":
    print(json.dumps(manifest(), indent=1))
