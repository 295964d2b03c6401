"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from mdbench import registry
from mdbench.run import FORBIDDEN

REPO = os.path.dirname(registry.ROOT)


def _sources():
    for dirpath, dirnames, files in os.walk(registry.ROOT):
        dirnames[:] = [d for d in dirnames if d not in ("tests",
                                                        "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_import_in_sources():
    found = {p: sorted(set(_top_imports(p)) & set(FORBIDDEN))
             for p in _sources()}
    assert not {p: v for p, v in found.items() if v}
    # the name test compares whole names: the port is allowed
    assert "aztotmd_tpu_torch" not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(registry.ROOT, "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            tops = set(_top_imports(os.path.join(ref, fn)))
            assert not tops & {"aztotmd_tpu_torch", *FORBIDDEN}, fn


def test_no_jax_module_after_a_cpu_run(tmp_path):
    """A whole tiny run on the CPU, then sys.modules in that process."""
    code = f"""
import sys, time
sys.path.insert(0, {REPO!r})
from mdbench.tests.mdbench_tiny import tiny_root
from mdbench import harness
from mdbench.run import forbidden_modules
root = tiny_root({str(tmp_path / "root")!r})
res = harness.run_cell("cs1_argon_40k", 5, 0.1, False, "cpu",
                       time.perf_counter(), root=root)
print("FORBIDDEN", forbidden_modules(), res["attempted"] > 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN [] True" in out.stdout, out.stdout[-2000:]
