"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``csrc/build/`` (listed in
``.gitignore``) and loaded with ``ctypes``.  The library's file name
carries a hash of the source and of the ``csrc/`` headers it includes,
so an edited source or header is rebuilt and a stale library is never
loaded.  The compiler's output, including the
``-Xptxas -v`` register and shared-memory report, is kept beside the
library in a ``.log`` file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes with
    ``#include "..."``, transitively, in first-seen order."""
    todo, seen = [name + ".cu"], []
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (may not exist).
    The hash covers the source and every local header it includes."""
    h = hashlib.sha256()
    for rel in _sources(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless the library for this source
    exists; returns (library path, seconds spent compiling)."""
    so = library_path(name)
    if os.path.exists(so):
        return so, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    with open(so[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, so)
    return so, secs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        so, _ = build(name)
        lib = ctypes.CDLL(so)
        _loaded[name] = lib
    return lib
