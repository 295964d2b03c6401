"""The native row formatter: ctypes bindings to ``csrc/aztocore.cpp``
(the port's copy of the JAX package's ``csrc/aztocore.cpp``, held equal
to it by the tests).

At first use the source is compiled with ``g++ -O3 -shared -fPIC`` into
``csrc/build/`` (listed in ``.gitignore``), into a library whose file name
carries a hash of the source, so an edited source is rebuilt and a stale
library is never loaded.  A failed build raises with the compiler's
output: the writers that use this module (``traj.dat``, ``revcon.xyz``)
have no Python branch, which would write other bytes (``traj.dat``'s
positions are formatted from float32 here).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(CSRC, "aztocore.cpp")
BUILD_DIR = os.path.join(CSRC, "build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def library_path() -> str:
    """Path of the built library for the current source (may not
    exist)."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"aztocore-{h}.so")


def build() -> str:
    """Compile ``csrc/aztocore.cpp`` unless its library exists; returns
    the library's path.  Raises with the compiler's output on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native row formatter needs g++ "
                           f"({' '.join(cmd)}): {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    """The library, built and bound at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.azto_open.restype = ctypes.c_void_p
    lib.azto_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.azto_write_str.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.azto_write_row_f.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int]
    lib.azto_write_traj_row.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.azto_write_xyz_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.azto_close.argtypes = [ctypes.c_void_p]
    lib.azto_parse_xyz_rows.restype = ctypes.c_int64
    lib.azto_parse_xyz_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


class NativeRowFile:
    """Buffered tab-separated row writer backed by aztocore."""

    def __init__(self, path: str, mode: str = "w"):
        self._lib = _load()
        self._h = self._lib.azto_open(path.encode(), mode.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write_str(self, s: str):
        self._lib.azto_write_str(self._h, s.encode())

    def write_row(self, time: float, step: int, vals, newline_first=False):
        v = np.ascontiguousarray(vals, dtype=np.float64)
        self._lib.azto_write_row_f(
            self._h, time, step,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), v.size,
            1 if newline_first else 0)

    def write_traj_row(self, time: float, step: int, pos, types, ptypes):
        p = np.ascontiguousarray(pos, dtype=np.float32)
        t = np.ascontiguousarray(types, dtype=np.int32)
        pt = np.ascontiguousarray(ptypes, dtype=np.int32)
        self._lib.azto_write_traj_row(
            self._h, time, step,
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(t))

    def write_xyz_rows(self, names, pos):
        n = len(names)
        packed = np.zeros((n, 8), dtype="S1")
        for i, nm in enumerate(names):
            b = nm.encode()[:7]
            packed[i, :len(b)] = np.frombuffer(b, dtype="S1")
        p = np.ascontiguousarray(pos, dtype=np.float64)
        self._lib.azto_write_xyz_rows(
            self._h, packed.tobytes(),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)

    def close(self):
        if self._h:
            self._lib.azto_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parse_xyz_rows(text: str, n: int):
    """Parse n 'name x y z [...]' lines; returns (names list, pos (n,3))."""
    lib = _load()
    raw = text.encode()
    names8 = ctypes.create_string_buffer(8 * n)
    pos = np.empty((n, 3), np.float64)
    got = lib.azto_parse_xyz_rows(
        raw, len(raw), n, names8,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if got != n:
        raise ValueError(f"parsed {got} of {n} atom lines")
    nb = names8.raw
    names = [nb[i * 8:(i + 1) * 8].split(b"\0", 1)[0].decode()
             for i in range(n)]
    return names, pos
