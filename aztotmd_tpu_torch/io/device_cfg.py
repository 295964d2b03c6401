"""cuda.txt parser → device/runtime tuning config.

The reference reads GPU launch geometry and statistics buffer depths from a
``cuda.txt`` deck (reference: src/cuInit.cu:684-754 ``read_cuda``).  The TPU
engine accepts the same file unchanged: buffer depths map to host-flush
periods of the on-device ring buffers; the thread-count directives have no
TPU meaning and are kept only for deck compatibility (XLA owns scheduling).
An optional ``tpu.txt`` with the same directives takes precedence so users
can tune the TPU build without touching reference decks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .cscan import CScan


@dataclass
class DeviceConfig:
    nstep_stat: int = 10        # stat ring-buffer depth (samples per flush)
    nstep_traj: int = 10
    nstep_bindtraj: int = 40
    nstep_msdstat: int = 10
    nstep_bondstat: int = 10
    nstep_jmpstat: int = 10     # hard-coded to 10 in the reference
    bindtraj_per_thread: int = 1
    n_bindtraj_thread: int = 32
    pair_thread_a: int = 16     # kept for compatibility; unused on TPU
    pair_thread_b: int = 32


def parse_device_cfg(text: str) -> DeviceConfig:
    sc = CScan(text)
    c = DeviceConfig()
    c.nstep_stat = sc.find_int(" nstep stat %d", 10)
    c.nstep_traj = sc.find_int(" nstep traj %d", 10)
    c.nstep_bindtraj = sc.find_int(" nstep bindtraj %d", 40)
    bt = sc.find_int(" bindtraj threads %d")
    if bt is not None:
        c.bindtraj_per_thread = bt
        v = sc.scanf("%d")
        if v:
            c.n_bindtraj_thread = v[0]
    c.nstep_msdstat = sc.find_int(" nstep msdstat %d", 10)
    c.nstep_bondstat = sc.find_int(" nstep bondstat %d", 10)
    c.pair_thread_a = sc.find_int(" nthread a %d", 16)
    c.pair_thread_b = sc.find_int(" nthread b %d", 32)
    return c


def parse_device_cfg_dir(dirname) -> DeviceConfig:
    """Load tpu.txt if present, else cuda.txt, else defaults."""
    for name in ("tpu.txt", "cuda.txt"):
        path = os.path.join(dirname, name)
        if os.path.exists(path):
            with open(path, "r", errors="replace") as f:
                return parse_device_cfg(f.read())
    return DeviceConfig()
