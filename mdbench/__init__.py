"""The benchmark of the PyTorch and CUDA port (``aztotmd_tpu_torch``).

One command runs one cell once::

    python -m mdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are files of
their own under this directory, found by name (``registry.py``).
Nothing here imports JAX or the JAX package.
"""
