"""aztotmd_tpu_torch — the PyTorch/CUDA port of aztotmd_tpu for one NVIDIA
H100.

It mirrors the JAX package's layout (``core/``, ``ops/``, ``runtime/``,
``__main__.py``, ``systems.py``) and owns copies of the host layers it
needs (``io/``, ``units.py``, ``output/writers.py``, pure Python).  It
imports nothing of jax or of the JAX package.  The hand-written CUDA
kernels live in ``csrc/`` and are built with nvcc at first use.
"""

__version__ = "0.1.0"
