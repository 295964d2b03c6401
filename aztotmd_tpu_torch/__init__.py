"""aztotmd_tpu_torch — the PyTorch/CUDA port of aztotmd_tpu for one NVIDIA
H100.

It mirrors the JAX package's layout (``core/``, ``ops/``, ``runtime/``,
``__main__.py``, ``systems.py``) and owns copies of the host layers it
needs (``io/``, ``units.py``, ``output/writers.py``) and of the native
row formatter (``native.py`` over ``csrc/aztocore.cpp``, built with g++
at first use).  It imports nothing of jax or of the JAX package.  The
hand-written CUDA kernels live in ``csrc/`` and are built with nvcc at
first use.

``load(deck_dir)`` and ``run(deck_dir, out_dir)`` are the package API, as
the JAX package's; both run on the card unless ``device="cpu"``.
``entry.py`` holds the entry points ``entry()`` and
``dryrun_multichip(n)``.
"""

__version__ = "0.1.0"


def load(deck_dir, device=None, **kw):
    """Load a reference deck directory on ``device`` (the card when None;
    ``device="cpu"`` for the CPU): the system dict (cfg/ff/state/aux/ctl/
    fld/...) of ``runtime.setup.load_deck_dir``, whose keywords ``kw``
    takes."""
    from .runtime.setup import default_device, load_deck_dir
    return load_deck_dir(deck_dir, device=default_device(device), **kw)


def run(deck_dir, out_dir=".", device=None, **kw):
    """Load and run a deck to completion on ``device`` (the card when
    None): ``runtime.runner.run_deck``, whose keywords ``kw`` takes."""
    from .runtime.runner import run_deck
    return run_deck(deck_dir, out_dir=out_dir, device=device, **kw)
