"""Utilities: profiling and tracing helpers (port of
``aztotmd_tpu/utils``)."""

from .profiling import StageTimer, trace

__all__ = ["StageTimer", "trace"]
