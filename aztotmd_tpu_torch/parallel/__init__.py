"""Multi-slab execution (port of the slab mode of
``aztotmd_tpu/parallel/``): the slab-decomposed step in ``slab.py`` with
its constant-topology records and, for reactive decks, the replicated
topology of ``slab_react.py``, and its communicator in ``comm.py``.  The
atom-sharded mode (``mesh.py``), ``domain.py`` and the mesh stat ring are
not ported yet (ROADMAP.md)."""

from .comm import DistRing, LocalRing, init_dist, make_comm

__all__ = ["DistRing", "LocalRing", "init_dist", "make_comm"]
