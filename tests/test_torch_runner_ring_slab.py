"""The slab mesh's stat ring (``parallel/slab.py::make_slab_ring``,
``_make_local_stat_row``) end to end against the JAX package's slab ring
on the conftest's CPU devices, f64, ``AZTOTMD_NO_RING`` unset in both:
the slab mesh over 2 and 4 ``LocalRing`` slabs (the Surkov cluster, the
LJ deck, reactive_polymer) writes the files of JAX's ``make_slab_ring``
(rows psum-reduced over the slabs), and a slab cell-capacity regrow is
read from the rows' monitor slots one window late, as JAX's.  The
helpers are ``tests/test_torch_runner_ring.py``'s."""

import dataclasses
import os

import pytest
import torch

from test_torch_runner_ring import (EX, _both, _compare_files, _deck, _edit,
                                    _lj, _warnings)
from aztotmd_tpu_torch import systems

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ring_env(monkeypatch):
    monkeypatch.delenv("AZTOTMD_NO_RING", raising=False)
    monkeypatch.delenv("AZTOTMD_RDF_ROWS", raising=False)
    monkeypatch.delenv("AZTOTMD_RING_STEPS", raising=False)


def _copy(name, *edits):
    """A writer of the example deck ``name`` with each (old, new) of
    ``edits`` replaced in its files."""
    def write(d):
        os.makedirs(d)
        for f in ("atoms.xyz", "field.txt", "control.txt"):
            with open(os.path.join(EX, name, f)) as g:
                text = g.read()
            for old, new in edits:
                text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as g:
                g.write(text)
    return write


def _surkov_slab(d):
    """The Surkov cluster in a 26 A box (a 27-point stencil over 2 slabs),
    a stat row every 20 steps."""
    systems.write_surkov_cluster_deck(d, n_atoms=240, box=26.0, steps=40,
                                      n_equil=20)
    _edit(d, "control.txt", "stat\t200", "stat\t20")


# slab deck -> (writer, slabs, steps)
SLAB = {
    "surkov_cluster/2": (_surkov_slab, 2, 40),
    "lj/4": (_lj, 4, 200),
    # a stat row and an RDF sample every 50 steps
    "reactive_polymer/2": (_copy("reactive_polymer", ("stat\t100", "stat\t50"),
                                 ("\t100\t0\t-nucl", "\t50\t0\t-nucl")),
                           2, 100),
}


@pytest.mark.parametrize("deck", list(SLAB))
def test_slab_ring_writes_jax_slab_ring_files(deck, tmp_path, capfd):
    """``run`` over ``LocalRing`` slabs takes the slab ring where JAX's
    does (``make_slab_ring``, its rows psum-reduced over the slabs):
    the same files and dispatches as JAX's slab ring."""
    writer, n_dev, n = SLAB[deck]
    d = _deck(tmp_path, writer)
    pr, jr, out_t, out_j = _both(d, tmp_path, {"mesh_devices": n_dev})
    assert pr.comm is not None and jr.mesh is not None
    assert hasattr(pr, "_ring_fn") and "row" in pr.multi.fns
    pr.run(n)
    jr.run(n)
    pr.finalize()
    jr.finalize()
    assert pr.n_dispatch == jr.n_dispatch
    if deck.startswith("reactive"):
        assert int(pr.state.rg.n_bond) > 0
    warn = _warnings(capfd.readouterr().err)
    assert warn[:len(warn) // 2] == warn[len(warn) // 2:]
    _compare_files(out_t, out_j)


def test_slab_health_read_from_the_rows_a_window_late(tmp_path, capfd,
                                                      monkeypatch):
    """The LJ deck over 4 slabs with the slab grid's cell capacity cut to
    1 and one stat period a window (``AZTOTMD_RING_STEPS``): the slab
    occupancy monitor rides the rows' over slots, so both runners warn
    after the second window is enqueued and regrow with the same
    capacity; the stat rows after the regrow agree, and the slot
    capacity is raised in neither."""
    monkeypatch.setenv("AZTOTMD_RING_STEPS", "100")
    d = _deck(tmp_path, _lj)
    pr, jr, out_t, out_j = _both(d, tmp_path, {"mesh_devices": 4})
    assert pr.s_cap == jr.s_cap == 1
    for r in (pr, jr):
        r.cfg = dataclasses.replace(
            r.cfg, grid=dataclasses.replace(r.cfg.grid, cap=1))
        r._build_programs()
    pr.run(200)
    jr.run(200)
    assert pr.n_dispatch == jr.n_dispatch == 2
    warn = _warnings(capfd.readouterr().err)
    assert len(warn) == 2 and warn[0] == warn[1], warn
    assert "slab cell occupancy" in warn[0] \
        and "exceeded capacity 1;" in warn[0]
    assert pr.cfg.grid.cap == jr.cfg.grid.cap > 1
    pr.finalize()
    jr.finalize()
    _compare_files(out_t, out_j)
