"""The port's writers of the JAX system's tool decks
(``systems.write_scale_argon_deck``, ``write_dilute_argon_deck``,
``write_argon_nve_deck``) against the tools themselves
(``tools/make_bigdeck.py``, ``make_dilute_deck.py``, ``make_nve_deck.py``,
loaded by path and pointed at a small in-tree argon deck written into
``tmp_path``; the tools are not edited): every file equal byte for byte.
The writers default to ``examples/argon_gas`` (case study 1 at full
size); both packages configure its dilute deck alike, with the
outer-row-compacted refine."""

import dataclasses
import filecmp
import importlib.util
import os
import sys

import pytest

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.core.config import build_sim_config
from aztotmd_tpu_torch.io import (parse_atoms_file, parse_control_file,
                                  parse_field_file)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("atoms.xyz", "control.txt", "field.txt")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("argon_src"))
    systems.write_argon_gas_deck(d, n_atoms=500, steps=100)
    return d


def _same(a, b):
    for name in FILES:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("tiles,steps", [(2, 2000), (3, 500)])
def test_scale_deck_equals_make_bigdeck(src, tmp_path, monkeypatch, tiles,
                                        steps):
    tool = _tool("make_bigdeck")
    monkeypatch.setattr(tool, "CS1", src)
    monkeypatch.setattr(sys, "argv", [
        "make_bigdeck.py", "--tiles", str(tiles), "--steps", str(steps),
        "--out", str(tmp_path / "tool")])
    tool.main()
    n = systems.write_scale_argon_deck(str(tmp_path / "port"), tiles,
                                       steps=steps, src=src)
    assert n == 500 * tiles ** 3
    _same(str(tmp_path / "tool"), str(tmp_path / "port"))


@pytest.mark.parametrize("scale", [3.0, 2.5])
def test_dilute_deck_equals_make_dilute_deck(src, tmp_path, monkeypatch,
                                             scale):
    tool = _tool("make_dilute_deck")
    monkeypatch.setattr(tool, "CS1", src)
    monkeypatch.setattr(sys, "argv", [
        "make_dilute_deck.py", "--scale", str(scale), "--out",
        str(tmp_path / "tool")])
    tool.main()
    systems.write_dilute_argon_deck(str(tmp_path / "port"), scale=scale,
                                    src=src)
    _same(str(tmp_path / "tool"), str(tmp_path / "port"))


def test_nve_deck_equals_make_nve_deck(src, tmp_path, monkeypatch):
    tool = _tool("make_nve_deck")
    monkeypatch.setattr(tool, "SRC", src)
    tool.main(str(tmp_path / "tool"))
    systems.write_argon_nve_deck(str(tmp_path / "port"), src=src)
    _same(str(tmp_path / "tool"), str(tmp_path / "port"))


def _configs(deck):
    fld = parse_field_file(os.path.join(deck, "field.txt"))
    ctl = parse_control_file(os.path.join(deck, "control.txt"),
                             charged_spec=fld.charged_spec)
    atoms = parse_atoms_file(os.path.join(deck, "atoms.xyz"))
    args = (ctl, fld, atoms.box, atoms.n_atoms)
    return (build_sim_config(*args, pos=atoms.pos),
            j_build_sim_config(*args, pos=atoms.pos), ctl)


def test_default_decks_from_examples_argon_gas(tmp_path):
    """From examples/argon_gas: the NVE deck is its atoms at 40,000 with
    the thermostat off and Gaussian velocities; the dilute deck (1.0e-6
    atoms/A^3) takes the two-level list with the row-compacted walk and
    an outer-row capacity of 19,072 in both packages."""
    assert systems.ARGON_GAS == os.path.join(ROOT, "examples", "argon_gas")
    nve, dil = str(tmp_path / "nve"), str(tmp_path / "dilute")
    systems.write_argon_nve_deck(nve)
    assert filecmp.cmp(os.path.join(nve, "atoms.xyz"),
                       os.path.join(systems.ARGON_GAS, "atoms.xyz"),
                       shallow=False)
    cfg, jcfg, ctl = _configs(nve)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_at, cfg.tstat_type, ctl.n_step) == (40000, 0, 100000)
    systems.write_dilute_argon_deck(dil)
    cfg, jcfg, _ = _configs(dil)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_at == 40000 and abs(40000 / cfg.box[0] ** 3 - 1.0e-6) \
        < 1e-8
    assert (cfg.pair_engine, cfg.nb_outer, cfg.nb_orowcap) == (
        "neighbor", 24, 19072)
    assert 0 < cfg.nb_rowcap <= cfg.nb_orowcap


def test_scale_deck_rdf_takes_the_cell_path(src, tmp_path):
    """The 3^3 tiling's shape (1,080,000 atoms in a 3,424.2 A box, the
    RDF to 14 A): both packages cap the RDF grid at 2^20 cells, alike,
    and an atom's candidates stay far below N, so the sample takes the
    cell path and not 1.2e12 all pairs."""
    from aztotmd_tpu.ops.rdf import make_rdf_config as j_make_rdf_config
    from aztotmd_tpu_torch.ops.rdf import make_rdf_config
    deck = str(tmp_path / "x3")
    systems.write_scale_argon_deck(deck, 3, src=src)
    cfg, jcfg, ctl = _configs(deck)
    box0 = 1141.394837 * 3
    big = dict(box=(box0, box0, box0), n_at=1080000)
    rc = make_rdf_config(ctl, dataclasses.replace(cfg, **big))
    jrc = j_make_rdf_config(ctl, dataclasses.replace(jcfg, **big))
    assert dataclasses.asdict(rc) == dataclasses.asdict(jrc)
    g = rc.grid
    assert g.n_cell <= 1 << 20 and g.dims == (101, 101, 101)
    assert len(g.stencil) * g.cap < big["n_at"]
