"""The port's host layers against the JAX package: static config, engine
routing, force-field tables, initial state and counter-based PRNG words."""

import dataclasses
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztotmd_tpu.core.config import build_sim_config as j_build_sim_config
from aztotmd_tpu.core.ffield import build_forcefield as j_build_forcefield
from aztotmd_tpu.io import (parse_atoms_file, parse_control_file,
                            parse_field, parse_field_file)
from aztotmd_tpu.ops import prng as j_prng
from aztotmd_tpu.ops.pallas_pair import allpairs_cost as j_allpairs_cost
from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu.systems import write_lj_deck as j_write_lj_deck
from aztotmd_tpu_torch import convert
from aztotmd_tpu_torch import systems
from aztotmd_tpu_torch.core.config import build_sim_config
from aztotmd_tpu_torch.core.ffield import build_forcefield
from aztotmd_tpu_torch.ops import prng
from aztotmd_tpu_torch.ops.allpairs import allpairs_cost, block_cost
from aztotmd_tpu_torch.runtime.setup import load_deck_dir

# The tier-1 run puts several pytest workers on the machine's cores; one
# intra-op thread per worker keeps torch from oversubscribing them (these
# systems are a few hundred atoms).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_DECK = os.path.join(ROOT, "examples", "surkov_cluster")
EXAMPLES = ["bonded_fluid", "ejump_redox", "liquid_argon", "molten_salt",
            "nanoclusters", "reactive_polymer"]


def _specs(deck):
    fld = parse_field_file(os.path.join(deck, "field.txt"))
    ctl = parse_control_file(os.path.join(deck, "control.txt"),
                             charged_spec=fld.charged_spec)
    atoms = parse_atoms_file(os.path.join(deck, "atoms.xyz"))
    return ctl, fld, atoms


@pytest.fixture(scope="module")
def lj_deck(tmp_path_factory):
    d = tmp_path_factory.mktemp("lj")
    j_write_lj_deck(str(d))
    return str(d)


@pytest.mark.parametrize("which", ["slice", "lj"])
def test_sim_config_equals_jax(which, lj_deck):
    deck = SLICE_DECK if which == "slice" else lj_deck
    jcfg = j_load_deck_dir(deck, dtype="f32")["cfg"]
    cfg = load_deck_dir(deck, dtype="f32")["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("name", EXAMPLES)
def test_engine_choice_agrees_on_examples(name):
    ctl, fld, atoms = _specs(os.path.join(ROOT, "examples", name))
    args = (ctl, fld, atoms.box, atoms.n_atoms)
    jcfg = j_build_sim_config(*args, pos=atoms.pos)
    cfg = build_sim_config(*args, pos=atoms.pos)
    assert cfg.pair_engine == jcfg.pair_engine
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_slice_deck_routes_to_dense_kernel_branch():
    """The in-tree slice deck takes JAX's auto-selection to the pallas
    engine, whose dispatcher then picks the dense all-pairs kernel."""
    cfg = j_load_deck_dir(SLICE_DECK, dtype="f32")["cfg"]
    assert cfg.n_at == 4000
    assert cfg.pair_engine == "pallas"
    g = cfg.grid
    assert j_allpairs_cost(cfg) < len(g.stencil) * g.cap * g.cap * g.n_cell
    pcfg = load_deck_dir(SLICE_DECK, dtype="f32")["cfg"]
    assert allpairs_cost(pcfg) < block_cost(pcfg)


def test_slice_deck_writer_reproduces_committed_files(tmp_path):
    systems.write_surkov_cluster_deck(str(tmp_path))
    for name in ("atoms.xyz", "control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / name),
                           os.path.join(SLICE_DECK, name), shallow=False)


def test_nanoclusters_deck_routes_to_sparse_engine(tmp_path):
    """examples/nanoclusters: written byte for byte by the port's writer,
    and auto-selected to the block-sparse engine (the K4 path) with tile
    256 and a capacity of 1,536 tile pairs, 871 needed at the start."""
    from aztotmd_tpu_torch.core.config import estimate_sparse_pairs
    deck = os.path.join(ROOT, "examples", "nanoclusters")
    systems.write_nanoclusters_deck(str(tmp_path))
    for name in ("atoms.xyz", "control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / name), os.path.join(deck, name),
                           shallow=False)
    ctl, fld, atoms = _specs(deck)
    cfg = build_sim_config(ctl, fld, atoms.box, atoms.n_atoms, pos=atoms.pos)
    assert (cfg.n_at, cfg.pair_engine) == (12000, "sparse")
    assert (cfg.sparse_tile, cfg.sparse_pair_cap) == (256, 1536)
    assert estimate_sparse_pairs(cfg.box, cfg.r_max, atoms.pos, 256) == 871


def test_lj_deck_writer_matches_jax(tmp_path, lj_deck):
    systems.write_lj_deck(str(tmp_path))
    for name in ("atoms.xyz", "control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / name), os.path.join(lj_deck, name),
                           shallow=False)


_FIELD3 = """
spec 3
A\tA\t39.9\t1.0\t0.0
B\tB\t20.0\t-1.0\t0.5
C\tC\t12.0\t0.5\t0.0
red-ox 1
2 A B
vdw 3
A\tB\tlnjs\t4.0\t0.01\t2.5
A\tA\tbuck\t5.0\t1200.0\t0.31\t27.88
B\tC\tsurk\t5.0\t75.0\t8.0\t1.0\t1.0
radii 3
A\t2.885\t5.0\t1.0
B\t1.0\t2.0\t0.5
C\t0.5\t1.0\t0.2
"""


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_forcefield_tables_equal(dtype):
    fld = parse_field(_FIELD3)
    npdt = np.float64 if dtype == "f64" else np.float32
    jff = j_build_forcefield(fld, 0.001, eps=2.0, dtype=npdt)
    ff = build_forcefield(fld, 0.001, eps=2.0,
                          dtype=torch.float64 if dtype == "f64"
                          else torch.float32)
    got = convert.forcefield_to_numpy(ff)
    for name, arr in got.items():
        ref = np.asarray(getattr(jff, name))
        assert arr.dtype == ref.dtype, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)
    back = convert.forcefield_from_numpy(jff)
    for name, arr in convert.forcefield_to_numpy(back).items():
        np.testing.assert_array_equal(arr, got[name], err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_init_state_bitwise_equal(dtype):
    j = j_load_deck_dir(SLICE_DECK, dtype=dtype, seed=77)
    p = load_deck_dir(SLICE_DECK, dtype=dtype, seed=77)
    got = convert.state_to_numpy(p["state"])
    ref = convert.state_to_numpy(convert.state_from_numpy(j["state"]))
    for name, arr in got.items():
        if name == "energies":
            continue
        r = np.asarray(getattr(j["state"], name))
        assert arr.dtype == r.dtype, name
        np.testing.assert_array_equal(arr, r, err_msg=name)
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)
    np.testing.assert_array_equal(p["aux"].photons.numpy(),
                                  np.asarray(j["aux"].photons))


_SEEDS = [0, 1, 12345, 0x7FFFFFFF, 0xFFFFFFFF]
_STEPS = [0, 1, 7, 2 ** 20 + 3, 2 ** 31 - 1]
_GIDS = np.array([0, 1, 2, 1000, 3999, 2 ** 31 - 2, 2 ** 31 - 1], np.int32)


@pytest.mark.parametrize("seed", _SEEDS)
def test_prng_words_bit_exact(seed):
    for step in _STEPS:
        jw = j_prng.counter_bits2(np.uint32(seed), np.uint32(step),
                                  jnp.asarray(_GIDS))
        w = prng.counter_bits2(seed, step, torch.as_tensor(_GIDS))
        for a, b in zip(w, jw):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b).astype(np.int64))
        ju = j_prng.uniform4_16(np.uint32(seed), np.uint32(step),
                                jnp.asarray(_GIDS), jnp.float64)
        u = prng.uniform4_16(seed, step, torch.as_tensor(_GIDS),
                             torch.float64)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def test_other_engines_raise_naming_roadmap_item(lj_deck):
    """The argon deck takes the Verlet-list engine, whose step the port
    builds; the "gather" engine builds its step too, which runs; what the
    port does not run (a CUDA graph of the slab step over ``DistRing``)
    raises naming the ROADMAP; a bonded deck builds its step on one
    device and on a slab mesh."""
    from aztotmd_tpu_torch.parallel import slab
    from aztotmd_tpu_torch.parallel.comm import LocalRing
    from aztotmd_tpu_torch.runtime.step import make_step
    d = load_deck_dir(lj_deck, dtype="f32")
    assert d["cfg"].pair_engine == "neighbor"
    assert callable(make_step(d["cfg"], d["aux"]))
    g = load_deck_dir(lj_deck, dtype="f32", pair_engine="gather")
    assert g["cfg"].pair_engine == "gather"
    st = make_step(g["cfg"], g["aux"])(g["state"], g["ff"])
    assert int(st.step) == 1 and bool(torch.isfinite(st.pos).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        slab.make_slab_multi_step(d["cfg"], d["aux"], object(), graph=True)
    bonded = load_deck_dir(os.path.join(ROOT, "examples", "bonded_fluid"))
    assert callable(make_step(bonded["cfg"], bonded["aux"]))
    assert callable(slab.make_slab_step(
        slab.prepare_slab_cfg(bonded["cfg"], 4), bonded["aux"], LocalRing(4)))
    # the block engine and Ewald decks build their steps
    for name in ("molten_salt", "liquid_argon"):
        d = load_deck_dir(os.path.join(ROOT, "examples", name))
        assert callable(make_step(d["cfg"], d["aux"]))


@pytest.mark.parametrize("name", ["reactive_polymer", "ejump_redox"])
def test_reactive_deck_writers_reproduce_examples(name, tmp_path):
    """The port's writers reproduce the committed reactive examples (made
    by tools/make_examples.py) byte for byte at their defaults."""
    write = {"reactive_polymer": systems.write_reactive_polymer_deck,
             "ejump_redox": systems.write_ejump_redox_deck}[name]
    write(str(tmp_path))
    for f in ("atoms.xyz", "control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / f),
                           os.path.join(ROOT, "examples", name, f),
                           shallow=False), f


def test_lattice_positions_and_argon_specs_equal_jax():
    """``lattice_positions`` is JAX's, and ``liquid_argon_specs`` gives
    the config of ``aztotmd_tpu.systems.build_lj_argon``."""
    from aztotmd_tpu.systems import build_lj_argon, lattice_positions
    pos, box = systems.lattice_positions(700, 0.021, seed=4)
    jpos, jbox = lattice_positions(700, 0.021, seed=4)
    assert box == jbox
    np.testing.assert_array_equal(pos, jpos)
    jcfg, _, jstate, _ = build_lj_argon(n_atoms=2048, density=0.012,
                                        dtype="f32", seed=17,
                                        pair_engine="pallas")
    cfg, _, tp, _, _ = systems.pair_system(systems.liquid_argon_specs(),
                                           "f32")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jstate.pos))
    skip = ("deg_free", "te_kin", "temp")
    a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert {k: v for k, v in a.items() if k not in skip} \
        == {k: v for k, v in b.items() if k not in skip}


def test_tile_deck_replicates_at_the_same_density(tmp_path):
    src = os.path.join(ROOT, "examples", "ejump_redox")
    systems.tile_deck(src, str(tmp_path), 2)
    a = parse_atoms_file(os.path.join(src, "atoms.xyz"))
    b = parse_atoms_file(str(tmp_path / "atoms.xyz"))
    assert b.n_atoms == 8 * a.n_atoms
    np.testing.assert_allclose(b.box, 2.0 * np.asarray(a.box))
    pa, pb = np.asarray(a.pos), np.asarray(b.pos)
    np.testing.assert_allclose(pb[:a.n_atoms], pa, atol=1e-6)
    np.testing.assert_allclose(pb[-a.n_atoms:], pa + np.asarray(a.box),
                               atol=1e-5)
    assert list(b.names[a.n_atoms:2 * a.n_atoms]) == list(a.names)
    for f in ("control.txt", "field.txt"):
        assert filecmp.cmp(str(tmp_path / f), os.path.join(src, f),
                           shallow=False)
    # the 3x tiles are the K4-cand checks' systems: the sparse engine with
    # the deck's candidates
    systems.tile_deck(src, str(tmp_path / "t3"), 3)
    d = load_deck_dir(str(tmp_path / "t3"), pair_engine="sparse")
    assert d["cfg"].n_at == 9504 and d["cfg"].ejtype
