"""The engine a deck runs on each device (``core/config.py::
device_pair_engine``, applied by ``runtime/setup.py::build_system``), on
the CPU.

The CPU keeps the JAX package's choice on every example deck.  On a CUDA
device an ``"auto"`` deck that the cost model sends to the torch
cell-block engine (``"block"``) runs on ``"pallas"`` where that engine's
pass is the stacked kernel K3: the liquid_argon deck.  Every other case
keeps ``"block"``: f64, bind/jump candidates, a grid under three cells a
side or with offsets beyond +-1, a ``cap`` that K3's shared memory cannot
hold, and a ``"block"`` the user named.  The dense decks stay on K1 and
the gas on its Verlet list.  The choice is host code, so it is asked for
"cuda" here without a card.
"""

import dataclasses
import os

import pytest
import torch

from aztotmd_tpu.runtime.setup import load_deck_dir as j_load_deck_dir
from aztotmd_tpu_torch.core.config import device_pair_engine
from aztotmd_tpu_torch.ops import allpairs
from aztotmd_tpu_torch.runtime.setup import load_deck_dir
from aztotmd_tpu_torch.runtime.step import pair_pass, torch_engine_reason

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
LIQUID = os.path.join(EXAMPLES, "liquid_argon")

# the JAX package's choice for each example deck, and the one-device
# kernel (or torch engine) of each on the card
DECKS = {"argon_gas": ("neighbor", "neighbor list (torch ops)"),
         "bonded_fluid": ("neighbor", "neighbor list (torch ops)"),
         "ejump_redox": ("pallas", "allpairs (K1-cand)"),
         "liquid_argon": ("block", "stacked (K3)"),
         "molten_salt": ("pallas", "allpairs (K1)"),
         "nanoclusters": ("sparse", "sparse (K4)"),
         "reactive_polymer": ("pallas", "allpairs (K1-cand)"),
         "surkov_cluster": ("pallas", "allpairs (K1)")}


@pytest.fixture(scope="module")
def liquid():
    return load_deck_dir(LIQUID, device="cpu")


def test_every_example_deck_is_covered():
    assert sorted(DECKS) == sorted(
        d for d in os.listdir(EXAMPLES)
        if os.path.isdir(os.path.join(EXAMPLES, d)))


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_cpu_choice_is_the_jax_packages(deck):
    """Loaded on the CPU every example deck keeps the JAX package's
    engine, and its record's words name the plain versions; on "cuda"
    only liquid_argon changes engine, to "pallas" (K3)."""
    p = load_deck_dir(os.path.join(EXAMPLES, deck), device="cpu")
    j = j_load_deck_dir(os.path.join(EXAMPLES, deck))
    engine, on_card = DECKS[deck]
    cfg = p["cfg"]
    assert cfg.pair_engine == j["cfg"].pair_engine == engine
    assert p["cost_engine"] is None
    assert device_pair_engine(cfg, "cpu") == engine
    card = device_pair_engine(cfg, "cuda")
    assert card == ("pallas" if deck == "liquid_argon" else engine)
    card_cfg = dataclasses.replace(cfg, pair_engine=card)
    assert pair_pass(card_cfg, torch.float32) == on_card
    if "torch ops" not in on_card:
        assert torch_engine_reason(card_cfg, torch.float32) is None
        kernel = on_card.split("(")[1]
        assert pair_pass(card_cfg, torch.float32, "cpu").endswith(
            f"the plain version of {kernel}")


def test_liquid_takes_the_stacked_pass_on_the_card(liquid):
    cfg = liquid["cfg"]
    assert cfg.pair_engine == "block" and cfg.dtype == "f32"
    assert torch_engine_reason(cfg, torch.float32) == \
        'the deck selects the "block" engine'
    on_card = dataclasses.replace(cfg, pair_engine=device_pair_engine(
        cfg, "cuda"))
    assert on_card.pair_engine == "pallas"
    assert allpairs.pallas_branch(on_card, torch.float32) == "stacked"
    assert torch_engine_reason(on_card, torch.float32) is None
    assert pair_pass(on_card, torch.float32) == "stacked (K3)"
    assert pair_pass(cfg, torch.float32).startswith(
        'block (torch ops: the deck selects the "block" engine')


def _grid(cfg, **kw):
    return dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, **kw))


_KEEP = {
    "f64": lambda c: dataclasses.replace(c, dtype="f64"),
    "bind": lambda c: dataclasses.replace(c, use_bnd=2, use_linkage=1),
    "jump": lambda c: dataclasses.replace(c, ejtype=1),
    "two_cells_a_side": lambda c: _grid(c, dims=(2, 13, 13)),
    "offset_beyond_one": lambda c: _grid(
        c, stencil=tuple(c.grid.stencil) + ((2, 0, 0), (-2, 0, 0))),
    # 27 cells of 420 slots: cheaper than the dense pass, but 9 staged
    # columns of 3 cells of 420 slots overflow a K3 block's shared memory
    "cap_over_shared_memory": lambda c: _grid(c, dims=(3, 3, 3), cap=420),
}


@pytest.mark.parametrize("case", sorted(_KEEP))
def test_block_stays_where_k3_cannot_take_it(liquid, case):
    cfg = _KEEP[case](liquid["cfg"])
    if case == "cap_over_shared_memory":
        assert allpairs.block_cost(cfg) < allpairs.allpairs_cost(cfg)
    assert device_pair_engine(cfg, "cuda") == "block"


def test_a_named_block_engine_stands(liquid):
    cfg = liquid["cfg"]
    assert device_pair_engine(cfg, "cuda", requested="block") == "block"
    assert device_pair_engine(cfg, "cuda", requested="auto") == "pallas"
    named = load_deck_dir(LIQUID, device="cpu", pair_engine="block")
    assert named["cfg"].pair_engine == "block"
    assert named["cost_engine"] is None


def test_slab_mesh_routes_from_the_cost_models_engine(tmp_path):
    """The slab mesh (``run --mesh N``) is not the one-device step: a deck
    that the card's rule moved to "pallas" takes the slab stencil pass, as
    the cost model's "block" does, while a "pallas" the user named takes
    the slab's dense pass (K2)."""
    from aztotmd_tpu_torch import systems
    from aztotmd_tpu_torch.runtime.runner import MDRunner
    deck = str(tmp_path / "liquid")
    os.makedirs(deck)
    systems.write_liquid_argon_deck(deck, n_side=10, steps=100)
    for cost, want in (("block", "block"), (None, "pallas")):
        d = load_deck_dir(deck, device="cpu")
        d["cfg"] = dataclasses.replace(d["cfg"], pair_engine="pallas")
        d["cost_engine"] = cost
        r = MDRunner(d, out_dir=str(tmp_path / f"out_{want}"), quiet=True,
                     mesh_devices=2)
        assert r.cfg.pair_engine == want
        assert r.pair_pass() == ("slab stencil (torch ops)" if cost
                                 else "slab dense (K2)")
