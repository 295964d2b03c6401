"""Decks made from the run's seed: frozen copies of the port's generators
(``aztotmd_tpu_torch/systems.py``: ``cluster_positions``,
``min_separation_positions``, ``lattice_positions`` and the k x k x k
tiling of ``write_scale_argon_deck``), kept here so that a change to the port's
writers cannot change the benchmark's inputs.  The control and field
text come verbatim from the configuration file.

``make_deck(cfg, traffic, seed, path)`` writes control.txt, field.txt and
atoms.xyz into ``path`` and returns the positions it wrote, rounded as
the text rounds them (the reference's start)."""

from __future__ import annotations

import math
import os

import numpy as np


def _rng(seed: int, tag: int) -> np.random.Generator:
    """A generator for one draw of the deck, keyed by the run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


def cluster_positions(n_atoms: int, box: float, density: float, rng,
                      jitter: float = 0.1):
    """Jittered simple-cubic lattice of ``n_atoms`` filling a centred
    sub-cube of side (n_atoms/density)^(1/3) of a periodic box."""
    side = (n_atoms / density) ** (1.0 / 3.0)
    if side >= box:
        raise ValueError(f"cluster side {side:.2f} does not fit box {box}")
    n_side = int(math.ceil(n_atoms ** (1.0 / 3.0) - 1e-9))
    spacing = side / n_side
    g = (np.arange(n_side) + 0.5) * spacing
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    keep = np.sort(rng.permutation(len(sites))[:n_atoms])
    pos = sites[keep] + rng.uniform(-jitter, jitter, (n_atoms, 3)) * spacing
    return pos + 0.5 * (box - side)


def min_separation_positions(n_atoms: int, box: float, min_sep: float, rng):
    """Uniform positions in a cubic periodic box, each at least ``min_sep``
    from every earlier one (minimum image): a draw closer than that is
    dropped and drawn again.  A hash grid of cells no narrower than
    ``min_sep`` keeps each test to the 27 cells around the draw."""
    n_c = max(int(box // min_sep), 1)
    edge = box / n_c
    cells: dict = {}
    pos = np.empty((n_atoms, 3))
    k = 0
    while k < n_atoms:
        p = rng.uniform(0.0, box, 3)
        c = np.floor(p / edge).astype(np.int64) % n_c
        near = False
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    key = ((c[0] + dx) % n_c, (c[1] + dy) % n_c,
                           (c[2] + dz) % n_c)
                    for q in cells.get(key, ()):
                        d = p - pos[q]
                        d -= box * np.round(d / box)
                        if d @ d < min_sep * min_sep:
                            near = True
                            break
                    if near:
                        break
                if near:
                    break
            if near:
                break
        if near:
            continue
        pos[k] = p
        cells.setdefault((c[0], c[1], c[2]), []).append(k)
        k += 1
    return pos


def lattice_positions(n_atoms: int, box: float, rng, jitter: float = 0.05):
    """Jittered simple-cubic lattice filling a periodic box: n_side =
    ceil(n_atoms^(1/3)) sites a side at spacing box / n_side, the first
    ``n_atoms`` sites in order, each moved by up to ``jitter`` spacings
    along each axis and wrapped into the box."""
    n_side = int(math.ceil(n_atoms ** (1.0 / 3.0) - 1e-9))
    spacing = box / n_side
    g = (np.arange(n_side) + 0.5) * spacing
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = sites[:n_atoms] + rng.uniform(-jitter, jitter,
                                        (n_atoms, 3)) * spacing
    return pos % box


def tile(pos, box: float, t: int, rng):
    """``write_scale_argon_deck``'s tiling: images of ``pos`` on a t^3 lattice,
    image-major, jittered by up to 0.05 A and wrapped into the t-times
    box."""
    shifts = np.stack(np.meshgrid(*[np.arange(t) * box] * 3,
                                  indexing="ij"), -1).reshape(-1, 3)
    out = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    out += rng.uniform(-0.05, 0.05, out.shape)
    big = box * t
    out %= big
    return out, big


def positions(cfg: dict, traffic: dict, seed: int):
    """(positions, box, species name) of the deck of ``cfg`` under
    ``traffic`` for ``seed``."""
    gp = cfg["generator_params"]
    kind = cfg["generator"]
    if kind == "cluster":
        box = float(gp["box"])
        pos = cluster_positions(int(gp["n_atoms"]), box, float(gp["density"]),
                                _rng(seed, 1), float(gp["jitter"]))
    elif kind in ("min_separation", "lattice"):
        box = (gp["n_atoms"] / gp["density"]) ** (1.0 / 3.0)
        # the deck's box line holds 6 decimals; draw in that box
        box = float(f"{box:.6f}")
        if kind == "lattice":
            pos = lattice_positions(int(gp["n_atoms"]), box, _rng(seed, 1),
                                    float(gp["jitter"]))
        else:
            pos = min_separation_positions(int(gp["n_atoms"]), box,
                                           float(gp["min_sep"]),
                                           _rng(seed, 1))
    else:
        raise ValueError(f"unknown generator {kind!r}")
    t = int(traffic.get("tiles", 1))
    if t > 1:
        pos = np.round(pos, 6)
        pos, box = tile(pos, box, t, _rng(seed, 2))
        box = float(f"{box:.6f}")
    return pos, box, gp["species"]


def make_deck(cfg: dict, traffic: dict, seed: int, path: str):
    """Write the deck into ``path``; returns (positions as written, box)."""
    pos, box, sp = positions(cfg, traffic, seed)
    deck = cfg["decks"][traffic["deck"]]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "atoms.xyz"), "w") as f:
        f.write(f"{len(pos)}\n1 {box:.6f} {box:.6f} {box:.6f}\n")
        np.savetxt(f, pos, fmt=sp + "\t%.6f\t%.6f\t%.6f")
    for name in ("control", "field"):
        with open(os.path.join(path, name + ".txt"), "w") as f:
            f.write(deck[name])
    return np.round(pos, 6), box
