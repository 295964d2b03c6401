"""The port stands alone: it imports neither jax nor the JAX package, and
its own copies of the host layers (``io``, ``units``, ``output.writers``)
parse and write exactly what the JAX package's do."""

import ast
import dataclasses
import os

import numpy as np
import pytest

import aztotmd_tpu.io as j_io
import aztotmd_tpu.output.writers as j_writers
from aztotmd_tpu import units as j_units
import aztotmd_tpu_torch.io as p_io
import aztotmd_tpu_torch.output.writers as p_writers
from aztotmd_tpu_torch import units as p_units

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(d for d in os.listdir(os.path.join(ROOT, "examples"))
                  if os.path.isdir(os.path.join(ROOT, "examples", d)))


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "aztotmd_tpu_torch")):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "aztotmd_tpu")


def test_port_imports_no_jax_and_no_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(_port_sources()) > 20
    assert not bad, bad


def _norm(x):
    """Comparable plain form of parsed decks (dataclasses, arrays)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _parse_deck(io, deck):
    fld = io.parse_field_file(os.path.join(deck, "field.txt"))
    ctl = io.parse_control_file(os.path.join(deck, "control.txt"),
                                charged_spec=fld.charged_spec)
    atoms = io.parse_atoms_file(os.path.join(deck, "atoms.xyz"))
    out = dict(fld=fld, ctl=ctl, atoms=atoms,
               dev=io.parse_device_cfg_dir(deck))
    types = np.array([fld.spec_id(nm) for nm in atoms.names], np.int32)
    if os.path.exists(os.path.join(deck, "bonds.txt")):
        out["bonds"] = io.parse_bondlist_file(
            os.path.join(deck, "bonds.txt"), types, fld.bonds)
    if os.path.exists(os.path.join(deck, "angles.txt")):
        out["angles"] = io.parse_anglelist_file(
            os.path.join(deck, "angles.txt"), types, fld.angles)
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_copied_parsers_equal_jax_parsers(name):
    deck = os.path.join(ROOT, "examples", name)
    got = _parse_deck(p_io, deck)
    ref = _parse_deck(j_io, deck)
    assert got.keys() == ref.keys()
    for key in ref:
        assert _norm(got[key]) == _norm(ref[key]), key


def test_copied_units_equal():
    names = [n for n in dir(j_units) if n.isupper()]
    assert len(names) > 10
    for n in names:
        assert getattr(p_units, n) == getattr(j_units, n), n


def test_copied_writers_write_equal_bytes(tmp_path):
    """revcon.xyz and traj.dat through both packages' writers from the
    same positions: each package's native row formatter (its traj rows
    formatted from float32, its xyz rows pinned to printf), built from
    each package's own copy of aztocore.cpp."""
    import aztotmd_tpu.native as j_native
    assert j_native.HAVE_NATIVE
    deck = os.path.join(ROOT, "examples", "surkov_cluster")
    fld = p_io.parse_field_file(os.path.join(deck, "field.txt"))
    rng = np.random.default_rng(3)
    n = 50
    pos = rng.uniform(-40.0, 40.0, (n, 3))
    types = np.zeros(n, np.int32)
    parents = np.where(rng.uniform(size=n) < 0.3, rng.integers(0, n, n),
                       -1).astype(np.int32)
    names = ["Su"] * n
    box = (35.0, 35.0, 35.0)
    for w, tag in ((p_writers, "p"), (j_writers, "j")):
        w.write_atoms_xyz(str(tmp_path / f"{tag}.xyz"), names, pos, box)
    for w, tag in ((p_writers, "p"), (j_writers, "j")):
        t = w.TrajWriter(str(tmp_path / f"{tag}.traj"), fld, types)
        for step in (10, 20):
            t.write_row(step * 0.001, step, pos + step, types, parents)
        t.close()
    for ext in ("xyz", "traj"):
        a = (tmp_path / f"p.{ext}").read_bytes()
        assert a and a == (tmp_path / f"j.{ext}").read_bytes(), ext


def test_native_source_is_the_jax_packages():
    """The port's aztocore.cpp is the JAX package's csrc/aztocore.cpp."""
    with open(os.path.join(ROOT, "csrc", "aztocore.cpp"), "rb") as f, \
            open(os.path.join(ROOT, "aztotmd_tpu_torch", "csrc",
                              "aztocore.cpp"), "rb") as g:
        assert f.read() == g.read()


def test_copied_bond_and_jump_writers_write_equal_bytes(tmp_path):
    """stat_bnd.dat, jumps.dat, revbonds.txt and lengths.dat through both
    packages' writers from the same rows, appended to as a resumed run
    does."""
    deck = os.path.join(ROOT, "examples", "reactive_polymer")
    fld = p_io.parse_field_file(os.path.join(deck, "field.txt"))
    rng = np.random.default_rng(5)
    n, nb = 60, 25
    pos = rng.uniform(0.0, 20.0, (n, 3))
    at1, at2 = rng.integers(0, n, nb), rng.integers(0, n, nb)
    bt = rng.integers(1, len(fld.bonds), nb)
    rows = [(step, rng.integers(0, 9, 2), rng.uniform(0, 3, 2),
             rng.uniform(0, 9, 2)) for step in (100, 200, 300, 400)]
    for w, tag in ((p_writers, "p"), (j_writers, "j")):
        for append, part in ((False, rows[:2]), (True, rows[2:])):
            b = w.BondStatWriter(str(tmp_path / f"{tag}.bnd"), fld,
                                 append=append)
            j = w.JumpWriter(str(tmp_path / f"{tag}.jmp"), append=append)
            for step, cnt, r_mean, lt_mean in part:
                b.write_row(step * 5e-4, step, 7 + step, cnt, r_mean, lt_mean)
                j.write_row(step * 1e-3, step, step // 3, step // 7, 2)
            b.close()
            j.close()
        w.write_bondlist(str(tmp_path / f"{tag}.bonds"), at1, at2, bt)
        w.write_bond_lengths(str(tmp_path / f"{tag}.len"), fld, at1, at2, bt,
                             pos, (20.0, 20.0, 20.0))
    for ext in ("bnd", "jmp", "bonds", "len"):
        a = (tmp_path / f"p.{ext}").read_bytes()
        assert a and a == (tmp_path / f"j.{ext}").read_bytes(), ext


def test_copied_angle_writer_writes_equal_bytes(tmp_path):
    """revangles.txt through both packages' writers from the same angle
    table."""
    rng = np.random.default_rng(7)
    cols = [rng.integers(0, 500, 40) for _ in range(3)]
    at = rng.integers(1, 4, 40).astype(np.int32)
    for w, tag in ((p_writers, "p"), (j_writers, "j")):
        w.write_anglelist(str(tmp_path / f"{tag}.ang"), *cols, at)
    a = (tmp_path / "p.ang").read_bytes()
    assert a and a == (tmp_path / "j.ang").read_bytes()


def test_copied_io_writers_write_equal_bytes(tmp_path):
    """The io writers (``write_atoms``, ``atoms.write_velocities``,
    ``write_bondlist``, ``write_anglelist``) of both packages, with the
    JAX package's signatures, from the same inputs: files equal byte for
    byte; the package exports them as the JAX package's does."""
    import aztotmd_tpu.io.atoms as j_atoms
    import aztotmd_tpu_torch.io.atoms as p_atoms
    rng = np.random.default_rng(11)
    n = 40
    names = [("Na", "Cl", "O")[k] for k in rng.integers(0, 3, n)]
    types = rng.integers(0, 3, n).astype(np.int32)
    pos = rng.uniform(-30.0, 30.0, (n, 3))
    vel = rng.normal(size=(n, 3)) * 1e-2
    box = (31.5, 28.25, 40.0)
    bonds = [rng.integers(0, n, 25) for _ in range(3)]
    angles = [rng.integers(0, n, 30) for _ in range(4)]
    for io, atoms, tag in ((p_io, p_atoms, "p"), (j_io, j_atoms, "j")):
        io.write_atoms(str(tmp_path / f"{tag}.xyz"), names, pos, box)
        atoms.write_velocities(str(tmp_path / f"{tag}.vel"),
                               ["Na", "Cl", "O", "X"], types, vel)
        io.write_bondlist(str(tmp_path / f"{tag}.bonds"), *bonds)
        io.write_anglelist(str(tmp_path / f"{tag}.angles"), *angles)
    for ext in ("xyz", "vel", "bonds", "angles"):
        a = (tmp_path / f"p.{ext}").read_bytes()
        assert a and a == (tmp_path / f"j.{ext}").read_bytes(), ext
    assert p_io.__all__ == j_io.__all__


_SYNCS = (".item(", ".tolist(", ".cpu(", ".numpy(", "bincount", "nonzero",
          "torch.unique", "masked_select", "repeat_interleave")


@pytest.mark.parametrize("rel", ["ops/bonds.py", "ops/ejump.py",
                                 "ops/jrandom.py", "runtime/step.py",
                                 "ops/neighbors.py", "ops/angles.py"])
def test_reactive_step_code_has_no_host_sync(rel):
    """The reactive stages run inside the step, which must not wait for
    the device: none of the calls that copy to the host or size an output
    from device data appears in their code (comments and docstrings
    aside)."""
    import io
    import tokenize
    with open(os.path.join(ROOT, "aztotmd_tpu_torch", rel)) as f:
        toks = [t for t in tokenize.generate_tokens(io.StringIO(
            f.read()).readline) if t.type not in (tokenize.COMMENT,
                                                   tokenize.STRING)]
    code = "".join(t.string for t in toks)
    assert not [s for s in _SYNCS if s in code]
