"""The port's native row formatter (``aztotmd_tpu_torch/native.py``, built
from ``aztotmd_tpu_torch/csrc/aztocore.cpp`` at first use): the
formatting and parsing round trips of the JAX package's
``tests/test_native.py``, a library named by its source's hash, and a
failed build that raises with the compiler's output."""

import os

import numpy as np
import pytest

from aztotmd_tpu_torch import native


def test_row_formatting_matches_printf(tmp_path):
    p = str(tmp_path / "rows.dat")
    f = native.NativeRowFile(p)
    f.write_str("h\n")
    # (exact .5e-7 ties round differently from C's round-to-even —
    # immaterial for MD output, excluded here)
    vals = [0.0, 1.5, -2.25, 1234567.875, 1e-7, -3.4e-6]
    f.write_row(0.123456789, 42, vals)
    f.close()
    lines = open(p).read().splitlines()
    expect = "\t".join(["0.123457", "42"] + [f"{v:.6f}" for v in vals])
    assert lines[1] == expect


def test_traj_row_layout(tmp_path):
    p = str(tmp_path / "traj.dat")
    f = native.NativeRowFile(p)
    pos = np.array([[1.0, 2.0, 3.0], [4.5, 5.5, 6.5]], np.float32)
    types = np.array([0, 1], np.int32)
    ptypes = np.array([-1, 0], np.int32)
    f.write_traj_row(0.5, 7, pos, types, ptypes)
    f.close()
    row = open(p).read().lstrip("\n").split("\t")
    assert row[0] == "0.500000" and row[1] == "7"
    assert row[2:7] == ["1.000000", "2.000000", "3.000000",
                        "0.000000", "-1.000000"]


def test_xyz_parse_roundtrip(tmp_path):
    names = ["Ar", "Na+", "Cl-"] * 100
    pos = np.round(np.random.default_rng(0).uniform(0, 50, (300, 3)), 6)
    text = "".join(f"{nm} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n"
                   for nm, p in zip(names, pos))
    out_names, out_pos = native.parse_xyz_rows(text, 300)
    assert out_names == names
    np.testing.assert_allclose(out_pos, pos, atol=1e-12)


def test_xyz_parse_whitespace_agnostic():
    # fscanf semantics: arbitrary whitespace, multiple atoms per line
    names, pos = native.parse_xyz_rows("A 1 2 3 B\t4\t5\t6\nC 7 8 9", 3)
    assert names == ["A", "B", "C"]
    np.testing.assert_allclose(pos, [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


def test_xyz_rows_round_trip_through_the_writer(tmp_path):
    """write_xyz_rows then parse_xyz_rows gives the names and the
    positions to the printed six decimals."""
    rng = np.random.default_rng(1)
    names = ["Fe2", "O", "Su"] * 20
    pos = rng.uniform(-30.0, 30.0, (60, 3))
    p = str(tmp_path / "rows.xyz")
    f = native.NativeRowFile(p)
    f.write_xyz_rows(names, pos)
    f.close()
    got_names, got = native.parse_xyz_rows(open(p).read(), 60)
    assert got_names == names
    np.testing.assert_allclose(got, pos, rtol=0, atol=5e-7)


def test_library_is_named_by_its_source(tmp_path, monkeypatch):
    """The library's name carries the source's hash; an edited source
    builds another library, and one g++ cannot compile raises with the
    compiler's message."""
    so = native.build()
    assert os.path.exists(so) and so == native.library_path()
    assert os.path.dirname(so) == native.BUILD_DIR
    bad = tmp_path / "aztocore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    assert native.library_path() != so
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
