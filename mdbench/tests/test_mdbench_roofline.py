"""``roofline.py`` on a hand-checked three-atom case."""

import torch

from mdbench import roofline
from mdbench.reference.md import pairs_within


def test_three_atoms():
    # a and b 3 A apart, c 5 A from b and 8 A from a (box 100 A): with a
    # 4 A cutoff one pair is within it
    x = torch.tensor([[10.0, 10, 10], [13.0, 10, 10], [18.0, 10, 10]],
                     dtype=torch.float64)
    i, j = pairs_within(x, 100.0, 4.0)
    assert (i.tolist(), j.tolist()) == ([0], [1])
    # across the periodic boundary: 1 A and 99 A are 2 A apart
    y = torch.tensor([[1.0, 5, 5], [99.0, 5, 5], [50.0, 5, 5]],
                     dtype=torch.float64)
    assert len(pairs_within(y, 100.0, 4.0)[0]) == 1
    flops, nbytes = roofline.pair_work("lnjs", 3, 1, radii=False)
    # 30 for the distance and the accumulation, 12 for LJ
    assert flops == 42
    # 3 atoms x (12 + 4 in, 12 out) + the energy's 4
    assert nbytes == 3 * 28 + 4
    flops_s, nbytes_s = roofline.pair_work("surk", 3, 1, radii=True)
    assert (flops_s, nbytes_s) == (53, 3 * 32 + 4)
    t, bound = roofline.least_seconds(flops, nbytes)
    assert bound == "memory" and t == nbytes / 3.35e12
    t, bound = roofline.least_seconds(67e12, 1.0)
    assert bound == "compute" and t == 1.0
