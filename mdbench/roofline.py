"""The least time of the step's pair work, from the chip's published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.

The work is counted from the potential's formula over the pairs within
the cutoff on a given state, whatever implements the pass: each input
byte read once (positions, types, and the thermal radii where the
potential reads them), each output byte written once (forces, and the
energy).  Slot pairs a kernel visits beyond those are not work.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12

# float32 operations per pair within the cutoff, each pair once (i < j):
# the minimum-image distance (3 subtractions, 3 divisions, 3 roundings,
# 3 multiply-subtracts counted as 2 each) 15, r^2 5, the potential's
# energy and force over r (below), the force vector 3 multiplications,
# and its accumulation into both atoms 6 additions and the energy 1.
PAIR_BASE_FLOPS = 15 + 5 + 3 + 6 + 1
POTENTIAL_FLOPS = {
    # r2i 1, sr2 1, sr6 2, e = p0*sr6*(sr6-1) 3, f = p2*r2i*sr6*(2sr6-1) 5
    "lnjs": 12,
    # r2i 1, 1/r (sqrt, division) 2, r6i 2, den 3, c2sum 1, rprod 1,
    # c1ab2 2, e = rprod*r6i*(c1ab2*ri - c2sum) 4,
    # f = rprod*r6i*r2i*(7*c1ab2*ri - 6*c2sum) 7
    "surk": 23,
}


def pair_work(pot: str, n_atoms: int, n_pairs: int, radii: bool):
    """(float32 operations, bytes) of one pair pass over ``n_pairs`` pairs
    within the cutoff among ``n_atoms`` atoms."""
    flops = n_pairs * (PAIR_BASE_FLOPS + POTENTIAL_FLOPS[pot])
    per_atom_in = 12 + 4 + (4 if radii else 0)     # pos f32x3, type, radius
    per_atom_out = 12                               # force f32x3
    nbytes = n_atoms * (per_atom_in + per_atom_out) + 4
    return flops, nbytes


def least_seconds(flops: float, nbytes: float):
    """(least seconds, the bound that sets it: "compute" or "memory")."""
    tc = flops / PEAK_FLOPS_F32
    tm = nbytes / PEAK_BYTES
    return (tc, "compute") if tc >= tm else (tm, "memory")
