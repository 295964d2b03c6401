"""Force-field tables as tensors (port of ``aztotmd_tpu/core/ffield.py``).

Per-species and per-species-pair parameters live in dense tables with the
JAX package's field names; the pair kernel reads the (nsp, nsp) kind and
parameter tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.field import FieldSpec


@dataclass
class ForceField:
    """Dense per-species / per-pair parameter tables (all tensors)."""
    # species tables
    spec_mass: torch.Tensor        # (nsp,)
    spec_rmass_hdt: torch.Tensor   # 0.5*dt/mass
    spec_charge: torch.Tensor      # (nsp,)
    spec_energy: torch.Tensor      # own energy for e-jump dE
    spec_frozen: torch.Tensor      # (nsp,) int32
    spec_donacc: torch.Tensor      # (nsp,) int32 bit0 donor bit1 acceptor
    spec_oxform: torch.Tensor      # (nsp,) int32, 0 = none (1-based)
    spec_redform: torch.Tensor
    spec_varnumber: torch.Tensor   # (nsp,) int32
    spec_angle_type: torch.Tensor  # (nsp,) int32
    spec_rad_a: torch.Tensor       # thermal-radius params (radii section)
    spec_rad_b: torch.Tensor
    spec_mx_eng: torch.Tensor

    # pair tables
    chprod: torch.Tensor           # (nsp, nsp) q_i q_j / eps
    vdw_kind: torch.Tensor         # (nsp, nsp) int32, 0 = none, else VDW_*
    vdw_p: torch.Tensor            # (nsp, nsp, 5) parameters p0..p4
    vdw_r2cut: torch.Tensor        # (nsp, nsp)

    # bond-type tables; row 0 = empty bond
    bond_kind: torch.Tensor        # (nbt,) int32
    bond_spec1: torch.Tensor
    bond_spec2: torch.Tensor
    bond_p: torch.Tensor           # (nbt, 5)
    bond_r2min: torch.Tensor
    bond_r2max: torch.Tensor
    bond_mn_ex: torch.Tensor
    bond_mx_ex: torch.Tensor
    bond_new_type: torch.Tensor    # (nbt, 2) int32
    bond_new_spec1: torch.Tensor
    bond_new_spec2: torch.Tensor
    bond_hatom: torch.Tensor
    bond_evol: torch.Tensor

    # species-pair bond defaults
    def_bond: torch.Tensor         # (nsp, nsp) int32
    bonding_matr: torch.Tensor     # (nsp, nsp) int32
    bind_r2: torch.Tensor          # (nsp, nsp)

    # angle-type tables; row 0 = empty
    ang_kind: torch.Tensor
    ang_central: torch.Tensor
    ang_p: torch.Tensor            # (nat, 3)


def vdw_tables(fld: FieldSpec):
    """Dense (nsp, nsp) kind / parameter / cutoff tables from the parsed
    pair potentials (NumPy; also read by the static config)."""
    nsp = fld.nSpec
    vdw_kind = np.zeros((nsp, nsp), dtype=np.int32)
    vdw_p = np.zeros((nsp, nsp, 5))
    vdw_r2 = np.zeros((nsp, nsp))
    for idx, pp in enumerate(fld.pairpots):
        # symmetric tables; Surkov's asymmetry rides on per-atom radii
        for (a, b) in ((pp.spec1, pp.spec2), (pp.spec2, pp.spec1)):
            if fld.vdw_index[a][b] == idx or (a, b) == (pp.spec1, pp.spec2):
                vdw_kind[a, b] = pp.type
                vdw_p[a, b] = [pp.p0, pp.p1, pp.p2, pp.p3, pp.p4]
                vdw_r2[a, b] = pp.r2cut
    return vdw_kind, vdw_p, vdw_r2


def build_forcefield(fld: FieldSpec, dt: float, eps: float = 1.0,
                     dtype=torch.float32, device=None) -> ForceField:
    """Tables of ``fld`` as tensors of ``dtype`` (floats) and int32."""
    nsp = fld.nSpec
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)

    mass = np.array([s.mass for s in fld.species])
    charge = np.array([s.charge for s in fld.species])
    chprod = np.outer(charge, charge) / eps
    vdw_kind, vdw_p, vdw_r2 = vdw_tables(fld)

    nbt = max(1, len(fld.bonds))
    bond_kind = np.zeros(nbt, np.int32)
    bond_s1 = np.zeros(nbt, np.int32)
    bond_s2 = np.zeros(nbt, np.int32)
    bond_p = np.zeros((nbt, 5))
    bond_r2min = np.zeros(nbt)
    bond_r2max = np.full(nbt, 1e18)
    bond_mn = np.zeros(nbt, np.int32)
    bond_mx = np.zeros(nbt, np.int32)
    bond_nt = np.zeros((nbt, 2), np.int32)
    bond_ns1 = np.zeros((nbt, 2), np.int32)
    bond_ns2 = np.zeros((nbt, 2), np.int32)
    bond_h = np.full(nbt, -1, np.int32)
    bond_ev = np.zeros(nbt, np.int32)
    for k, b in enumerate(fld.bonds):
        if k == 0:
            continue
        bond_kind[k] = b.type
        bond_s1[k], bond_s2[k] = b.spec1, b.spec2
        bond_p[k] = [b.p0, b.p1, b.p2, b.p3, b.p4]
        bond_r2min[k] = b.r2min
        bond_r2max[k] = b.r2max if b.mxEx else 1e18
        bond_mn[k], bond_mx[k] = b.mnEx, b.mxEx
        bond_nt[k] = b.new_type
        bond_ns1[k] = b.new_spec1
        bond_ns2[k] = b.new_spec2
        bond_h[k] = b.hatom
        bond_ev[k] = b.evol

    def mat(rows):
        if rows:
            return np.asarray(rows, np.int32)
        return np.zeros((nsp, nsp), np.int32)

    bind_r2 = np.asarray(fld.bindR2matrix, np.float64) \
        if fld.bindR2matrix else np.zeros((nsp, nsp))

    nat = max(1, len(fld.angles))
    ang_kind = np.zeros(nat, np.int32)
    ang_central = np.zeros(nat, np.int32)
    ang_p = np.zeros((nat, 3))
    for k, a in enumerate(fld.angles):
        if k == 0:
            continue
        ang_kind[k] = a.type
        ang_central[k] = a.central
        ang_p[k] = [a.p0, a.p1, a.p2]

    return ForceField(
        spec_mass=f(mass),
        spec_rmass_hdt=f(0.5 * dt / mass),
        spec_charge=f(charge),
        spec_energy=f([s.energy for s in fld.species]),
        spec_frozen=i([s.frozen for s in fld.species]),
        spec_donacc=i([s.donacc for s in fld.species]),
        spec_oxform=i([s.oxForm for s in fld.species]),
        spec_redform=i([s.redForm for s in fld.species]),
        spec_varnumber=i([s.varNumber for s in fld.species]),
        spec_angle_type=i([s.angleType for s in fld.species]),
        spec_rad_a=f([s.radA for s in fld.species]),
        spec_rad_b=f([s.radB for s in fld.species]),
        spec_mx_eng=f([s.mxEng for s in fld.species]),
        chprod=f(chprod),
        vdw_kind=i(vdw_kind), vdw_p=f(vdw_p), vdw_r2cut=f(vdw_r2),
        bond_kind=i(bond_kind), bond_spec1=i(bond_s1), bond_spec2=i(bond_s2),
        bond_p=f(bond_p), bond_r2min=f(bond_r2min), bond_r2max=f(bond_r2max),
        bond_mn_ex=i(bond_mn), bond_mx_ex=i(bond_mx),
        bond_new_type=i(bond_nt), bond_new_spec1=i(bond_ns1),
        bond_new_spec2=i(bond_ns2), bond_hatom=i(bond_h), bond_evol=i(bond_ev),
        def_bond=i(mat(fld.bond_matrix)),
        bonding_matr=i(mat(fld.bonding_matr)),
        bind_r2=f(bind_r2),
        ang_kind=i(ang_kind), ang_central=i(ang_central), ang_p=f(ang_p),
    )
