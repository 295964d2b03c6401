// Per-pair physics shared by the port's pair kernels (allpairs.cu, sparse.cu),
// f32.  Device code of aztotmd_tpu/ops/pallas_pair.py::_tile_physics with
// _vdw_pair, _coul_pair and _erfc, for one ordered pair (i, j):
//   min-image displacement (round half to even, rintf, with 1/box rounded
//   to f32 as the JAX package does); pairs with r2 > r2_max are skipped (the
//   TPU kernels mask them after sanitizing r2 to 1 before the rsqrt, which
//   gives the same sums);
//   ri = rsqrt(r2), r2i = ri*ri, rr = r2*ri;
//   VdW of the species pair's kind (7 families, Surkov with per-atom radii)
//   where r2 <= that pair's r2cut, plus the Coulomb term of the static elec
//   type (none / direct / Ewald real space / Fennel, erfc by
//   Abramowitz-Stegun 7.1.26);
//   the summed force-over-r of the pair is clipped to +-MX_FRC, then
//   multiplied into dx, dy, dz; energies take weight 0.5 per ordered pair.
// The caller masks self pairs and padding before calling pair_accumulate.
// Build without fast-math: the plain PyTorch versions are the reference.

#pragma once

#include <cuda_runtime.h>

namespace aztotmd {

constexpr float MX_FRC = 1.0e4f;

// families (aztotmd_tpu_torch.io.field VDW_*)
constexpr int VDW_LJ = 1, VDW_BUCK = 2, VDW_746 = 3, VDW_BHM = 4,
              VDW_ELIN = 5, VDW_EINV = 6, VDW_SURK = 7;
// elec types (aztotmd_tpu_torch.io.control ELEC_*)
constexpr int ELEC_DIRECT = 1, ELEC_EWALD = 2, ELEC_FENNEL = 3;

// Scalars of the pass: box, its f32 reciprocal, cutoff and Coulomb constants.
struct PairConsts {
    int nsp, use_radii, elec_type;
    float bx, by, bz, ibx, iby, ibz;
    float r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real;
};

__device__ __forceinline__ float erfc_as(float x) {
    const float t = 1.0f / (1.0f + 0.3275911f * x);
    const float poly = t * (0.254829592f + t * (-0.284496736f
                       + t * (1.421413741f + t * (-1.453152027f
                       + t * 1.061405429f))));
    return poly * expf(-x * x);
}

__device__ __forceinline__ void vdw_pair(int kind, float r2i, float ri,
                                         float rr, const float* p,
                                         float ra, float rb,
                                         float& f, float& e) {
    const float p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3], p4 = p[4];
    switch (kind) {
    case VDW_LJ: {
        const float s = p1 * r2i;
        const float sr6 = s * s * s;
        e = p0 * sr6 * (sr6 - 1.0f);
        f = p2 * r2i * sr6 * (2.0f * sr6 - 1.0f);
        break;
    }
    case VDW_BUCK: {
        const float ip1 = 1.0f / p1;
        const float r6i = r2i * r2i * r2i;
        const float ex = expf(-rr * ip1);
        e = p0 * ex - p2 * r6i;
        f = p0 * ex * ri * ip1 - 6.0f * p2 * r6i * r2i;
        break;
    }
    case VDW_746: {
        const float r4i = r2i * r2i;
        e = r4i * (p0 * r2i * ri - p1 - p2 * r2i);
        f = r4i * r2i * (7.0f * p0 * r2i * ri - 4.0f * p1 - 6.0f * p2 * r2i);
        break;
    }
    case VDW_BHM: {
        const float r6i = r2i * r2i * r2i;
        const float ex = expf(p1 * (p2 - rr));
        e = p0 * ex - p3 * r6i - p4 * r6i * r2i;
        f = p0 * p1 * ex * ri - 6.0f * p3 * r6i * r2i
            - 8.0f * p4 * r6i * r2i * r2i;
        break;
    }
    case VDW_ELIN: {
        const float ip1 = 1.0f / p1;
        const float ex = expf(-rr * ip1);
        e = p0 * ex + p2 * rr;
        f = p0 * ex * ri * ip1 - p2 * ri;
        break;
    }
    case VDW_EINV: {
        const float ip1 = 1.0f / p1;
        const float ex = expf(-rr * ip1);
        e = p0 * ex - p2 * ri;
        f = p0 * ex * ri * ip1 - p2 * ri * r2i;
        break;
    }
    case VDW_SURK: {
        const float r6i = r2i * r2i * r2i;
        const float c2sum = p1 / (p2 * ra + p3 * rb);
        const float rprod = ra * rb;
        const float c1ab2 = rprod * rprod * p0;
        e = rprod * r6i * (c1ab2 * ri - c2sum);
        f = rprod * r6i * r2i * (7.0f * c1ab2 * ri - 6.0f * c2sum);
        break;
    }
    default:
        f = 0.0f;
        e = 0.0f;
    }
}

__device__ __forceinline__ void coul_pair(const PairConsts& c, float r2i,
                                          float ri, float rr, float kqq,
                                          float& f, float& e) {
    if (c.elec_type == ELEC_DIRECT) {
        f = kqq * ri * r2i;
        e = kqq * ri;
    } else if (c.elec_type == ELEC_EWALD) {
        const float ar = c.alpha * rr;
        const float ecf = erfc_as(ar);
        f = kqq * ri * r2i * (ecf + c.daipi2 * rr * expf(-ar * ar));
        e = kqq * ecf * ri;
    } else {  // ELEC_FENNEL
        const float ar = c.alpha * rr;
        const float ecf = erfc_as(ar);
        e = kqq * (ecf * ri - c.fennel_c1 + c.fennel_c2 * (rr - c.r_real));
        f = kqq * ri * ((ecf * r2i + c.daipi2 * expf(-ar * ar) * ri)
                        - c.fennel_c2);
    }
}

// Stage the (nsp*nsp, 8) parameter rows [p0..p4, kqq, r2cut, unused] and
// the (nsp*nsp,) kind table into shared memory (kinds right after the
// rows).  The caller synchronises before the first read.
__device__ __forceinline__ void load_tables(float* s_tab, const float* params,
                                            const int* kinds, int npair) {
    int* s_kind = reinterpret_cast<int*>(s_tab + npair * 8);
    for (int k = threadIdx.x; k < npair * 8; k += blockDim.x)
        s_tab[k] = params[k];
    for (int k = threadIdx.x; k < npair; k += blockDim.x)
        s_kind[k] = kinds[k];
}

// One ordered pair of two distinct real atoms, displacement d = r_i - r_j
// before the min-image: adds its force to (fx, fy, fz) and half its
// energies to ev, ec.
__device__ __forceinline__ void pair_accumulate(
        const PairConsts& c, const float* s_tab, float dx, float dy,
        float dz, int ti, int tj, float rai, float raj,
        float& fx, float& fy, float& fz, float& ev, float& ec) {
    const int* s_kind = reinterpret_cast<const int*>(
        s_tab + c.nsp * c.nsp * 8);
    dx = dx - c.bx * rintf(dx * c.ibx);
    dy = dy - c.by * rintf(dy * c.iby);
    dz = dz - c.bz * rintf(dz * c.ibz);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 <= c.r2_max)) return;
    const float ri = rsqrtf(r2);
    const float r2i = ri * ri;
    const float rr = r2 * ri;
    const int row = ti * c.nsp + tj;
    const float* p = s_tab + row * 8;
    float fsum = 0.0f;
    const int kind = s_kind[row];
    if (kind != 0 && r2 <= p[6]) {
        float f, e;
        vdw_pair(kind, r2i, ri, rr, p, rai, raj, f, e);
        fsum += f;
        ev += 0.5f * e;
    }
    if (c.elec_type != 0) {
        float f, e;
        coul_pair(c, r2i, ri, rr, p[5], f, e);
        fsum += f;
        ec += 0.5f * e;
    }
    // clip that keeps a NaN a NaN, like jnp.clip
    fsum = fsum > MX_FRC ? MX_FRC : (fsum < -MX_FRC ? -MX_FRC : fsum);
    fx += fsum * dx;
    fy += fsum * dy;
    fz += fsum * dz;
}

}  // namespace aztotmd
