// Per-pair physics shared by the port's pair kernels (allpairs.cu, sparse.cu,
// cellblock.cu), f32.  Device code of aztotmd_tpu/ops/pallas_pair.py::_tile_physics with
// _vdw_pair, _coul_pair and _erfc, for one ordered pair (i, j):
//   min-image displacement (round half to even, rint_fp32, with 1/box
//   rounded to f32 as the JAX package does); pairs with r2 > r2_max are
//   skipped (the TPU kernels mask them after sanitizing r2 to 1 before the
//   rsqrt, which gives the same sums);
//   ri = rsqrt(r2), r2i = ri*ri, rr = r2*ri;
//   VdW of the species pair's kind (7 families, Surkov with per-atom radii)
//   where r2 <= that pair's r2cut, plus the Coulomb term of the static elec
//   type (none / direct / Ewald real space / Fennel, erfc by
//   Abramowitz-Stegun 7.1.26);
//   the summed force-over-r of the pair is clipped to +-MX_FRC, then
//   multiplied into dx, dy, dz; energies take weight 0.5 per ordered pair.
// The caller masks self pairs and padding.
// Build without fast-math: the plain PyTorch versions are the reference.
//
// Bind/jump candidates (the kernels' candidate instantiations) compare r2
// exactly with the plain version's, so their r2 comes from min_image_r2_rn,
// which rounds every operation on its own in the plain version's order
// (nvcc would otherwise contract the min-image and the r2 sum into FMAs),
// and pair_physics then takes that r2.  A candidate minimum keeps its r2
// and an int64 key that orders ties; cand_update keeps the least
// (r2, key).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

// Stage the (nsp*nsp, 8) parameter rows [p0..p4, kqq, r2cut, bind r2] and
// the (nsp*nsp,) kind table into shared memory (kinds right after the
// rows), and with `donacc` the (nsp,) donor/acceptor bits after the kinds.
// The caller synchronises before the first read.
__device__ __forceinline__ void load_tables(float* s_tab, const float* params,
                                            const int* kinds, int npair,
                                            const int* donacc = nullptr,
                                            int nsp = 0) {
    int* s_kind = reinterpret_cast<int*>(s_tab + npair * 8);
    for (int k = threadIdx.x; k < npair * 8; k += blockDim.x)
        s_tab[k] = params[k];
    for (int k = threadIdx.x; k < npair; k += blockDim.x)
        s_kind[k] = kinds[k];
    if (donacc != nullptr)
        for (int k = threadIdx.x; k < nsp; k += blockDim.x)
            s_kind[npair + k] = donacc[k];
}

// Shared-memory bytes of load_tables (with the donor/acceptor bits).
inline size_t table_bytes(int nsp, bool donacc) {
    return (static_cast<size_t>(nsp) * nsp * 9 + (donacc ? nsp : 0))
           * sizeof(float);
}

// rintf(t), ties to even, for |t| < 2^22, on the FP32 pipe: adding 1.5 *
// 2^23 rounds t to an integer (the sum's ulp is 1), subtracting it again
// is exact.  Equal to rintf there but for the sign of a zero result,
// which r2 cannot see.  rintf compiles to FRND, which issues with the
// conversions at a fraction of the FP32 add rate, and the kernels round
// three times a slot pair.  Positions are wrapped into the box, so |t|
// stays below 2.
__device__ __forceinline__ float rint_fp32(float t) {
    return __fsub_rn(__fadd_rn(t, 12582912.0f), 12582912.0f);
}

// Min-image r2 (nvcc may contract), with rint_fp32; the displacement is
// wrapped in place.
__device__ __forceinline__ float min_image_r2(const PairConsts& c,
                                              float& dx, float& dy,
                                              float& dz) {
    dx = dx - c.bx * rint_fp32(dx * c.ibx);
    dy = dy - c.by * rint_fp32(dy * c.iby);
    dz = dz - c.bz * rint_fp32(dz * c.ibz);
    return dx * dx + dy * dy + dz * dz;
}

// Min-image r2 with every operation rounded on its own (no contraction),
// in the plain version's order; the displacement is wrapped in place.
__device__ __forceinline__ float min_image_r2_rn(const PairConsts& c,
                                                 float& dx, float& dy,
                                                 float& dz) {
    dx = __fsub_rn(dx, __fmul_rn(c.bx, rint_fp32(__fmul_rn(dx, c.ibx))));
    dy = __fsub_rn(dy, __fmul_rn(c.by, rint_fp32(__fmul_rn(dy, c.iby))));
    dz = __fsub_rn(dz, __fmul_rn(c.bz, rint_fp32(__fmul_rn(dz, c.ibz))));
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// cp.async copies (sm_80+): global to shared without a register, waited
// for with cp_async_wait_all and made visible to the block by a barrier.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The warp sub-tile cull of the pair kernels over slot layouts (sparse.cu,
// allpairs_rect.cu; ops/allpairs.py::cull_keep repeats it in torch).  A
// warp owns SUB consecutive i slots and takes the box of its filled ones;
// a j sub-tile of SUB slots whose box over its filled slots lies farther
// than the cutoff plus CULL_SLACK of the longest box side is skipped.  The
// gap is the periodic min-image distance of the box centres less both
// half-widths, every operation rounded on its own: a lower bound on every
// pair's distance, so no pair in range is skipped; the slack (~40 ulps of
// the box side) covers the f32 rounding of the pair's own r2.

constexpr unsigned FULL = 0xffffffffu;
constexpr int SUB = 32;                              // slots of a sub-tile
constexpr float CULL_SLACK = 3.814697265625e-06f;    // 2^-18

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// A box's centre and half-width along one axis, from its lo and hi.
__device__ __forceinline__ void centre(float lo, float hi, float& c,
                                       float& h) {
    c = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    h = __fmul_rn(__fsub_rn(hi, lo), 0.5f);
}

// Periodic min-image gap of two boxes along one axis
// (ops/sparse.py::_tile_worklist), every operation rounded on its own.
__device__ __forceinline__ float axis_gap(float ci, float cj, float hi,
                                          float hj, float b, float ib) {
    float d = __fsub_rn(ci, cj);
    d = __fsub_rn(d, __fmul_rn(b, rint_fp32(__fmul_rn(d, ib))));
    return fmaxf(__fsub_rn(__fsub_rn(fabsf(d), hi), hj), 0.0f);
}

// A warp's own i box: centre and half-width per axis.
struct Box {
    float cx, cy, cz, hx, hy, hz;
};

// The box of the warp's filled slots; every lane passes its own slot.
__device__ __forceinline__ Box warp_box(bool filled, float x, float y,
                                        float z) {
    Box w;
    centre(warp_min(filled ? x : INFINITY), warp_max(filled ? x : -INFINITY),
           w.cx, w.hx);
    centre(warp_min(filled ? y : INFINITY), warp_max(filled ? y : -INFINITY),
           w.cy, w.hy);
    centre(warp_min(filled ? z : INFINITY), warp_max(filled ? z : -INFINITY),
           w.cz, w.hz);
    return w;
}

// The squared cull radius: (sqrt(r2_max) + CULL_SLACK * longest side)^2.
__device__ __forceinline__ float cull_r2(const PairConsts& c) {
    const float rc = __fadd_rn(
        sqrtf(c.r2_max),
        __fmul_rn(CULL_SLACK, fmaxf(c.bx, fmaxf(c.by, c.bz))));
    return __fmul_rn(rc, rc);
}

// Whether the box [lo, hi] (empty when lx > ux) lies within the cull
// radius of the warp's box `w`.
__device__ __forceinline__ bool box_near(const Box& w, float lx, float ly,
                                         float lz, float ux, float uy,
                                         float uz, const PairConsts& c,
                                         float r2c) {
    float cx, cy, cz, hx, hy, hz;
    centre(lx, ux, cx, hx);
    centre(ly, uy, cy, hy);
    centre(lz, uz, cz, hz);
    const float gx = axis_gap(w.cx, cx, w.hx, hx, c.bx, c.ibx);
    const float gy = axis_gap(w.cy, cy, w.hy, hy, c.by, c.iby);
    const float gz = axis_gap(w.cz, cz, w.hz, hz, c.bz, c.ibz);
    const float gap2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx),
                                           __fmul_rn(gy, gy)),
                                 __fmul_rn(gz, gz));
    return lx <= ux && gap2 <= r2c;
}

// A running candidate minimum: the least (r2, key) seen so far.
struct CandMin {
    float r2 = INFINITY;
    long long key = 0x7fffffffffffffffLL;
};

__device__ __forceinline__ void cand_update(CandMin& m, float r2,
                                            long long key) {
    if (r2 < m.r2 || (r2 == m.r2 && key < m.key)) {
        m.r2 = r2;
        m.key = key;
    }
}

// The force over r (clipped to +-MX_FRC) and the half energies of one
// ordered pair in range (r2 <= r2_max), from the species pair's parameter
// row `p` (p0..p4, kqq, r2cut) and VdW kind.
struct PairTerms {
    float fsum, ev, ec;
};

__device__ __forceinline__ PairTerms pair_terms(const PairConsts& c,
                                                const float* p, int kind,
                                                float r2, float rai,
                                                float raj) {
    const float ri = rsqrtf(r2);
    const float r2i = ri * ri;
    const float rr = r2 * ri;
    PairTerms t{0.0f, 0.0f, 0.0f};
    if (kind != 0 && r2 <= p[6]) {
        float f, e;
        vdw_pair(kind, r2i, ri, rr, p, rai, raj, f, e);
        t.fsum += f;
        t.ev = 0.5f * e;
    }
    if (c.elec_type != 0) {
        float f, e;
        coul_pair(c, r2i, ri, rr, p[5], f, e);
        t.fsum += f;
        t.ec = 0.5f * e;
    }
    // clip that keeps a NaN a NaN, like jnp.clip
    t.fsum = t.fsum > MX_FRC ? MX_FRC
                             : (t.fsum < -MX_FRC ? -MX_FRC : t.fsum);
    return t;
}

// pair_terms of species (ti, tj), from the tables load_tables staged.
__device__ __forceinline__ PairTerms pair_terms(const PairConsts& c,
                                                const float* s_tab, int ti,
                                                int tj, float r2, float rai,
                                                float raj) {
    const int* s_kind = reinterpret_cast<const int*>(
        s_tab + c.nsp * c.nsp * 8);
    const int row = ti * c.nsp + tj;
    return pair_terms(c, s_tab + row * 8, s_kind[row], r2, rai, raj);
}

// Adds a pair's force along its min-image displacement to (fx, fy, fz)
// and its half energies to ev, ec.
__device__ __forceinline__ void pair_add(const PairTerms& t, float dx,
                                         float dy, float dz, float& fx,
                                         float& fy, float& fz, float& ev,
                                         float& ec) {
    fx += t.fsum * dx;
    fy += t.fsum * dy;
    fz += t.fsum * dz;
    ev += t.ev;
    ec += t.ec;
}

// One ordered pair in range (r2 <= r2_max) with its min-image
// displacement: adds its force to (fx, fy, fz) and half its energies to
// ev, ec.
__device__ __forceinline__ void pair_physics(
        const PairConsts& c, const float* s_tab, float r2, float dx,
        float dy, float dz, int ti, int tj, float rai, float raj,
        float& fx, float& fy, float& fz, float& ev, float& ec) {
    pair_add(pair_terms(c, s_tab, ti, tj, r2, rai, raj), dx, dy, dz, fx, fy,
             fz, ev, ec);
}

// Bind/jump candidate test of one ordered pair in range, r2 from
// min_image_r2_rn (pallas_pair.py::_tile_physics): a bind candidate is
// within the species pair's bind r2 (parameter column 7, 0 for pairs that
// do not bond) and, with parents, neither atom is the other's parent; a
// jump candidate is within r2_elec, a donor row's acceptor (m[1]) or an
// acceptor row's donor (m[2]).  `di`, `dj` are the rows' donor/acceptor
// bits.
template <bool BIND, bool JUMP, bool PAR>
__device__ __forceinline__ void cand_pair(
        const float* s_tab, int nsp, float r2, long long key, int ti,
        int tj, int di, int dj, int gi, int gj, int pi, int pj,
        float r2_elec, CandMin* m) {
    if (BIND) {
        if (r2 <= s_tab[(ti * nsp + tj) * 8 + 7]
                && (!PAR || (pi != gj && pj != gi)))
            cand_update(m[0], r2, key);
    }
    if (JUMP) {
        if (r2 <= r2_elec) {
            if ((di & 1) && (dj & 2)) cand_update(m[1], r2, key);
            if ((di & 2) && (dj & 1)) cand_update(m[2], r2, key);
        }
    }
}

// Writes the three minima of slot `o` of a (3, n_split, n_rows) output.
__device__ __forceinline__ void cand_store(const CandMin* m, float* r2,
                                           long long* key, size_t o,
                                           size_t plane) {
    for (int q = 0; q < 3; ++q) {
        r2[q * plane + o] = m[q].r2;
        key[q * plane + o] = m[q].key;
    }
}

}  // namespace aztotmd
