// Dense O(N^2) pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::_allpairs_kernel (driver
// pair_forces_allpairs, tile body _tile_physics/_vdw_pair/_coul_pair/_erfc),
// both branches: the plain pass (K1) and the pass with the fused bind/jump
// candidate minima (K1-cand).  The per-pair physics is pair_physics.cuh,
// shared with sparse.cu; this kernel visits every ordered pair (i, j),
// i != j, j < n.
//
// Bound on the H100: FP32 issue over the N^2 slot pairs (displacement,
// min-image, r2 and the cutoff test) and the physics of the pairs in range
// (an rsqrt each, an exp for the exponential families and Ewald/Fennel,
// a dispatch on the species pair's kind); device memory traffic is O(N)
// per pass.  The design:
//
// - The card is full.  One thread per i atom, BLOCK i atoms a block; the
//   j range is split over gridDim.y.  The wrapper sizes the splits from
//   the device's SM count for at least 8 blocks an SM where the pairs
//   allow, down to ranges of 32 j atoms (ops/allpairs.py::allpairs_split):
//   a 4,000-atom deck runs 32 x 33 blocks, the 352- and 512-atom candidate
//   decks 33 and 64.  Each split writes its own partial rows and the
//   wrapper sums them: no atomics.
// - Staging.  A block copies its whole j range once with cp.async, repacked
//   in shared memory as float4 (x, y, z, radius) plus the types (and
//   parents), behind one barrier: one 16-byte broadcast load brings a j
//   atom's position.  The range is at most J_MAX atoms (dynamic shared
//   memory, raised above 48 KB when needed).
// - Independent work.  Each thread tests its i atom against 32 j atoms at
//   a time, eight independent r2 chains in flight, and sets one bit per j
//   in range; it then walks its set bits in j order, recomputes that
//   pair's displacement and runs the physics.  The warp runs the physics
//   as often as its busiest lane has pairs in range among the 32, not
//   once for every j that any lane has in range (on the clustered Surkov
//   deck 7% of the pairs are in range, so most j are).  The self pair
//   (r2 = 0, always in range) is dropped inside that branch, off the
//   per-pair path.  The per-i sum stays in ascending j.
// - The min-image rounds on the FP32 pipe (pair_physics.cuh::rint_fp32).
//
// Candidates: the kernel is a template on <BIND, JUMP, PAR>; <false, false,
// false> is K1, the others keep up to three running minima (bind, jump
// donor row, jump acceptor row) of (r2, key) in registers, where key =
// ((j / cand_tile) * nsp + type_j) * n + j orders ties as the TPU kernel
// does (earliest tile of cand_tile atoms, then lowest species, then
// lowest id).  Each split writes its minima once and the wrapper merges
// the splits on (r2, key), which is exact.  Candidate r2 is rounded
// operation by operation (min_image_r2_rn) so that it equals the plain
// version's bit for bit, and the forces of that instantiation use it too.
// Not done, and why: tensor cores (the work is a min-image with rounding,
// compares and a dispatch on the species pair, not a matrix product, and
// |a|^2 + |b|^2 - 2a.b cancels in f32); the symmetric half pass (the
// candidate minima are per row, and j-side forces would need float
// atomics, whose order changes from run to run).

#include "pair_physics.cuh"

namespace {

constexpr int BLOCK = 128;         // i atoms (threads) a block
constexpr int J_MAX = 4096;        // j atoms a split may stage
constexpr int CHUNK = 32;          // j atoms tested before the physics

struct Args {
    const float* pos;      // (n, 3)
    const int* types;      // (n,)
    const float* radii;    // (n,) or null
    const float* params;   // (nsp*nsp, 8): p0..p4, kqq, r2cut, bind r2
    const int* kinds;      // (nsp*nsp,)
    float* frc;            // (n_split, n, 3) partial forces
    float* ev;             // (n_split, n) partial VdW energies
    float* ec;             // (n_split, n) partial Coulomb energies
    int n, n_split;
    aztotmd::PairConsts c;
};

struct CandArgs {
    const int* donacc;     // (nsp,) bit 0 donor, bit 1 acceptor
    const int* parents;    // (n,) or null
    int cand_tile;         // tie-order tile width
    float r2_elec;
    float* r2;             // (3, n_split, n) partial minima
    long long* key;        // (3, n_split, n)
};

// j atoms of one split
__host__ __device__ inline int split_range(int n, int n_split) {
    return (n + n_split - 1) / n_split;
}

// Dynamic shared-memory bytes of a block staging `per` j atoms.
inline size_t smem_bytes(int per, int nsp, bool cand, bool par) {
    return static_cast<size_t>(per) * (sizeof(float4) + sizeof(int)
                                       * (par ? 2 : 1))
           + aztotmd::table_bytes(nsp, cand);
}

template <bool BIND, bool JUMP, bool PAR>
__global__ void __launch_bounds__(BLOCK) allpairs_kernel(const Args a,
                                                         const CandArgs ca) {
    constexpr bool CAND = BIND || JUMP;
    // j range as float4 (x, y, z, radius), types, parents, then the tables
    extern __shared__ float4 s_p[];
    const int n = a.n;
    const int per = split_range(n, a.n_split);
    const int j0 = blockIdx.y * per;
    const int cnt = max(0, min(n - j0, per));
    int* s_t = reinterpret_cast<int*>(s_p + per);
    int* s_par = s_t + per;
    float* s_tab = reinterpret_cast<float*>(s_t + (PAR ? 2 : 1) * per);

    for (int k = threadIdx.x; k < cnt; k += BLOCK) {
        const int j = j0 + k;
        aztotmd::cp_async4(&s_p[k].x, a.pos + 3 * j);
        aztotmd::cp_async4(&s_p[k].y, a.pos + 3 * j + 1);
        aztotmd::cp_async4(&s_p[k].z, a.pos + 3 * j + 2);
        if (a.c.use_radii)
            aztotmd::cp_async4(&s_p[k].w, a.radii + j);
        else
            s_p[k].w = 1.0f;
        aztotmd::cp_async4(s_t + k, a.types + j);
        if (PAR) aztotmd::cp_async4(s_par + k, ca.parents + j);
    }
    aztotmd::cp_async_commit();
    const int nsp = a.c.nsp;
    aztotmd::load_tables(s_tab, a.params, a.kinds, nsp * nsp,
                         CAND ? ca.donacc : nullptr, nsp);
    const int* s_donacc = reinterpret_cast<const int*>(s_tab) + nsp * nsp * 9;

    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const bool active = i < n;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f, rai = 1.0f;
    int ti = 0, pi = -1;
    if (active) {
        xi = a.pos[3 * i];
        yi = a.pos[3 * i + 1];
        zi = a.pos[3 * i + 2];
        ti = a.types[i];
        if (a.c.use_radii) rai = a.radii[i];
        if (PAR) pi = ca.parents[i];
    }
    aztotmd::cp_async_wait_all();
    __syncthreads();
    if (!active) return;

    const int di = CAND ? s_donacc[ti] : 0;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
    aztotmd::CandMin m[3];
    for (int k0 = 0; k0 < cnt; k0 += CHUNK) {
        const int kn = min(CHUNK, cnt - k0);
        // one bit per j of the chunk in range
        unsigned near = 0;
#pragma unroll 8
        for (int u = 0; u < kn; ++u) {
            const float4 p = s_p[k0 + u];
            float dx = xi - p.x, dy = yi - p.y, dz = zi - p.z;
            const float r2 = CAND ? aztotmd::min_image_r2_rn(a.c, dx, dy, dz)
                                  : aztotmd::min_image_r2(a.c, dx, dy, dz);
            near |= static_cast<unsigned>(r2 <= a.c.r2_max) << u;
        }
        while (near) {
            const int k = k0 + __ffs(near) - 1;
            near &= near - 1;
            const int j = j0 + k;
            if (j == i) continue;                 // the self pair
            const float4 p = s_p[k];
            float dx = xi - p.x, dy = yi - p.y, dz = zi - p.z;
            const float r2 = CAND ? aztotmd::min_image_r2_rn(a.c, dx, dy, dz)
                                  : aztotmd::min_image_r2(a.c, dx, dy, dz);
            if (!(r2 <= a.c.r2_max)) continue;
            const int tj = s_t[k];
            aztotmd::pair_physics(a.c, s_tab, r2, dx, dy, dz, ti, tj, rai,
                                  p.w, fx, fy, fz, ev, ec);
            if (CAND) {
                const long long key =
                    static_cast<long long>((j / ca.cand_tile) * nsp + tj) * n
                    + j;
                aztotmd::cand_pair<BIND, JUMP, PAR>(
                    s_tab, nsp, r2, key, ti, tj, di, s_donacc[tj], i, j, pi,
                    PAR ? s_par[k] : -1, ca.r2_elec, m);
            }
        }
    }
    const size_t o = static_cast<size_t>(blockIdx.y) * n + i;
    a.frc[3 * o] = fx;
    a.frc[3 * o + 1] = fy;
    a.frc[3 * o + 2] = fz;
    a.ev[o] = ev;
    a.ec[o] = ec;
    if (CAND)
        aztotmd::cand_store(m, ca.r2, ca.key, o,
                            static_cast<size_t>(a.n_split) * n);
}

template <bool BIND, bool JUMP, bool PAR>
int launch(const Args& a, const CandArgs& ca, cudaStream_t stream) {
    const int per = split_range(a.n, a.n_split);
    if (per > J_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(per, a.c.nsp, BIND || JUMP, PAR);
    auto kernel = allpairs_kernel<BIND, JUMP, PAR>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((a.n + BLOCK - 1) / BLOCK, a.n_split);
    kernel<<<grid, BLOCK, smem, stream>>>(a, ca);
    return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* pos, const int* types, const float* radii,
               const float* params, const int* kinds, int nsp, int n,
               int n_split, int use_radii, int elec_type, float bx, float by,
               float bz, float ibx, float iby, float ibz, float r2_max,
               float alpha, float daipi2, float fennel_c1, float fennel_c2,
               float r_real, float* frc, float* ev, float* ec) {
    return Args{pos, types, radii, params, kinds, frc, ev, ec, n, n_split,
                {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                 r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
}

}  // namespace

// Launches the pass without candidates (K1) on `stream`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue when a split
// holds more than J_MAX j atoms.
extern "C" int aztotmd_allpairs_f32(
    const float* pos, const int* types, const float* radii,
    const float* params, const int* kinds, int nsp, int n, int n_split,
    int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, void* stream) {
    const Args a = make_args(pos, types, radii, params, kinds, nsp, n,
                             n_split, use_radii, elec_type, bx, by, bz, ibx,
                             iby, ibz, r2_max, alpha, daipi2, fennel_c1,
                             fennel_c2, r_real, frc, ev, ec);
    return launch<false, false, false>(a, CandArgs{},
                                       static_cast<cudaStream_t>(stream));
}

// Launches the pass with the bind (want_bind) and/or jump (want_jump)
// candidate minima (K1-cand); parents are read when use_par is set.
extern "C" int aztotmd_allpairs_cand_f32(
    const float* pos, const int* types, const float* radii,
    const float* params, const int* kinds, int nsp, int n, int n_split,
    int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec,
    const int* donacc, const int* parents, int want_bind, int want_jump,
    int use_par, int cand_tile, float r2_elec, float* cand_r2,
    long long* cand_key, void* stream) {
    const Args a = make_args(pos, types, radii, params, kinds, nsp, n,
                             n_split, use_radii, elec_type, bx, by, bz, ibx,
                             iby, ibz, r2_max, alpha, daipi2, fennel_c1,
                             fennel_c2, r_real, frc, ev, ec);
    const CandArgs ca{donacc, parents, cand_tile, r2_elec, cand_r2, cand_key};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (use_par && !want_bind) return static_cast<int>(cudaErrorInvalidValue);
    if (want_bind && want_jump)
        return use_par ? launch<true, true, true>(a, ca, s)
                       : launch<true, true, false>(a, ca, s);
    if (want_bind)
        return use_par ? launch<true, false, true>(a, ca, s)
                       : launch<true, false, false>(a, ca, s);
    if (want_jump) return launch<false, true, false>(a, ca, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// i atoms a block (the wrapper sizes n_split by it).
extern "C" int aztotmd_allpairs_tile() { return BLOCK; }

// Most j atoms one split may stage.
extern "C" int aztotmd_allpairs_max_range() { return J_MAX; }

// Dynamic shared-memory bytes of a launch (logged by chip_smoke.py).
extern "C" long long aztotmd_allpairs_smem_bytes(int n, int n_split, int nsp,
                                                 int cand, int par) {
    return static_cast<long long>(smem_bytes(split_range(n, n_split), nsp,
                                             cand != 0, par != 0));
}
