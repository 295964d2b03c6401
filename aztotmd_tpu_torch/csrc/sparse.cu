// Morton block-sparse pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_sparse.py::_sparse_kernel (driver
// pair_forces_sparse, tile body pallas_pair.py::_tile_physics), both
// branches: the plain pass (K4) and the pass with the fused bind/jump
// candidate minima (K4-cand).  The per-pair physics is pair_physics.cuh,
// shared with allpairs.cu.
//
// Inputs: the Morton-sorted atoms in n_t tiles of T slots (SoA x, y, z,
// global id, type, radius; padding slots carry gid -1, position 0 and
// radius 1), and the AABB worklist of interacting ordered tile pairs in
// CSR form: the j tiles of i tile t are jt[row_ptr[t] .. row_ptr[t+1]).
// The wrapper (ops/sparse.py) builds both without a host synchronisation.
//
// Bound on the H100: FP32 issue over the filled slot pairs of the
// sub-tile pairs the cull below keeps (the slot pairs that must be
// tested) and the physics of the pairs in range (an rsqrt each); device
// memory moves O(n_need * T) bytes of staged tiles.  Of the n_need * T^2
// slot pairs the worklist names, fewer than 1% are in range on clustered
// decks: a 256-slot tile's box is coarse.  The design:
//
// - The card is full.  Grid (n_t, n_split), one thread per i slot
//   (blockDim is T rounded up to a warp).  The wrapper sizes n_split from
//   the device's SM count for at least 8 blocks an SM
//   (ops/sparse.py::sparse_split).  Block (t, y) walks entries y,
//   y + n_split, ... of row t; a block with no entry at its offset writes
//   zero rows and leaves, as does an i tile whose row is empty (never
//   visited, or cut off by a truncated worklist).
// - Warp sub-tile cull.  Each warp owns 32 Morton-consecutive i slots, a
//   compact sub-tile.  It takes the box of its filled slots once (warp
//   reductions), and for each staged j tile the boxes of the tile's
//   32-slot sub-tiles from filled slots only (each lane a quarter of one
//   sub-tile, then two shuffles: no second barrier).  A j sub-tile whose
//   periodic min-image box gap to the warp's box exceeds the cutoff plus
//   CULL_SLACK of the longest box side (~40 ulps of it) is skipped, a
//   warp-uniform branch.  The gap is _tile_worklist's formula rounded
//   operation by operation; ops/sparse.py::subtile_keep repeats it in
//   torch.  Every pair skipped lies out of range, and the kept pairs are
//   summed in slot order as before, so the forces and candidate minima
//   are the unculled pass's.  aztotmd_sparse_kept_f32 records, for
//   tests and measurement, which sub-tile pairs the warps kept: the same
//   template with REC set, so the pair passes compile without the record.
// - Divergence.  A kept sub-tile is tested 32 slots at a time: eight
//   independent r2 chains set one bit per slot in range, then each lane
//   walks its set bits in slot order, recomputes that pair's displacement
//   and runs the physics.  The warp runs the physics as often as its
//   busiest lane has pairs, not once per slot any lane has one.
// - Staging.  The j tiles (x, y, z, gid, type, radius, and parents with
//   PAR) are double-buffered in shared memory and copied with cp.async in
//   16-byte chunks (4-byte copies when T is not a multiple of 4): the
//   next entry's tile is in flight while the current one is computed, one
//   barrier a tile.
// Forces and both energies accumulate in registers and each (split,
// slot) is written once: no atomics, nothing carried between blocks; the
// wrapper sums the n_split partial rows.
//
// Candidates: as in allpairs.cu, a template on <BIND, JUMP, PAR> keeps up
// to three running (r2, key) minima per thread.  The TPU kernel visits the
// entries of a row in worklist order (ascending j tile) and breaks ties
// inside a tile by species, then global id, so key = (jt * nsp + type_j) *
// n_atoms + gid_j; each split writes its minima once per slot and the
// wrapper merges the splits on (r2, key), which gives the TPU kernel's
// choice exactly even though the Morton-permuted ids are not in order.
// Parents ride in the sorted table beside the ids.

#include "pair_physics.cuh"

namespace {

constexpr int MAX_T = 256;
using aztotmd::Box;
using aztotmd::FULL;
using aztotmd::SUB;

struct Args {
    const float* x;        // (n_t * T,) sorted positions
    const float* y;
    const float* z;
    const int* gid;        // (n_t * T,) global atom id, -1 on padding
    const int* types;      // (n_t * T,)
    const float* radii;    // (n_t * T,), 1 where unused
    const int* row_ptr;    // (n_t + 1,) CSR offsets into jt
    const int* jt;         // (pair_cap,) j tile of each worklist entry
    const float* params;   // (nsp*nsp, 8): p0..p4, kqq, r2cut, bind r2
    const int* kinds;      // (nsp*nsp,)
    float* frc;            // (n_split, n_t * T, 3) partial forces
    float* ev;             // (n_split, n_t * T) partial VdW energies
    float* ec;             // (n_split, n_t * T) partial Coulomb energies
    int n_t, T, n_split;
    aztotmd::PairConsts c;
    unsigned long long* kept = nullptr;   // (pair_cap,) cull record (REC)
};

struct CandArgs {
    const int* donacc;     // (nsp,) bit 0 donor, bit 1 acceptor
    const int* parents;    // (n_t * T,) sorted parents, or null
    int n_atoms;
    float r2_elec;
    float* r2;             // (3, n_split, n_t * T) partial minima
    long long* key;        // (3, n_split, n_t * T)
};

// One staged j tile (16-byte aligned for cp.async).
template <bool PAR>
struct __align__(16) JTile {
    float x[MAX_T], y[MAX_T], z[MAX_T], r[MAX_T];
    int g[MAX_T], t[MAX_T];
    int p[PAR ? MAX_T : 1];
};

// Column `col` of the sorted table and of the staged tile.
template <bool PAR>
__device__ __forceinline__ void column(const Args& a, const int* parents,
                                       JTile<PAR>& s, int col,
                                       const void*& src, void*& dst) {
    switch (col) {
    case 0: src = a.x; dst = s.x; break;
    case 1: src = a.y; dst = s.y; break;
    case 2: src = a.z; dst = s.z; break;
    case 3: src = a.radii; dst = s.r; break;
    case 4: src = a.gid; dst = s.g; break;
    case 5: src = a.types; dst = s.t; break;
    default: src = parents; dst = s.p; break;
    }
}

// Starts the copy of j tile `jt` into `s` (one cp.async group).
template <bool PAR>
__device__ __forceinline__ void stage(const Args& a, const int* parents,
                                      JTile<PAR>& s, int jt) {
    constexpr int NCOL = PAR ? 7 : 6;
    const int T = a.T;
    const size_t base = static_cast<size_t>(jt) * T;
    const void* src;
    void* dst;
    if ((T & 3) == 0) {
        const int nq = T >> 2;
        for (int q = threadIdx.x; q < NCOL * nq; q += blockDim.x) {
            const int col = q / nq, k = (q - col * nq) * 4;
            column<PAR>(a, parents, s, col, src, dst);
            aztotmd::cp_async16(static_cast<float*>(dst) + k,
                                static_cast<const float*>(src) + base + k);
        }
    } else {
        for (int q = threadIdx.x; q < NCOL * T; q += blockDim.x) {
            const int col = q / T, k = q - col * T;
            column<PAR>(a, parents, s, col, src, dst);
            aztotmd::cp_async4(static_cast<float*>(dst) + k,
                               static_cast<const float*>(src) + base + k);
        }
    }
    aztotmd::cp_async_commit();
}

// Bit s set: j sub-tile s of `s` holds a filled slot and its box lies
// within sqrt(r2c) of the warp's box `w`.  Lane l takes the quarter
// l >> 3 of sub-tile l & 7; the slot order is rotated by the sub-tile so
// the 32 lanes read 32 banks.
template <bool PAR>
__device__ __forceinline__ unsigned cull_mask(const JTile<PAR>& s, int T,
                                              const Box& w,
                                              const aztotmd::PairConsts& c,
                                              float r2c) {
    const int lane = threadIdx.x & 31, sub = lane & 7;
    const int k0 = sub * SUB + (lane >> 3) * 8;
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float ux = -INFINITY, uy = -INFINITY, uz = -INFINITY;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int k = k0 + ((u + sub) & 7);
        if (k < T && s.g[k] >= 0) {
            lx = fminf(lx, s.x[k]);
            ly = fminf(ly, s.y[k]);
            lz = fminf(lz, s.z[k]);
            ux = fmaxf(ux, s.x[k]);
            uy = fmaxf(uy, s.y[k]);
            uz = fmaxf(uz, s.z[k]);
        }
    }
    for (int o = 8; o < 32; o <<= 1) {
        lx = fminf(lx, __shfl_xor_sync(FULL, lx, o));
        ly = fminf(ly, __shfl_xor_sync(FULL, ly, o));
        lz = fminf(lz, __shfl_xor_sync(FULL, lz, o));
        ux = fmaxf(ux, __shfl_xor_sync(FULL, ux, o));
        uy = fmaxf(uy, __shfl_xor_sync(FULL, uy, o));
        uz = fmaxf(uz, __shfl_xor_sync(FULL, uz, o));
    }
    const bool keep = lane < 8
                      && aztotmd::box_near(w, lx, ly, lz, ux, uy, uz, c, r2c);
    return __ballot_sync(FULL, keep);
}

template <bool BIND, bool JUMP, bool PAR, bool REC = false>
__global__ void __launch_bounds__(MAX_T) sparse_kernel(const Args a,
                                                       const CandArgs ca) {
    constexpr bool CAND = BIND || JUMP;
    extern __shared__ float s_tab[];          // params, kinds, donacc
    __shared__ JTile<PAR> s_j[2];

    const int T = a.T;
    const int tile = blockIdx.x;
    const bool own = threadIdx.x < T;         // a slot of the tile
    const int slot = tile * T + threadIdx.x;
    const size_t o = static_cast<size_t>(blockIdx.y) * a.n_t * T + slot;
    const size_t plane = static_cast<size_t>(a.n_split) * a.n_t * T;
    const int e_end = a.row_ptr[tile + 1];
    int e = a.row_ptr[tile] + blockIdx.y;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
    aztotmd::CandMin m[3];
    if (e < e_end) {
        stage<PAR>(a, ca.parents, s_j[0], a.jt[e]);
        const int nsp = a.c.nsp;
        aztotmd::load_tables(s_tab, a.params, a.kinds, nsp * nsp,
                             CAND ? ca.donacc : nullptr, nsp);
        const int* s_donacc =
            reinterpret_cast<const int*>(s_tab) + nsp * nsp * 9;
        float xi = 0.0f, yi = 0.0f, zi = 0.0f, rai = 1.0f;
        int gi = -1, ti = 0, pi = -1;
        if (own) {
            xi = a.x[slot];
            yi = a.y[slot];
            zi = a.z[slot];
            gi = a.gid[slot];
            ti = a.types[slot];
            rai = a.radii[slot];
            if (PAR) pi = ca.parents[slot];
        }
        const bool filled = gi >= 0;
        const Box w = aztotmd::warp_box(filled, xi, yi, zi);
        const bool warp_filled = __any_sync(FULL, filled);
        const float r2c = aztotmd::cull_r2(a.c);

        for (int buf = 0; e < e_end; e += a.n_split, buf ^= 1) {
            const int jt = a.jt[e];
            aztotmd::cp_async_wait_all();
            __syncthreads();      // tile e (and the tables) visible; the
                                  // other buffer's tile consumed
            if (e + a.n_split < e_end)
                stage<PAR>(a, ca.parents, s_j[buf ^ 1],
                           a.jt[e + a.n_split]);
            const JTile<PAR>& s = s_j[buf];
            if (!warp_filled) continue;
            unsigned subs = cull_mask<PAR>(s, T, w, a.c, r2c);
            if (REC && (threadIdx.x & 31) == 0 && subs)
                atomicOr(a.kept + e, static_cast<unsigned long long>(subs)
                                         << (8 * (threadIdx.x >> 5)));
            if (!filled) continue;
            while (subs) {
                const int k0 = (__ffs(subs) - 1) * SUB;
                subs &= subs - 1;
                const int kn = min(SUB, T - k0);
                // one bit per slot of the sub-tile in range
                unsigned near = 0;
#pragma unroll 8
                for (int u = 0; u < kn; ++u) {
                    float dx = xi - s.x[k0 + u], dy = yi - s.y[k0 + u],
                          dz = zi - s.z[k0 + u];
                    const float r2 =
                        CAND ? aztotmd::min_image_r2_rn(a.c, dx, dy, dz)
                             : aztotmd::min_image_r2(a.c, dx, dy, dz);
                    near |= static_cast<unsigned>(r2 <= a.c.r2_max) << u;
                }
                while (near) {
                    const int k = k0 + __ffs(near) - 1;
                    near &= near - 1;
                    const int gj = s.g[k];
                    if (gj < 0 || gj == gi) continue;
                    float dx = xi - s.x[k], dy = yi - s.y[k],
                          dz = zi - s.z[k];
                    const float r2 =
                        CAND ? aztotmd::min_image_r2_rn(a.c, dx, dy, dz)
                             : aztotmd::min_image_r2(a.c, dx, dy, dz);
                    if (!(r2 <= a.c.r2_max)) continue;
                    const int tj = s.t[k];
                    aztotmd::pair_physics(a.c, s_tab, r2, dx, dy, dz, ti,
                                          tj, rai, s.r[k], fx, fy, fz, ev,
                                          ec);
                    if (CAND) {
                        const long long key =
                            static_cast<long long>(jt * nsp + tj)
                            * ca.n_atoms + gj;
                        aztotmd::cand_pair<BIND, JUMP, PAR>(
                            s_tab, nsp, r2, key, ti, tj, s_donacc[ti],
                            s_donacc[tj], gi, gj, pi, PAR ? s.p[k] : -1,
                            ca.r2_elec, m);
                    }
                }
            }
        }
    }
    if (!own) return;
    a.frc[3 * o] = fx;
    a.frc[3 * o + 1] = fy;
    a.frc[3 * o + 2] = fz;
    a.ev[o] = ev;
    a.ec[o] = ec;
    if (CAND) aztotmd::cand_store(m, ca.r2, ca.key, o, plane);
}

template <bool BIND, bool JUMP, bool PAR, bool REC = false>
int launch(const Args& a, const CandArgs& ca, cudaStream_t stream) {
    const dim3 grid(a.n_t, a.n_split);
    const int threads = (a.T + 31) / 32 * 32;
    const size_t smem = aztotmd::table_bytes(a.c.nsp, BIND || JUMP);
    sparse_kernel<BIND, JUMP, PAR, REC><<<grid, threads, smem, stream>>>(a,
                                                                      ca);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the pass without candidates (K4) on `stream`; returns
// cudaGetLastError() of the launch.  The sorted columns must be 16-byte
// aligned.
extern "C" int aztotmd_sparse_f32(
    const float* x, const float* y, const float* z, const int* gid,
    const int* types, const float* radii, const int* row_ptr, const int* jt,
    const float* params, const int* kinds, int nsp, int n_t, int T,
    int n_split, int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, void* stream) {
    if (T < 1 || T > MAX_T) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, y, z, gid, types, radii, row_ptr, jt, params, kinds,
                 frc, ev, ec, n_t, T, n_split,
                 {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                  r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    return launch<false, false, false>(a, CandArgs{},
                                       static_cast<cudaStream_t>(stream));
}

// Launches K4 as aztotmd_sparse_f32 does and also ORs into kept[e], for
// each worklist entry e it visits, bit 8 * w + s when warp w (the i
// sub-tile w) kept the j sub-tile s.  `kept` is (pair_cap,) and zeroed.
extern "C" int aztotmd_sparse_kept_f32(
    const float* x, const float* y, const float* z, const int* gid,
    const int* types, const float* radii, const int* row_ptr, const int* jt,
    const float* params, const int* kinds, int nsp, int n_t, int T,
    int n_split, int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, unsigned long long* kept,
    void* stream) {
    if (T < 1 || T > MAX_T) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, y, z, gid, types, radii, row_ptr, jt, params, kinds,
                 frc, ev, ec, n_t, T, n_split,
                 {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                  r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real},
                 kept};
    return launch<false, false, false, true>(
        a, CandArgs{}, static_cast<cudaStream_t>(stream));
}

// Launches the pass with the bind (want_bind) and/or jump (want_jump)
// candidate minima (K4-cand); sorted parents are read when use_par is set.
extern "C" int aztotmd_sparse_cand_f32(
    const float* x, const float* y, const float* z, const int* gid,
    const int* types, const float* radii, const int* row_ptr, const int* jt,
    const float* params, const int* kinds, int nsp, int n_t, int T,
    int n_split, int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec,
    const int* donacc, const int* parents, int want_bind, int want_jump,
    int use_par, int n_atoms, float r2_elec, float* cand_r2,
    long long* cand_key, void* stream) {
    if (T < 1 || T > MAX_T) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, y, z, gid, types, radii, row_ptr, jt, params, kinds,
                 frc, ev, ec, n_t, T, n_split,
                 {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                  r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    const CandArgs ca{donacc, parents, n_atoms, r2_elec, cand_r2, cand_key};
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
