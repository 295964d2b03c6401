// Dense O(N^2) pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::_allpairs_kernel (driver
// pair_forces_allpairs, tile body _tile_physics/_vdw_pair/_coul_pair/_erfc),
// both branches: the plain pass (K1) and the pass with the fused bind/jump
// candidate minima (K1-cand).  The per-pair physics is pair_physics.cuh,
// shared with sparse.cu; this kernel visits every ordered pair (i, j),
// i != j, j < n.
//
// Design: one thread per i atom holds its accumulators in registers; the
// block stages j tiles of x/y/z/type/radius (and parents) in shared memory
// and loops over them.  Accumulation is one-sided (every ordered pair is
// visited from its i side), so there are no atomics.  The j range is split
// over gridDim.y blocks so that a 4k-atom system fills the card's 132 SMs;
// each split writes its own partial rows and the caller sums the n_split
// partials.  The per-species-pair kind and parameters come from a small
// table in shared memory, read at run time.
//
// Candidates: the kernel is a template on <BIND, JUMP, PAR>; <false, false,
// false> is K1 as it was, the others keep up to three running minima
// (bind, jump donor row, jump acceptor row) of (r2, key) in registers,
// where key = ((j / cand_tile) * nsp + type_j) * n + j orders ties as the
// TPU kernel does (earliest tile of cand_tile atoms, then lowest species,
// then lowest id).  Each split writes its minima once and the wrapper
// merges the splits on (r2, key), which is exact.  Candidate r2 is rounded
// operation by operation (min_image_r2_rn) so that it equals the plain
// version's bit for bit, and the forces of that instantiation use it too.
//
// Bound on the H100: FP32 and SFU issue over N^2 pairs (an rsqrt per
// pair, an exp for the exponential families and Ewald/Fennel) and the
// per-pair dispatch on the kind; device memory traffic is O(N) per
// pass.  The candidate tests add a few compares per pair in range and
// cost nothing near that.  This first version is plain: no cp.async/TMA
// staging, no symmetric half pass, no specialization of the dispatch.

#include "pair_physics.cuh"

namespace {

constexpr int TILE = 128;

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

template <bool BIND, bool JUMP, bool PAR>
__global__ void __launch_bounds__(TILE) allpairs_kernel(const Args a,
                                                        const CandArgs ca) {
    constexpr bool CAND = BIND || JUMP;
    extern __shared__ float s_tab[];          // params, kinds, donacc
    __shared__ float s_x[TILE], s_y[TILE], s_z[TILE], s_r[TILE];
    __shared__ int s_t[TILE];
    __shared__ int s_p[PAR ? TILE : 1];

    const int nsp = a.c.nsp;
    aztotmd::load_tables(s_tab, a.params, a.kinds, nsp * nsp,
                         CAND ? ca.donacc : nullptr, nsp);
    const int* s_donacc = reinterpret_cast<const int*>(s_tab) + nsp * nsp * 9;

    const int n = a.n;
    const int i = blockIdx.x * TILE + threadIdx.x;
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

    const int n_tiles = (n + TILE - 1) / TILE;
    const int per = (n_tiles + a.n_split - 1) / a.n_split;
    const int t_begin = blockIdx.y * per;
    const int t_end = min(n_tiles, t_begin + per);

    float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
    aztotmd::CandMin m[3];
    for (int t = t_begin; t < t_end; ++t) {
        __syncthreads();                      // tables ready / tile consumed
        const int jl = t * TILE + threadIdx.x;
        if (jl < n) {
            s_x[threadIdx.x] = a.pos[3 * jl];
            s_y[threadIdx.x] = a.pos[3 * jl + 1];
            s_z[threadIdx.x] = a.pos[3 * jl + 2];
            s_t[threadIdx.x] = a.types[jl];
            s_r[threadIdx.x] = a.c.use_radii ? a.radii[jl] : 1.0f;
            if (PAR) s_p[threadIdx.x] = ca.parents[jl];
        }
        __syncthreads();
        if (!active) continue;
        const int jn = min(TILE, n - t * TILE);
        if (!CAND) {
            for (int k = 0; k < jn; ++k) {
                if (t * TILE + k == i) continue;  // self pair by global slot
                aztotmd::pair_accumulate(a.c, s_tab, xi - s_x[k],
                                         yi - s_y[k], zi - s_z[k], ti,
                                         s_t[k], rai, s_r[k], fx, fy, fz,
                                         ev, ec);
            }
        } else {
            const int di = s_donacc[ti];
            for (int k = 0; k < jn; ++k) {
                const int j = t * TILE + k;
                if (j == i) continue;
                float dx = xi - s_x[k], dy = yi - s_y[k], dz = zi - s_z[k];
                const float r2 = aztotmd::min_image_r2_rn(a.c, dx, dy, dz);
                if (!(r2 <= a.c.r2_max)) continue;
                const int tj = s_t[k];
                aztotmd::pair_physics(a.c, s_tab, r2, dx, dy, dz, ti, tj,
                                      rai, s_r[k], fx, fy, fz, ev, ec);
                const long long key =
                    static_cast<long long>((j / ca.cand_tile) * nsp + tj) * n
                    + j;
                aztotmd::cand_pair<BIND, JUMP, PAR>(
                    s_tab, nsp, r2, key, ti, tj, di, s_donacc[tj], i, j, pi,
                    PAR ? s_p[k] : -1, ca.r2_elec, m);
            }
        }
    }
    if (active) {
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
}

template <bool BIND, bool JUMP, bool PAR>
int launch(const Args& a, const CandArgs& ca, cudaStream_t stream) {
    const dim3 grid((a.n + TILE - 1) / TILE, a.n_split);
    const size_t smem = aztotmd::table_bytes(a.c.nsp, BIND || JUMP);
    allpairs_kernel<BIND, JUMP, PAR><<<grid, TILE, smem, stream>>>(a, ca);
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
// cudaGetLastError() of the launch.
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

// Tile width the kernel was compiled with (the wrapper sizes n_split by it).
extern "C" int aztotmd_allpairs_tile() { return TILE; }
