// Dense O(N^2) pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::_allpairs_kernel (driver
// pair_forces_allpairs, tile body _tile_physics/_vdw_pair/_coul_pair/_erfc),
// non-reactive branch: no bind/jump candidate outputs.  The per-pair
// physics is pair_physics.cuh, shared with sparse.cu; this kernel visits
// every ordered pair (i, j), i != j, j < n.
//
// Design: one thread per i atom holds its accumulators in registers; the
// block stages j tiles of x/y/z/type/radius in shared memory and loops
// over them.  Accumulation is one-sided (every ordered pair is visited
// from its i side), so there are no atomics.  The j range is split over
// gridDim.y blocks so that a 4k-atom system fills the card's 132 SMs;
// each split writes its own partial rows and the caller sums the
// n_split partials.  The per-species-pair kind and parameters come from
// a small table in shared memory, read at run time.
//
// Bound on the H100: FP32 and SFU issue over N^2 pairs (an rsqrt per
// pair, an exp for the exponential families and Ewald/Fennel) and the
// per-pair dispatch on the kind; device memory traffic is O(N) per
// pass.  This first version is plain: no cp.async/TMA staging, no
// symmetric half pass, no specialization of the dispatch.

#include "pair_physics.cuh"

namespace {

constexpr int TILE = 128;

struct Args {
    const float* pos;      // (n, 3)
    const int* types;      // (n,)
    const float* radii;    // (n,) or null
    const float* params;   // (nsp*nsp, 8): p0..p4, kqq, r2cut, unused
    const int* kinds;      // (nsp*nsp,)
    float* frc;            // (n_split, n, 3) partial forces
    float* ev;             // (n_split, n) partial VdW energies
    float* ec;             // (n_split, n) partial Coulomb energies
    int n, n_split;
    aztotmd::PairConsts c;
};

__global__ void __launch_bounds__(TILE) allpairs_kernel(const Args a) {
    extern __shared__ float s_tab[];          // params then kinds
    __shared__ float s_x[TILE], s_y[TILE], s_z[TILE], s_r[TILE];
    __shared__ int s_t[TILE];

    aztotmd::load_tables(s_tab, a.params, a.kinds, a.c.nsp * a.c.nsp);

    const int n = a.n;
    const int i = blockIdx.x * TILE + threadIdx.x;
    const bool active = i < n;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f, rai = 1.0f;
    int ti = 0;
    if (active) {
        xi = a.pos[3 * i];
        yi = a.pos[3 * i + 1];
        zi = a.pos[3 * i + 2];
        ti = a.types[i];
        if (a.c.use_radii) rai = a.radii[i];
    }

    const int n_tiles = (n + TILE - 1) / TILE;
    const int per = (n_tiles + a.n_split - 1) / a.n_split;
    const int t_begin = blockIdx.y * per;
    const int t_end = min(n_tiles, t_begin + per);

    float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
    for (int t = t_begin; t < t_end; ++t) {
        __syncthreads();                      // tables ready / tile consumed
        const int jl = t * TILE + threadIdx.x;
        if (jl < n) {
            s_x[threadIdx.x] = a.pos[3 * jl];
            s_y[threadIdx.x] = a.pos[3 * jl + 1];
            s_z[threadIdx.x] = a.pos[3 * jl + 2];
            s_t[threadIdx.x] = a.types[jl];
            s_r[threadIdx.x] = a.c.use_radii ? a.radii[jl] : 1.0f;
        }
        __syncthreads();
        if (!active) continue;
        const int jn = min(TILE, n - t * TILE);
        for (int k = 0; k < jn; ++k) {
            if (t * TILE + k == i) continue;  // self pair by global slot
            aztotmd::pair_accumulate(a.c, s_tab, xi - s_x[k], yi - s_y[k],
                                     zi - s_z[k], ti, s_t[k], rai, s_r[k],
                                     fx, fy, fz, ev, ec);
        }
    }
    if (active) {
        const size_t o = static_cast<size_t>(blockIdx.y) * n + i;
        a.frc[3 * o] = fx;
        a.frc[3 * o + 1] = fy;
        a.frc[3 * o + 2] = fz;
        a.ev[o] = ev;
        a.ec[o] = ec;
    }
}

}  // namespace

// Launches the pass on `stream`; returns cudaGetLastError() of the launch.
extern "C" int aztotmd_allpairs_f32(
    const float* pos, const int* types, const float* radii,
    const float* params, const int* kinds, int nsp, int n, int n_split,
    int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, void* stream) {
    Args a{pos, types, radii, params, kinds, frc, ev, ec, n, n_split,
           {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
            r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    const dim3 grid((n + TILE - 1) / TILE, n_split);
    const size_t smem = static_cast<size_t>(nsp) * nsp * 9 * sizeof(float);
    allpairs_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// Tile width the kernel was compiled with (the wrapper sizes n_split by it).
extern "C" int aztotmd_allpairs_tile() { return TILE; }
