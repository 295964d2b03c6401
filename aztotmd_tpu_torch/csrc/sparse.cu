// Morton block-sparse pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_sparse.py::_sparse_kernel (driver
// pair_forces_sparse, tile body pallas_pair.py::_tile_physics), both
// branches: the plain pass (K4) and the pass with the fused bind/jump
// candidate minima (K4-cand).  The per-pair physics is pair_physics.cuh,
// shared with allpairs.cu.
//
// Inputs: the Morton-sorted atoms in n_t tiles of T slots (SoA x, y, z,
// global id, type, radius; padding slots carry gid -1 and radius 1), and
// the AABB worklist of interacting ordered tile pairs in CSR form: the j
// tiles of i tile t are jt[row_ptr[t] .. row_ptr[t+1]).  The wrapper
// (ops/sparse.py) builds both without a host synchronisation.
//
// Design: grid (n_t, n_split), one thread per i slot of the i tile.  The
// i atom lives in registers; block (t, y) walks entries y, y+n_split, ...
// of row t, stages each j tile (~6 KB at T = 256) in shared memory and
// computes its T pairs per thread, skipping self pairs (gi == gj) and
// padding (gid < 0).  Forces and both energies accumulate in registers
// and each (split, slot) is written once: no atomics, nothing carried
// between blocks.  An i tile whose row is empty (never visited, or cut
// off by a truncated worklist) writes zeros.  The wrapper sums the
// n_split partial rows; n_split is chosen so that n_t * n_split fills the
// 132 SMs (n_t is only 47 at N = 12,000).
//
// Candidates: as in allpairs.cu, a template on <BIND, JUMP, PAR> keeps up
// to three running (r2, key) minima per thread.  The TPU kernel visits the
// entries of a row in worklist order (ascending j tile) and breaks ties
// inside a tile by species, then global id, so key = (jt * nsp + type_j) *
// n_atoms + gid_j; each split writes its minima once per slot and the
// wrapper merges the splits on (r2, key), which gives the TPU kernel's
// choice exactly even though the Morton-permuted ids are not in order.
// Parents ride in the sorted table beside the ids.
//
// Bound on the H100: FP32 issue (and the MUFU rsqrt, one per pair in
// range) over the visited slot pairs, n_need * T^2; device memory moves
// O(n_need * T) bytes of staged tiles.  Left for later: the load
// imbalance between dense core tiles (long rows) and edge tiles, a
// symmetric half pass over the worklist, and cp.async/TMA staging of the
// next j tile while the current one is computed.

#include "pair_physics.cuh"

namespace {

constexpr int MAX_T = 256;

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
};

struct CandArgs {
    const int* donacc;     // (nsp,) bit 0 donor, bit 1 acceptor
    const int* parents;    // (n_t * T,) sorted parents, or null
    int n_atoms;
    float r2_elec;
    float* r2;             // (3, n_split, n_t * T) partial minima
    long long* key;        // (3, n_split, n_t * T)
};

template <bool BIND, bool JUMP, bool PAR>
__global__ void __launch_bounds__(MAX_T) sparse_kernel(const Args a,
                                                       const CandArgs ca) {
    constexpr bool CAND = BIND || JUMP;
    extern __shared__ float s_tab[];          // params, kinds, donacc
    __shared__ float s_x[MAX_T], s_y[MAX_T], s_z[MAX_T], s_r[MAX_T];
    __shared__ int s_g[MAX_T], s_t[MAX_T];
    __shared__ int s_p[PAR ? MAX_T : 1];

    const int nsp = a.c.nsp;
    aztotmd::load_tables(s_tab, a.params, a.kinds, nsp * nsp,
                         CAND ? ca.donacc : nullptr, nsp);
    const int* s_donacc = reinterpret_cast<const int*>(s_tab) + nsp * nsp * 9;

    const int T = a.T;
    const int tile = blockIdx.x;
    const int slot = tile * T + threadIdx.x;
    const float xi = a.x[slot], yi = a.y[slot], zi = a.z[slot];
    const int gi = a.gid[slot];
    const int ti = a.types[slot];
    const float rai = a.radii[slot];
    const int pi = PAR ? ca.parents[slot] : -1;

    const int e_end = a.row_ptr[tile + 1];
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
    aztotmd::CandMin m[3];
    for (int e = a.row_ptr[tile] + blockIdx.y; e < e_end; e += a.n_split) {
        const int jt = a.jt[e];
        const int js = jt * T + threadIdx.x;
        __syncthreads();                      // tables ready / tile consumed
        s_x[threadIdx.x] = a.x[js];
        s_y[threadIdx.x] = a.y[js];
        s_z[threadIdx.x] = a.z[js];
        s_g[threadIdx.x] = a.gid[js];
        s_t[threadIdx.x] = a.types[js];
        s_r[threadIdx.x] = a.radii[js];
        if (PAR) s_p[threadIdx.x] = ca.parents[js];
        __syncthreads();
        if (gi < 0) continue;
        if (!CAND) {
            for (int k = 0; k < T; ++k) {
                const int gj = s_g[k];
                if (gj < 0 || gj == gi) continue;
                aztotmd::pair_accumulate(a.c, s_tab, xi - s_x[k],
                                         yi - s_y[k], zi - s_z[k], ti,
                                         s_t[k], rai, s_r[k], fx, fy, fz,
                                         ev, ec);
            }
        } else {
            const int di = s_donacc[ti];
            for (int k = 0; k < T; ++k) {
                const int gj = s_g[k];
                if (gj < 0 || gj == gi) continue;
                float dx = xi - s_x[k], dy = yi - s_y[k], dz = zi - s_z[k];
                const float r2 = aztotmd::min_image_r2_rn(a.c, dx, dy, dz);
                if (!(r2 <= a.c.r2_max)) continue;
                const int tj = s_t[k];
                aztotmd::pair_physics(a.c, s_tab, r2, dx, dy, dz, ti, tj,
                                      rai, s_r[k], fx, fy, fz, ev, ec);
                const long long key =
                    static_cast<long long>(jt * nsp + tj) * ca.n_atoms + gj;
                aztotmd::cand_pair<BIND, JUMP, PAR>(
                    s_tab, nsp, r2, key, ti, tj, di, s_donacc[tj], gi, gj,
                    pi, PAR ? s_p[k] : -1, ca.r2_elec, m);
            }
        }
    }
    const size_t o = static_cast<size_t>(blockIdx.y) * a.n_t * T + slot;
    a.frc[3 * o] = fx;
    a.frc[3 * o + 1] = fy;
    a.frc[3 * o + 2] = fz;
    a.ev[o] = ev;
    a.ec[o] = ec;
    if (CAND)
        aztotmd::cand_store(m, ca.r2, ca.key, o,
                            static_cast<size_t>(a.n_split) * a.n_t * T);
}

template <bool BIND, bool JUMP, bool PAR>
int launch(const Args& a, const CandArgs& ca, cudaStream_t stream) {
    const dim3 grid(a.n_t, a.n_split);
    const size_t smem = aztotmd::table_bytes(a.c.nsp, BIND || JUMP);
    sparse_kernel<BIND, JUMP, PAR><<<grid, a.T, smem, stream>>>(a, ca);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the pass without candidates (K4) on `stream`; returns
// cudaGetLastError() of the launch.
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
