// Rectangular dense pair pass for Hopper (sm_90a), f32, batched over slabs.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::pair_forces_allpairs_rect (its
// pallas_call runs _allpairs_kernel on an (n_ti, n_tj) grid of i and j
// tiles), the pair pass of the slab-decomposed step: forces on the Ni
// owned slots of a slab from its Nj slots [owned; halo slabs].  The i slots
// are the first Ni j slots, so the self pair is the j slot with the i
// slot's index; a pair counts only when both slots are valid (filled); the
// min-image is over the full box, so halo coordinates are not shifted.  The
// per-pair physics is pair_physics.cuh, shared with allpairs.cu, sparse.cu
// and cellblock.cu: force clipped at +-MX_FRC per pair, energy 0.5 per
// ordered pair.
//
// Design: K1's (allpairs.cu).  One thread per i slot holds its accumulators
// in registers; the block stages j tiles of x/y/z/type/radius in shared
// memory and loops over them.  The j range is split over gridDim.y and the
// slab index runs on gridDim.z, so one launch covers every local slab of a
// step.  Each (slab, split, i) row is written once (zeros for an empty i
// slot) and the caller sums the n_split partials: no atomics.  The TPU
// kernel's (T, 1)/(1, T) lane layout and its padding of Ni, Nj to tiles of
// up to 512 are not kept: ragged ends are bounds tests.
//
// Empty slots: a slab's filled slots sit mostly at its front (the slab
// layout packs them and migration fills the first free slots), and a third
// or more of the slots are empty.  A block whose i slots are all empty
// writes its zero rows and leaves; a staged j tile keeps only its filled
// slots, compacted with warp ballots, with their slot index for the self
// test, so the inner loop runs over filled pairs only.
//
// Bound on the H100: FP32 and SFU issue over the filled slot pairs (an
// rsqrt per pair in range); memory traffic is O(Ni + Nj) per slab.  No
// cp.async/TMA staging and no symmetric half pass yet.

#include "pair_physics.cuh"

namespace {

constexpr int TILE = 128;

struct RectArgs {
    const float* pos_i;           // (L, ni, 3)
    const int* types_i;           // (L, ni)
    const unsigned char* valid_i; // (L, ni) bool
    const float* radii_i;         // (L, ni) or null
    const float* pos_j;           // (L, nj, 3)
    const int* types_j;           // (L, nj)
    const unsigned char* valid_j; // (L, nj) bool
    const float* radii_j;         // (L, nj) or null
    const float* params;          // (nsp*nsp, 8): p0..p4, kqq, r2cut, unused
    const int* kinds;             // (nsp*nsp,)
    float* frc;                   // (L, n_split, ni, 3) partial forces
    float* ev;                    // (L, n_split, ni) partial VdW energies
    float* ec;                    // (L, n_split, ni) partial Coulomb energies
    int ni, nj, n_split;
    aztotmd::PairConsts c;
};

__global__ void __launch_bounds__(TILE) rect_kernel(const RectArgs a) {
    extern __shared__ float s_tab[];          // params, kinds
    __shared__ float s_x[TILE], s_y[TILE], s_z[TILE], s_r[TILE];
    __shared__ int s_t[TILE], s_j[TILE];      // type, slot of a filled j
    __shared__ int s_warp[TILE / 32];         // filled j slots per warp

    const int nsp = a.c.nsp;
    aztotmd::load_tables(s_tab, a.params, a.kinds, nsp * nsp);

    const int l = blockIdx.z;
    const int ni = a.ni, nj = a.nj;
    const int i = blockIdx.x * TILE + threadIdx.x;
    const size_t si = static_cast<size_t>(l) * ni + i;
    const bool active = i < ni && a.valid_i[si];
    float xi = 0.0f, yi = 0.0f, zi = 0.0f, rai = 1.0f;
    int ti = 0;
    if (active) {
        xi = a.pos_i[3 * si];
        yi = a.pos_i[3 * si + 1];
        zi = a.pos_i[3 * si + 2];
        ti = a.types_i[si];
        if (a.c.use_radii) rai = a.radii_i[si];
    }

    if (!__syncthreads_or(active)) {          // no filled i slot here
        if (i < ni) {
            const size_t o = (static_cast<size_t>(l) * a.n_split
                              + blockIdx.y) * ni + i;
            a.frc[3 * o] = a.frc[3 * o + 1] = a.frc[3 * o + 2] = 0.0f;
            a.ev[o] = a.ec[o] = 0.0f;
        }
        return;
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_tiles = (nj + TILE - 1) / TILE;
    const int per = (n_tiles + a.n_split - 1) / a.n_split;
    const int t_begin = blockIdx.y * per;
    const int t_end = min(n_tiles, t_begin + per);
    const size_t jbase = static_cast<size_t>(l) * nj;

    float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
    for (int t = t_begin; t < t_end; ++t) {
        const int jl = t * TILE + threadIdx.x;
        const size_t sj = jbase + jl;
        const bool filled = jl < nj && a.valid_j[sj];
        const unsigned ballot = __ballot_sync(0xffffffffu, filled);
        __syncthreads();                      // previous tile consumed
        if (lane == 0) s_warp[warp] = __popc(ballot);
        __syncthreads();
        int base = 0, n_filled = 0;
        for (int w = 0; w < TILE / 32; ++w) {
            base += w < warp ? s_warp[w] : 0;
            n_filled += s_warp[w];
        }
        if (filled) {
            const int k = base + __popc(ballot & ((1u << lane) - 1u));
            s_x[k] = a.pos_j[3 * sj];
            s_y[k] = a.pos_j[3 * sj + 1];
            s_z[k] = a.pos_j[3 * sj + 2];
            s_t[k] = a.types_j[sj];
            s_r[k] = a.c.use_radii ? a.radii_j[sj] : 1.0f;
            s_j[k] = jl;
        }
        __syncthreads();
        if (!active) continue;
        for (int k = 0; k < n_filled; ++k) {
            if (s_j[k] == i) continue;        // the self slot
            aztotmd::pair_accumulate(a.c, s_tab, xi - s_x[k], yi - s_y[k],
                                     zi - s_z[k], ti, s_t[k], rai, s_r[k],
                                     fx, fy, fz, ev, ec);
        }
    }
    if (i < ni) {
        const size_t o = (static_cast<size_t>(l) * a.n_split + blockIdx.y)
                         * ni + i;
        a.frc[3 * o] = fx;
        a.frc[3 * o + 1] = fy;
        a.frc[3 * o + 2] = fz;
        a.ev[o] = ev;
        a.ec[o] = ec;
    }
}

}  // namespace

// Launches the rectangular pass over n_slab slabs on `stream`; returns
// cudaGetLastError() of the launch.
extern "C" int aztotmd_allpairs_rect_f32(
    const float* pos_i, const int* types_i, const unsigned char* valid_i,
    const float* radii_i, const float* pos_j, const int* types_j,
    const unsigned char* valid_j, const float* radii_j,
    const float* params, const int* kinds, int nsp, int n_slab, int ni,
    int nj, int n_split, int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, void* stream) {
    if (n_slab <= 0 || ni <= 0 || n_split <= 0 || n_slab > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const RectArgs a{pos_i, types_i, valid_i, radii_i, pos_j, types_j,
                     valid_j, radii_j, params, kinds, frc, ev, ec, ni, nj,
                     n_split,
                     {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                      r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    const dim3 grid((ni + TILE - 1) / TILE, n_split, n_slab);
    const size_t smem = aztotmd::table_bytes(nsp, false);
    rect_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// Tile width the kernel was compiled with (the wrapper sizes n_split by it).
extern "C" int aztotmd_allpairs_rect_tile() { return TILE; }
