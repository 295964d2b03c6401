// Rectangular dense pair pass for Hopper (sm_90a), f32, batched over slabs.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::pair_forces_allpairs_rect (its
// pallas_call runs _allpairs_kernel on an (n_ti, n_tj) grid of i and j
// tiles), the pair pass of the slab-decomposed step (K2): forces on the Ni
// owned slots of a slab from its Nj slots [owned; halo slabs].  The i slots
// are the first Ni j slots, so the self pair is the j slot with the i
// slot's index; a pair counts only when both slots are valid (filled); the
// min-image is over the full box, so halo coordinates are not shifted.  The
// per-pair physics is pair_physics.cuh, shared with allpairs.cu, sparse.cu
// and cellblock.cu: force clipped at +-MX_FRC per pair, energy 0.5 per
// ordered pair.
//
// Bound on the H100: FP32 throughput over the filled slot pairs that must
// be tested (displacement, min-image, r2, cutoff test) and the physics of
// the pairs in range (an rsqrt each); memory traffic is O(Ni + Nj) per
// slab.
// The design:
//
// - The card is full.  A block takes TILE i slots, a thread each, and a
//   range of whole TILE-slot j tiles, which its GROUPS groups of TILE
//   threads cut into contiguous sub-ranges (each group its own staging and
//   named barrier; the groups' sums are added in group order at the end).
//   The wrapper sizes the n_split ranges from the device's SM count
//   (ops/allpairs.py::rect_split): a tile a group where that stays under
//   32 blocks an SM.  The pass is latency-bound, and a block whose i slots
//   are all empty writes zero rows and leaves at once (a third or more of
//   a slab), so it needs many more blocks than the SMs hold at a time;
//   groups give that parallelism without more partial rows.  Grid
//   (n_split, n_slab, i tiles): the scheduler dispatches the low i tiles
//   of every slab first, and a slab's filled slots sit at its front (the
//   slab layout packs them and migration fills the first free slots), so
//   the fullest slab's last filled tiles do not queue behind the others'
//   empty ones.  Each (slab, split, i) row is written once and the wrapper
//   sums the n_split partials: no atomics, nothing carried between blocks.
// - Warp sub-tile cull (sparse.cu's, over the slab layout).  A slab's slots
//   hold its atoms in ascending id order, and the decks emit atoms sphere
//   by sphere or in lattice order, so 32 consecutive slots are compact.
//   Each warp takes the box of its 32 filled i slots once, and for each
//   staged j tile the boxes of the tile's four 32-slot sub-tiles from
//   their filled slots only (empty slots hold zeros, or after a migration a
//   departed atom's stale position), each lane a bank-rotated eighth of a
//   sub-tile, then three shuffles.  A j sub-tile whose periodic min-image
//   box gap (pair_physics.cuh::box_near) exceeds the cutoff plus
//   CULL_SLACK is skipped, a warp-uniform branch: every pair skipped is
//   out of range (the boxes are unshifted and the min-image is over the
//   full box, so the gap is a lower bound even for a box straddling a
//   periodic face), and the kept pairs are summed in slot order as before,
//   so forces and energies are the unculled pass's.  REC records which
//   (i sub-tile, j sub-tile) pairs the warps kept, for tests and
//   measurement (ops/allpairs.py::rect_subtile_keep repeats the test in
//   torch); the pair pass compiles without it.
// - Divergence and latency.  A kept sub-tile is tested 32 slots at a time
//   with eight independent r2 chains, one bit per slot in range, masked by
//   the sub-tile's filled bits and the i slot's own bit; each lane then
//   walks its set bits in slot order and runs the physics, so the warp runs
//   it as often as its busiest lane has pairs, not once per slot any lane
//   has one (allpairs.cu's bitmask).  The walk takes two bits at a time:
//   the two pairs' loads, rsqrt and table reads are independent and
//   overlap, and their sums are added one after the other.
// - Staging.  j tiles are double-buffered in shared memory: positions
//   repacked from AoS into float4 (x, y, z, radius) and types by 4-byte
//   cp.async, the filled flags loaded into a register one tile ahead and
//   folded into one ballot word per sub-tile; the next tile is in flight
//   while the current one is computed, one group barrier a tile.

#include "pair_physics.cuh"

namespace {

using aztotmd::FULL;
using aztotmd::SUB;

constexpr int TILE = 128;                 // i slots a block, j slots a tile
constexpr int NSUB = TILE / SUB;          // j sub-tiles of a tile
constexpr int GROUPS = 2;                 // thread groups a block
constexpr int THREADS = GROUPS * TILE;

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
    unsigned char* kept;          // (L, ceil(ni/32), ceil(nj/32)) (REC)
    int ni, nj, n_split;
    aztotmd::PairConsts c;
};

// One staged j tile (16-byte aligned for the float4 reads).
struct __align__(16) JTile {
    float4 p[TILE];               // x, y, z, radius
    int t[TILE];
    unsigned filled[NSUB];        // bit u of word s: slot 32 s + u filled
};

// A block's static shared memory: two staged tiles a group and the sums of
// all groups but the first.
constexpr size_t STATIC_SMEM = 2 * GROUPS * sizeof(JTile)
                               + (GROUPS - 1) * 5 * TILE * sizeof(float);

// An i slot's position, radius and type, and its force and energy sums.
struct IRow {
    float x, y, z, r;
    int t;
    float fx, fy, fz, ev, ec;
};

// Barrier of the TILE threads of group g (named barrier g + 1).
__device__ __forceinline__ void group_sync(int g) {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(TILE) : "memory");
}

// Starts the copy of j tile `t` of slab `l` into `s` by the TILE threads of
// a group (one cp.async group; slots past nj are left as they are and never
// marked filled) and returns this thread's filled flag of that tile, which
// the caller folds into s.filled before the tile's barrier.
__device__ __forceinline__ bool stage(const RectArgs& a, int l, int t,
                                      JTile& s) {
    const int k = threadIdx.x % TILE;
    const int jl = t * TILE + k;
    bool filled = false;
    if (jl < a.nj) {
        const size_t sj = static_cast<size_t>(l) * a.nj + jl;
        aztotmd::cp_async4(&s.p[k].x, a.pos_j + 3 * sj);
        aztotmd::cp_async4(&s.p[k].y, a.pos_j + 3 * sj + 1);
        aztotmd::cp_async4(&s.p[k].z, a.pos_j + 3 * sj + 2);
        if (a.c.use_radii)
            aztotmd::cp_async4(&s.p[k].w, a.radii_j + sj);
        else
            s.p[k].w = 1.0f;
        aztotmd::cp_async4(s.t + k, a.types_j + sj);
        filled = a.valid_j[sj] != 0;
    }
    aztotmd::cp_async_commit();
    return filled;
}

// Bit s set: j sub-tile s of `s` holds a filled slot and its box lies
// within the cull radius of the warp's box `w`.  Lane l takes the eighth
// l >> 2 of sub-tile l & 3; the slot order is rotated by the sub-tile so
// that each quarter-warp's 16-byte reads fall on distinct banks.
__device__ __forceinline__ unsigned cull_mask(const JTile& s,
                                              const aztotmd::Box& w,
                                              const aztotmd::PairConsts& c,
                                              float r2c) {
    const int lane = threadIdx.x & 31, sub = lane & (NSUB - 1);
    const int part = lane / NSUB;                     // 0..7, 4 slots each
    const unsigned bits = s.filled[sub] >> (4 * part);
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float ux = -INFINITY, uy = -INFINITY, uz = -INFINITY;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int q = (u + sub) & 3;
        if ((bits >> q) & 1u) {
            const float4 p = s.p[sub * SUB + 4 * part + q];
            lx = fminf(lx, p.x);
            ly = fminf(ly, p.y);
            lz = fminf(lz, p.z);
            ux = fmaxf(ux, p.x);
            uy = fmaxf(uy, p.y);
            uz = fmaxf(uz, p.z);
        }
    }
    for (int o = NSUB; o < 32; o <<= 1) {
        lx = fminf(lx, __shfl_xor_sync(FULL, lx, o));
        ly = fminf(ly, __shfl_xor_sync(FULL, ly, o));
        lz = fminf(lz, __shfl_xor_sync(FULL, lz, o));
        ux = fmaxf(ux, __shfl_xor_sync(FULL, ux, o));
        uy = fmaxf(uy, __shfl_xor_sync(FULL, uy, o));
        uz = fmaxf(uz, __shfl_xor_sync(FULL, uz, o));
    }
    const bool keep = lane < NSUB
                      && aztotmd::box_near(w, lx, ly, lz, ux, uy, uz, c, r2c);
    return __ballot_sync(FULL, keep);
}

// The pairs of i row `ia` with the filled slots `mask` of the 32-slot
// sub-tile at k0: one bit per slot in range first, then the physics of the
// set bits in slot order, two pairs at a time, so that the card overlaps
// the two pairs' latencies (their sums are taken one after the other).
__device__ __forceinline__ void subtile_pairs(const aztotmd::PairConsts& c,
                                              const float* s_tab,
                                              const JTile& s, int k0,
                                              unsigned mask, IRow& ia) {
    unsigned near = 0;
#pragma unroll 8
    for (int u = 0; u < SUB; ++u) {
        const float4 p = s.p[k0 + u];
        float dx = ia.x - p.x, dy = ia.y - p.y, dz = ia.z - p.z;
        const float r2 = aztotmd::min_image_r2(c, dx, dy, dz);
        near |= static_cast<unsigned>(r2 <= c.r2_max) << u;
    }
    near &= mask;
    while (near) {
        const int ka = k0 + __ffs(near) - 1;
        near &= near - 1;
        const bool two = near != 0;
        const int kb = two ? k0 + __ffs(near) - 1 : ka;
        near &= near - 1;
        const float4 pa = s.p[ka], pb = s.p[kb];
        float dxa = ia.x - pa.x, dya = ia.y - pa.y, dza = ia.z - pa.z;
        float dxb = ia.x - pb.x, dyb = ia.y - pb.y, dzb = ia.z - pb.z;
        const float r2a = aztotmd::min_image_r2(c, dxa, dya, dza);
        const float r2b = aztotmd::min_image_r2(c, dxb, dyb, dzb);
        const aztotmd::PairTerms ta =
            aztotmd::pair_terms(c, s_tab, ia.t, s.t[ka], r2a, ia.r, pa.w);
        const aztotmd::PairTerms tb =
            aztotmd::pair_terms(c, s_tab, ia.t, s.t[kb], r2b, ia.r, pb.w);
        if (r2a <= c.r2_max)
            aztotmd::pair_add(ta, dxa, dya, dza, ia.fx, ia.fy, ia.fz, ia.ev,
                              ia.ec);
        if (two && r2b <= c.r2_max)
            aztotmd::pair_add(tb, dxb, dyb, dzb, ia.fx, ia.fy, ia.fz, ia.ev,
                              ia.ec);
    }
}

template <bool REC>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
rect_kernel(const RectArgs a) {
    extern __shared__ float s_tab[];          // params, kinds
    __shared__ JTile s_j[GROUPS][2];
    __shared__ float s_red[GROUPS - 1][5][TILE];

    const int g = threadIdx.x / TILE, tid = threadIdx.x % TILE;
    const int l = blockIdx.y;
    const int ni = a.ni;
    const int i = blockIdx.z * TILE + tid;
    const size_t si = static_cast<size_t>(l) * ni + i;
    const size_t o = (static_cast<size_t>(l) * a.n_split + blockIdx.x) * ni
                     + i;
    const bool active = i < ni && a.valid_i[si];
    if (!__syncthreads_or(active)) {          // no filled i slot here
        if (g == 0 && i < ni) {
            a.frc[3 * o] = a.frc[3 * o + 1] = a.frc[3 * o + 2] = 0.0f;
            a.ev[o] = a.ec[o] = 0.0f;
        }
        return;
    }

    // this split's tiles, cut into GROUPS contiguous ranges
    const int n_tiles = (a.nj + TILE - 1) / TILE;
    const int per = (n_tiles + a.n_split - 1) / a.n_split;
    const int s_begin = blockIdx.x * per;
    const int s_end = min(n_tiles, s_begin + per);
    const int per_g = (max(s_end - s_begin, 0) + GROUPS - 1) / GROUPS;
    const int t_begin = s_begin + g * per_g;
    const int t_end = min(s_end, t_begin + per_g);
    JTile* buf = s_j[g];
    bool next_filled = t_begin < t_end && stage(a, l, t_begin, buf[0]);

    aztotmd::load_tables(s_tab, a.params, a.kinds, a.c.nsp * a.c.nsp);
    IRow ia{0.0f, 0.0f, 0.0f, 1.0f, 0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (active) {
        ia.x = a.pos_i[3 * si];
        ia.y = a.pos_i[3 * si + 1];
        ia.z = a.pos_i[3 * si + 2];
        ia.t = a.types_i[si];
        if (a.c.use_radii) ia.r = a.radii_i[si];
    }
    const int lane = threadIdx.x & 31, warp = tid >> 5;
    const aztotmd::Box w = aztotmd::warp_box(active, ia.x, ia.y, ia.z);
    const bool warp_filled = __any_sync(FULL, active);
    const float r2c = aztotmd::cull_r2(a.c);
    const int n_isub = (ni + SUB - 1) / SUB, n_jsub = (a.nj + SUB - 1) / SUB;
    unsigned char* kept = REC ? a.kept + (static_cast<size_t>(l) * n_isub
                                          + blockIdx.z * NSUB + warp)
                                         * n_jsub
                              : nullptr;
    __syncthreads();                          // the tables

    for (int t = t_begin, b = 0; t < t_end; ++t, b ^= 1) {
        JTile& s = buf[b];
        const unsigned filled = __ballot_sync(FULL, next_filled);
        if (lane == 0) s.filled[warp] = filled;
        aztotmd::cp_async_wait_all();
        group_sync(g);            // tile t visible; the other buffer's
                                  // tile consumed
        if (t + 1 < t_end) next_filled = stage(a, l, t + 1, buf[b ^ 1]);
        if (!warp_filled) continue;
        unsigned subs = cull_mask(s, w, a.c, r2c);
        if (REC && lane < NSUB && ((subs >> lane) & 1u))
            kept[t * NSUB + lane] = 1;
        if (!active) continue;
        while (subs) {
            const int sb = __ffs(subs) - 1;
            subs &= subs - 1;
            const int j0 = t * TILE + sb * SUB;
            unsigned mask = s.filled[sb];
            if (static_cast<unsigned>(i - j0) < static_cast<unsigned>(SUB))
                mask &= ~(1u << (i - j0));    // the self slot
            subtile_pairs(a.c, s_tab, s, sb * SUB, mask, ia);
        }
    }
    // the groups' sums, in group order: the split's slots in order
    if (g > 0) {
        s_red[g - 1][0][tid] = ia.fx;
        s_red[g - 1][1][tid] = ia.fy;
        s_red[g - 1][2][tid] = ia.fz;
        s_red[g - 1][3][tid] = ia.ev;
        s_red[g - 1][4][tid] = ia.ec;
    }
    __syncthreads();
    if (g > 0) return;
    for (int q = 0; q < GROUPS - 1; ++q) {
        ia.fx += s_red[q][0][tid];
        ia.fy += s_red[q][1][tid];
        ia.fz += s_red[q][2][tid];
        ia.ev += s_red[q][3][tid];
        ia.ec += s_red[q][4][tid];
    }
    if (i < ni) {
        a.frc[3 * o] = ia.fx;
        a.frc[3 * o + 1] = ia.fy;
        a.frc[3 * o + 2] = ia.fz;
        a.ev[o] = ia.ev;
        a.ec[o] = ia.ec;
    }
}

}  // namespace

// Launches the rectangular pass over n_slab slabs on `stream`; returns
// cudaGetLastError() of the launch.  With `kept` (zeroed, (n_slab,
// ceil(ni/32), ceil(nj/32)) bytes) it runs the recording instantiation,
// which also sets kept[l][w][s] when i sub-tile w of slab l kept j
// sub-tile s.
extern "C" int aztotmd_allpairs_rect_f32(
    const float* pos_i, const int* types_i, const unsigned char* valid_i,
    const float* radii_i, const float* pos_j, const int* types_j,
    const unsigned char* valid_j, const float* radii_j,
    const float* params, const int* kinds, int nsp, int n_slab, int ni,
    int nj, int n_split, int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, unsigned char* kept, void* stream) {
    const int n_itile = (ni + TILE - 1) / TILE;
    if (n_slab <= 0 || ni <= 0 || n_split <= 0 || n_slab > 65535
            || n_itile > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const RectArgs a{pos_i, types_i, valid_i, radii_i, pos_j, types_j,
                     valid_j, radii_j, params, kinds, frc, ev, ec, kept,
                     ni, nj, n_split,
                     {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                      r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    const dim3 grid(n_split, n_slab, n_itile);
    const size_t smem = aztotmd::table_bytes(nsp, false);
    auto kernel = kept != nullptr ? &rect_kernel<true> : &rect_kernel<false>;
    // the tables past what the static tiles leave of the default 48 KB
    // need the opt-in
    if (smem + STATIC_SMEM > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// Tile width the kernel was compiled with (the wrapper sizes n_split by it).
extern "C" int aztotmd_allpairs_rect_tile() { return TILE; }

// j sub-ranges a block takes (the wrapper sizes n_split by it).
extern "C" int aztotmd_allpairs_rect_groups() { return GROUPS; }
