// All-pairs RDF sample for Hopper (sm_90a): the (n_bin, n_pair) integer
// counts of one sample, f32 and f64.
//
// Replaces no TPU kernel: the JAX package's RDF is XLA, not Pallas.  It
// takes the place of the all-pairs branch of aztotmd_tpu/ops/rdf.py
// (rdf_sample_allpairs: N x N broadcasts of the min-image r2, the bin ids
// and their histogram), whose torch-ops copy is
// ops/rdf.py::rdf_counts_allpairs_plain.  That copy streams some fifteen
// N x N tensors through device memory and histograms N^2 ids with
// torch.histc, nine in ten of them on one dump slot.
//
// Bound on the H100: the N(N-1)/2 pair evaluations (a min-image
// displacement on each axis, r2 and the cut; the sqrt, the bin division
// and a shared-memory add for the pairs in range), not bytes: the inputs
// are 16 bytes an atom and the output n_bin * n_pair integers.  The design:
//
// - Same arithmetic as the plain version, operation by operation, so that
//   the counts are equal bit for bit: d = p_i - p_j; d -= box * rint(d /
//   box) (rint rounds half to even, as torch.round); r2 = (dx^2 + dy^2) +
//   dz^2; the pair counts when r2 < r2_max; bin = min((int)(sqrt(r2) /
//   d_rdf), n_bin - 1).  Every operation is an explicitly rounded
//   intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn and their
//   double forms), so nvcc contracts nothing into an FMA that could move
//   r2 across r_rdf or a bin edge.  The min-image term is skipped where it
//   is exactly 0: for |d| <= box / 2 the quotient rounds to at most 0.5,
//   and rint gives 0.
// - Balanced work that fills the card.  The upper triangle of the pair
//   matrix is cut into TILE x TILE tiles (i tile <= j tile), one block a
//   tile and one thread an i atom: every block but the diagonal ones has
//   TILE^2 pairs, those TILE(TILE-1)/2.  N = 4,000 gives 528 blocks of 128
//   threads, four an SM.  The j tile is staged in shared memory once.
// - Integer tables in shared memory.  Each warp keeps its own table of
//   the n_bin * n_pair slots where four fit in MAX_WARP_TABLES bytes, else
//   the block keeps one where it fits in MAX_BLOCK_TABLE bytes; a pair in
//   range adds 1 there.  At its end the block adds each non-zero slot once
//   to the global int32 table.  Integer adds are exact in any order, so
//   the counts do not depend on the schedule.  Pairs out of range, and
//   j <= i, touch no memory.  A table too large for shared memory is
//   added to in the global table directly: the choice is made from
//   n_bin * n_pair alone.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;                       // i (threads) and j a block
constexpr int WARPS = TILE / 32;
constexpr int MAX_WARP_TABLES = 32 * 1024;      // bytes, WARPS tables
constexpr int MAX_BLOCK_TABLE = 40 * 1024;      // bytes, one table

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rint_even(float a) { return rintf(a); }
__device__ __forceinline__ double rint_even(double a) { return rint(a); }

template <typename T>
struct Args {
    const T* pos;          // (n, 3)
    const int* types;      // (n,)
    int* counts;           // (n_bin * n_pair,), zeroed by the caller
    int n, n_tiles, nsp, n_bin, n_pair, n_tables;   // n_tables 0: global
    T box[3], half[3], r2_max, d_rdf;
};

// One component of the min-image displacement p_i - p_j, rounded as
// d - box * round(d / box) is in the plain version.
template <typename T>
__device__ __forceinline__ T min_image(T d, T box, T half) {
    if (fabs(d) > half) d = sub_rn(d, mul_rn(box, rint_even(div_rn(d, box))));
    return d;
}

template <typename T>
__global__ void __launch_bounds__(TILE) rdf_allpairs_kernel(Args<T> a) {
    __shared__ T sx[TILE], sy[TILE], sz[TILE];
    __shared__ int st[TILE];
    extern __shared__ int tables[];

    // block -> (i tile, j tile) of the upper triangle, row by row
    int ti = 0, b = blockIdx.x;
    while (b >= a.n_tiles - ti) {
        b -= a.n_tiles - ti;
        ++ti;
    }
    const int tj = ti + b;
    const int i0 = ti * TILE, j0 = tj * TILE;
    const int n_slot = a.n_bin * a.n_pair;

    for (int s = threadIdx.x; s < a.n_tables * n_slot; s += TILE) tables[s] = 0;
    const int j = j0 + threadIdx.x;
    if (j < a.n) {
        sx[threadIdx.x] = a.pos[3 * j];
        sy[threadIdx.x] = a.pos[3 * j + 1];
        sz[threadIdx.x] = a.pos[3 * j + 2];
        st[threadIdx.x] = a.types[j];
    }
    __syncthreads();

    int* table = a.n_tables == 0 ? a.counts
               : tables + (a.n_tables == 1 ? 0 : (threadIdx.x >> 5) * n_slot);
    const int i = i0 + threadIdx.x;
    if (i < a.n) {
        const T xi = a.pos[3 * i], yi = a.pos[3 * i + 1], zi = a.pos[3 * i + 2];
        const int t_i = a.types[i];
        const int j_end = min(TILE, a.n - j0);
        for (int jj = ti == tj ? threadIdx.x + 1 : 0; jj < j_end; ++jj) {
            const T dx = min_image(sub_rn(xi, sx[jj]), a.box[0], a.half[0]);
            const T dy = min_image(sub_rn(yi, sy[jj]), a.box[1], a.half[1]);
            const T dz = min_image(sub_rn(zi, sz[jj]), a.box[2], a.half[2]);
            const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                                mul_rn(dz, dz));
            if (r2 < a.r2_max) {
                const int bin = min(static_cast<int>(div_rn(sqrt_rn(r2), a.d_rdf)),
                                    a.n_bin - 1);
                int ip = 0;
                if (a.nsp > 1) {
                    const int mn = min(t_i, st[jj]), mx = max(t_i, st[jj]);
                    ip = mn * (a.nsp - 1) + mn * (1 - mn) / 2 + mx;
                }
                atomicAdd(table + bin * a.n_pair + ip, 1);
            }
        }
    }
    if (a.n_tables == 0) return;
    __syncthreads();
    for (int s = threadIdx.x; s < n_slot; s += TILE) {
        int v = 0;
        for (int c = 0; c < a.n_tables; ++c) v += tables[c * n_slot + s];
        if (v) atomicAdd(a.counts + s, v);
    }
}

// Shared-memory tables of a launch: WARPS, 1 or 0 (the global table).
int table_copies(int n_slot) {
    const long long bytes = 4LL * n_slot;
    if (WARPS * bytes <= MAX_WARP_TABLES) return WARPS;
    return bytes <= MAX_BLOCK_TABLE ? 1 : 0;
}

template <typename T>
int launch(const T* pos, const int* types, int n, int nsp, int n_bin,
           int n_pair, T bx, T by, T bz, T r2_max, T d_rdf, int* counts,
           void* stream) {
    if (n <= 0) return 0;
    Args<T> a{pos, types, counts, n, (n + TILE - 1) / TILE, nsp, n_bin,
              n_pair, table_copies(n_bin * n_pair), {bx, by, bz},
              {bx * T(0.5), by * T(0.5), bz * T(0.5)}, r2_max, d_rdf};
    const long long blocks = 1LL * a.n_tiles * (a.n_tiles + 1) / 2;
    const size_t smem = sizeof(int) * a.n_tables * n_bin * n_pair;
    rdf_allpairs_kernel<T><<<static_cast<unsigned>(blocks), TILE, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Adds the (n_bin, n_pair) counts of the unordered pairs of `pos` (n, 3)
// within r2_max into `counts` on `stream`; returns cudaGetLastError() of
// the launch (0 for n = 0, which launches nothing).
extern "C" int aztotmd_rdf_allpairs_f32(
    const float* pos, const int* types, int n, int nsp, int n_bin,
    int n_pair, float bx, float by, float bz, float r2_max, float d_rdf,
    int* counts, void* stream) {
    return launch<float>(pos, types, n, nsp, n_bin, n_pair, bx, by, bz,
                         r2_max, d_rdf, counts, stream);
}

extern "C" int aztotmd_rdf_allpairs_f64(
    const double* pos, const int* types, int n, int nsp, int n_bin,
    int n_pair, double bx, double by, double bz, double r2_max,
    double d_rdf, int* counts, void* stream) {
    return launch<double>(pos, types, n, nsp, n_bin, n_pair, bx, by, bz,
                          r2_max, d_rdf, counts, stream);
}

// Shared-memory tables a launch keeps for n_slot slots: the warps', one
// block's, or 0 (added to in the global table).
extern "C" int aztotmd_rdf_table_copies(int n_slot) {
    return table_copies(n_slot);
}
