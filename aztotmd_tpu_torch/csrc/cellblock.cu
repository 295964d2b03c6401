// Stacked cell-block pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::_pair_kernel (called from the
// stacked branch of pair_forces_pallas), K3.  The per-pair physics is
// pair_physics.cuh, shared with allpairs.cu and sparse.cu.
//
// What it computes: atoms are binned into cells of at most `cap` slots (the
// wrapper's cell-major (n_cell, cap) table, filled slots first).  Every atom
// of a cell meets the atoms of its own cell (self pair excluded by slot) and
// of the neighbor cells of the stencil.  A neighbor across the periodic
// boundary is shifted by one box length instead of a min-image rounding:
// the dispatcher guarantees at least three cells a side and offsets within
// +-1, so the neighbor cells are distinct cells and the shift is exact.
//
// What the TPU kernel did and this one does not: the TPU kernel reads 14
// stacked, rolled copies of the table (the Newton half stencil, so it never
// gathers), visits all cap x cap slot pairs of every cell pair, and emits
// j-side force partials per offset that are rolled back and subtracted
// outside.  Here one block takes one cell and walks the full stencil (own
// cell and up to 26 neighbors, every energy weighted 0.5), so it writes only
// its own cell's forces: no partial buffers, no atomics, and the result does
// not depend on the order blocks run in.  The block reads each neighbor
// cell's count and stages only its filled slots, compacted, in shared memory
// (x, y, z pre-shifted, type, radius): the work follows the occupancy, not
// cap^2.  A cell holds tens of atoms, too few rows for a block, so each i
// atom is shared by `lanes` threads of one warp that stride over the staged
// j atoms and are summed with shuffles; `lanes` is the largest power of two
// that still gives every i atom of this cell a row (32 for up to 8 atoms,
// 16 up to 16, ... 1 from 129 on; fuller cells loop over their rows).
//
// Bound on the H100: the FP32 and SFU work over the visited pairs (an rsqrt
// per pair in range); the pass reads the table once per neighbor (from L2 after
// the first touch) and writes n_cell * cap * 12 bytes.  This first version
// is plain: no cp.async/TMA staging, no half stencil, one cell per block.

#include "pair_physics.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_OFF = 27;

struct Args {
    const float* x;        // (n_cell, cap) cell-major table
    const float* y;
    const float* z;
    const int* types;      // (n_cell, cap)
    const float* radii;    // (n_cell, cap) or null
    const int* cnt;        // (n_cell,) filled slots of each cell
    const float* params;   // (nsp*nsp, 8): p0..p4, kqq, r2cut, unused
    const int* kinds;      // (nsp*nsp,)
    float* frc;            // (n_cell * cap, 3) slot forces
    float* ev;             // (n_cell,) VdW energy of each cell's rows
    float* ec;             // (n_cell,) Coulomb energy
    int n_off, cap, n_cell, d0, d1, d2;
    int off[MAX_OFF * 3];  // stencil offsets, (0, 0, 0) first
    aztotmd::PairConsts c;
};

// Neighbor cell of (cx, cy, cz) at offset o (within +-1) and its periodic
// image shift: -box, 0 or +box per axis.
__device__ __forceinline__ int neighbor(const Args& a, int o, int cx, int cy,
                                        int cz, float& sx, float& sy,
                                        float& sz) {
    int nx = cx + a.off[3 * o], ny = cy + a.off[3 * o + 1],
        nz = cz + a.off[3 * o + 2];
    sx = sy = sz = 0.0f;
    if (nx < 0) { nx += a.d0; sx = -a.c.bx; }
    else if (nx >= a.d0) { nx -= a.d0; sx = a.c.bx; }
    if (ny < 0) { ny += a.d1; sy = -a.c.by; }
    else if (ny >= a.d1) { ny -= a.d1; sy = a.c.by; }
    if (nz < 0) { nz += a.d2; sz = -a.c.bz; }
    else if (nz >= a.d2) { nz -= a.d2; sz = a.c.bz; }
    return (nx * a.d1 + ny) * a.d2 + nz;
}

__global__ void __launch_bounds__(THREADS) cellblock_kernel(const Args a) {
    extern __shared__ float smem[];           // tables, then the staged atoms
    __shared__ int s_start[MAX_OFF + 1];      // first staged atom per offset
    __shared__ float s_red[2 * THREADS / 32];

    const int npair = a.c.nsp * a.c.nsp;
    const int stride = a.n_off * a.cap;
    float* s_tab = smem;
    float* s_x = smem + npair * 9;
    float* s_y = s_x + stride;
    float* s_z = s_y + stride;
    float* s_r = s_z + stride;
    int* s_t = reinterpret_cast<int*>(s_r + stride);

    aztotmd::load_tables(s_tab, a.params, a.kinds, npair);

    const int cell = blockIdx.x;
    const int cz = cell % a.d2;
    const int cy = (cell / a.d2) % a.d1;
    const int cx = cell / (a.d1 * a.d2);

    if (threadIdx.x == 0) {
        int s = 0;
        float sx, sy, sz;
        for (int o = 0; o < a.n_off; ++o) {
            s_start[o] = s;
            s += a.cnt[neighbor(a, o, cx, cy, cz, sx, sy, sz)];
        }
        s_start[a.n_off] = s;
    }
    __syncthreads();

    // stage the filled slots of every stencil cell, shifted by the image
    for (int o = 0; o < a.n_off; ++o) {
        float sx, sy, sz;
        const int nc = neighbor(a, o, cx, cy, cz, sx, sy, sz);
        const int first = s_start[o];
        const int n = s_start[o + 1] - first;
        for (int k = threadIdx.x; k < n; k += THREADS) {
            const int src = nc * a.cap + k;
            s_x[first + k] = a.x[src] + sx;
            s_y[first + k] = a.y[src] + sy;
            s_z[first + k] = a.z[src] + sz;
            s_t[first + k] = a.types[src];
            s_r[first + k] = a.c.use_radii ? a.radii[src] : 1.0f;
        }
    }
    __syncthreads();

    const int ni = s_start[1];                // the own cell is staged first
    const int nj = s_start[a.n_off];
    int lanes = 32;
    while (lanes > 1 && THREADS / lanes < ni) lanes >>= 1;
    const int rows = THREADS / lanes;
    const int lane = threadIdx.x % lanes;
    const int row = threadIdx.x / lanes;

    float ev = 0.0f, ec = 0.0f;
    for (int i0 = 0; i0 < ni; i0 += rows) {   // same trip count in the block
        const int i = i0 + row;
        const bool active = i < ni;
        float fx = 0.0f, fy = 0.0f, fz = 0.0f;
        if (active) {
            const float xi = s_x[i], yi = s_y[i], zi = s_z[i], rai = s_r[i];
            const int ti = s_t[i];
            for (int j = lane; j < nj; j += lanes) {
                if (j == i) continue;         // self pair: same slot, own cell
                const float dx = xi - s_x[j];
                const float dy = yi - s_y[j];
                const float dz = zi - s_z[j];
                const float r2 = dx * dx + dy * dy + dz * dz;
                if (!(r2 <= a.c.r2_max)) continue;
                aztotmd::pair_physics(a.c, s_tab, r2, dx, dy, dz, ti, s_t[j],
                                      rai, s_r[j], fx, fy, fz, ev, ec);
            }
        }
        for (int d = lanes >> 1; d > 0; d >>= 1) {
            fx += __shfl_down_sync(0xffffffffu, fx, d, lanes);
            fy += __shfl_down_sync(0xffffffffu, fy, d, lanes);
            fz += __shfl_down_sync(0xffffffffu, fz, d, lanes);
        }
        if (active && lane == 0) {
            const size_t o = static_cast<size_t>(cell) * a.cap + i;
            a.frc[3 * o] = fx;
            a.frc[3 * o + 1] = fy;
            a.frc[3 * o + 2] = fz;
        }
    }
    // empty slots carry zero force
    for (int k = ni + threadIdx.x; k < a.cap; k += THREADS) {
        const size_t o = static_cast<size_t>(cell) * a.cap + k;
        a.frc[3 * o] = 0.0f;
        a.frc[3 * o + 1] = 0.0f;
        a.frc[3 * o + 2] = 0.0f;
    }

    // the cell's energies: warps first, then the block's eight partials
    for (int d = 16; d > 0; d >>= 1) {
        ev += __shfl_down_sync(0xffffffffu, ev, d);
        ec += __shfl_down_sync(0xffffffffu, ec, d);
    }
    if (threadIdx.x % 32 == 0) {
        s_red[threadIdx.x / 32] = ev;
        s_red[THREADS / 32 + threadIdx.x / 32] = ec;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float sv = 0.0f, sc = 0.0f;
        for (int w = 0; w < THREADS / 32; ++w) {
            sv += s_red[w];
            sc += s_red[THREADS / 32 + w];
        }
        a.ev[cell] = sv;
        a.ec[cell] = sc;
    }
}

size_t smem_bytes(int nsp, int cap, int n_off) {
    return aztotmd::table_bytes(nsp, false)
           + static_cast<size_t>(n_off) * cap * 5 * sizeof(float);
}

}  // namespace

// Dynamic shared memory a block needs for these sizes: the parameter tables
// and x, y, z, radius, type of n_off cells of cap slots.
extern "C" long aztotmd_cellblock_smem_bytes(int nsp, int cap, int n_off) {
    return static_cast<long>(smem_bytes(nsp, cap, n_off));
}

// Launches the pass on `stream`: one block per cell.  `offs` is a host array
// of n_off stencil offsets (3 ints each, all within +-1, (0, 0, 0) first,
// at most 27).  Returns cudaGetLastError() of the launch.
extern "C" int aztotmd_cellblock_f32(
    const float* x, const float* y, const float* z, const int* types,
    const float* radii, const int* cnt, const int* offs,
    const float* params, const int* kinds, int nsp, int n_off, int cap,
    int n_cell, int d0, int d1, int d2, int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, void* stream) {
    if (n_off < 1 || n_off > MAX_OFF || cap < 1 || n_cell < 1
            || offs[0] != 0 || offs[1] != 0 || offs[2] != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{x, y, z, types, radii, cnt, params, kinds, frc, ev, ec,
           n_off, cap, n_cell, d0, d1, d2, {},
           {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz, r2_max,
            alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    for (int k = 0; k < 3 * n_off; ++k) a.off[k] = offs[k];
    const size_t smem = smem_bytes(nsp, cap, n_off);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cellblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    cellblock_kernel<<<n_cell, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
