// Stacked cell-block pair pass for Hopper (sm_90a), f32.
//
// Replaces aztotmd_tpu/ops/pallas_pair.py::_pair_kernel (called from the
// stacked branch of pair_forces_pallas), K3.  The per-pair physics is
// pair_physics.cuh, shared with allpairs.cu and sparse.cu.
//
// What it computes: atoms are binned into cells of at most `cap` slots (the
// wrapper's cell-major (n_cell, cap) table, filled slots first).  Every atom
// of a cell meets the atoms of its own cell (self pair excluded by slot) and
// of the 26 neighbor cells.  A neighbor across the periodic boundary is
// shifted by one box length instead of a min-image rounding: the dispatcher
// guarantees at least three cells a side and offsets within +-1, so the
// neighbor cells are distinct cells and the shift is exact; with offsets
// within +-1 the stencil is the full 27 cells (core/config.py).
//
// What the TPU kernel did and this one does not: the TPU kernel reads 14
// stacked, rolled copies of the table (the Newton half stencil, so it never
// gathers), visits all cap x cap slot pairs of every cell pair, and emits
// j-side force partials per offset that are rolled back and subtracted
// outside.  Here every ordered pair is visited (every energy weighted 0.5)
// and a block writes only its own cells' forces: no partial buffers, no
// atomics, and the result does not depend on the order blocks run in.  A
// half stencil would halve the pair work but send the j-side forces out of
// the block: a (13, n_cell * cap, 3) f32 buffer written and summed by a
// second pass, 15.8 MB each way on liquid argon (PERF.md says why it is
// not taken).
//
// Bound on the H100: FP32 throughput over the filled slot pairs of the
// stencil (displacement, r2 and the cutoff test on pre-shifted images) and
// the physics of the pairs in range (an rsqrt each; about 13% of the pairs
// on liquid argon); the pass reads the table about 13 times (from L2) and
// writes n_cell * cap * 12 bytes.  A cell holds ~15 atoms, ~400 stencil
// partners, so the work of one cell is too small for a block, its staging
// is latency and so is the physics of its pairs.  The design:
//
// - A run of cells a block.  A block takes `nz` consecutive cells along z
//   (the fastest axis of the table; the wrapper sizes nz so the run holds
//   about 64 atoms, ops/cellblock.py::stacked_plan) and stages once the 9
//   (x, y) columns of nz + 2 cells that its cells' stencils cover, each
//   column in z order: the 27 cells of own cell k are then three contiguous
//   cells in each column, nine ranges.  Adjacent cells share their
//   stencils, so a run of 4 stages 13.5 cells a cell instead of 27.  The
//   blocks of every column's full runs come first and the shorter last
//   runs after them, so the last wave of blocks is the lightest.
// - Parallel staging.  One warp reads the 9 (nz + 2) neighbor counts and
//   scans them with shuffles; then every thread copies filled slots in a
//   single pass, mapping its index to (cell, slot) by a binary search of
//   the scan, with cp.async into float4 (x, y, z, radius) and the types.
//   Cells across a periodic face get their image shift added after the
//   copies land, by the threads that copied them.  Two dependent memory
//   round trips a block instead of one per stencil cell.
// - A warp per column.  Warp c takes stencil column c for 32 of the run's
//   atoms at a time (a lane each), tests its three-cell range WIN
//   atoms at a time with independent r2 chains into an in-range bitmask
//   (the self pair is a slot test), then walks its set bits in order, two
//   at a time, and runs the physics: the warp runs it as often as its
//   busiest lane has pairs in range over the window (allpairs.cu's
//   bitmask, on a window of 64 so that the busiest lane is nearer the
//   mean), and the two pairs' loads, rsqrt and table reads overlap.  The
//   nine column partials of a row are summed in column order through
//   shared memory, and the cells' energies row by row: deterministic.
//   56 registers a thread, so that four blocks (36 warps) fit an SM where
//   the shared memory allows.

#include "pair_physics.cuh"

namespace {

constexpr int COLS = 9;                   // (dx, dy) columns of the stencil
constexpr int THREADS = COLS * 32;        // a warp per column
constexpr int NZ_MAX = 8;                 // cells a block along z
constexpr int E_MAX = COLS * (NZ_MAX + 2);  // staged cells a block
constexpr int OWN_COL = 4;                // the column (dx, dy) = (0, 0)
constexpr int WIN = 64;                   // j atoms tested, then their physics

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
    int cap, nz, d0, d1, d2;
    aztotmd::PairConsts c;
};

// A block's static shared memory: the staged cells' scan and the sums.
struct Scratch {
    int start[E_MAX + 1];         // first staged atom of each staged cell
    int cell[E_MAX];              // its table cell
    unsigned char code[E_MAX];    // its image shift (13: none)
    float part[5][COLS][32];      // a row batch's column sums
    float row[2][32];             // a row batch's energies
    float ecell[2][NZ_MAX];       // the run's cell energies
    int shifted;                  // a staged cell lies across a face
};

// Dynamic shared memory: the staged atoms as float4 and their types, for
// 9 columns of nz + 2 cells of cap slots, then the parameter tables.
size_t smem_bytes(int nsp, int cap, int nz) {
    return static_cast<size_t>(COLS) * (nz + 2) * cap
               * (sizeof(float4) + sizeof(int))
           + aztotmd::table_bytes(nsp, false);
}

// Staged cell e of the block whose run starts at cell (cx, cy, cz0) with
// `per` cells a column: its table cell, and its periodic image shift in
// units of the box (-1, 0, +1 per axis) packed as a base-3 code (13: none).
__device__ __forceinline__ int staged_cell(const Args& a, int e, int per,
                                           int cx, int cy, int cz0,
                                           int& code) {
    const int col = e / per;
    int nx = cx + col / 3 - 1, ny = cy + col % 3 - 1,
        nz = cz0 + e % per - 1;
    int wx = 0, wy = 0, wz = 0;
    if (nx < 0) { nx += a.d0; wx = -1; }
    else if (nx >= a.d0) { nx -= a.d0; wx = 1; }
    if (ny < 0) { ny += a.d1; wy = -1; }
    else if (ny >= a.d1) { ny -= a.d1; wy = 1; }
    if (nz < 0) { nz += a.d2; wz = -1; }
    else if (nz >= a.d2) { nz -= a.d2; wz = 1; }
    code = (wx + 1) * 9 + (wy + 1) * 3 + (wz + 1);
    return (nx * a.d1 + ny) * a.d2 + nz;
}

// Staged cell holding staged atom `idx`: the last e < n with start[e] <=
// idx (empty cells share their start with the next one).
__device__ __forceinline__ int find_cell(const int* start, int n, int idx) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (start[mid] <= idx) lo = mid; else hi = mid - 1;
    }
    return lo;
}

__global__ void __launch_bounds__(THREADS, 4) cellblock_kernel(const Args a) {
    extern __shared__ float4 s_p[];           // staged atoms, types, tables
    __shared__ Scratch sc;

    // the full runs of every (x, y) column first, then their last runs,
    // which are shorter when nz does not divide d2: the last wave of blocks
    // is the lightest
    const int cap = a.cap, nz = a.nz;
    const int runs = (a.d2 + nz - 1) / nz;
    const int n_full = a.d0 * a.d1 * (runs - 1);
    const int b = blockIdx.x;
    const int col_id = b < n_full ? b / (runs - 1) : b - n_full;
    const int cx = col_id / a.d1, cy = col_id % a.d1;
    const int cz0 = (b < n_full ? b % (runs - 1) : runs - 1) * nz;
    const int n_own = min(nz, a.d2 - cz0);    // the run's own cells
    const int per = n_own + 2;                // staged cells a column
    const int n_e = COLS * per;
    int* s_t = reinterpret_cast<int*>(s_p + COLS * (nz + 2) * cap);
    float* s_tab = reinterpret_cast<float*>(s_t + COLS * (nz + 2) * cap);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    aztotmd::load_tables(s_tab, a.params, a.kinds, a.c.nsp * a.c.nsp);
    if (threadIdx.x < 2 * NZ_MAX)
        sc.ecell[threadIdx.x / NZ_MAX][threadIdx.x % NZ_MAX] = 0.0f;

    // the staged cells' counts, scanned by warp 0 (up to 3 cells a lane)
    if (warp == 0) {
        const int m = (n_e + 31) / 32;
        int n[3] = {0, 0, 0}, sum = 0;
        bool shifted = false;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const int e = lane * m + q;
            if (q < m && e < n_e) {
                int code;
                const int cell = staged_cell(a, e, per, cx, cy, cz0, code);
                sc.cell[e] = cell;
                sc.code[e] = static_cast<unsigned char>(code);
                n[q] = a.cnt[cell];
                sum += n[q];
                shifted |= code != 13 && n[q] > 0;
            }
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(aztotmd::FULL, incl, o);
            if (lane >= o) incl += v;
        }
        int run = incl - sum;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const int e = lane * m + q;
            if (q < m && e < n_e) {
                sc.start[e] = run;
                run += n[q];
            }
        }
        if (lane == 31) sc.start[n_e] = incl;
        const bool any = __any_sync(aztotmd::FULL, shifted);
        if (lane == 0) sc.shifted = any;
    }
    __syncthreads();

    // stage every filled slot of the staged cells in one pass
    const int total = sc.start[n_e];
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
        const int e = find_cell(sc.start, n_e, idx);
        const int src = sc.cell[e] * cap + (idx - sc.start[e]);
        aztotmd::cp_async4(&s_p[idx].x, a.x + src);
        aztotmd::cp_async4(&s_p[idx].y, a.y + src);
        aztotmd::cp_async4(&s_p[idx].z, a.z + src);
        if (a.c.use_radii)
            aztotmd::cp_async4(&s_p[idx].w, a.radii + src);
        else
            s_p[idx].w = 1.0f;
        aztotmd::cp_async4(s_t + idx, a.types + src);
    }
    aztotmd::cp_async_commit();
    aztotmd::cp_async_wait_all();
    if (sc.shifted) {                         // images across a face
        for (int idx = threadIdx.x; idx < total; idx += THREADS) {
            const int code = sc.code[find_cell(sc.start, n_e, idx)];
            if (code == 13) continue;
            s_p[idx].x += (code / 9 - 1) * a.c.bx;
            s_p[idx].y += (code / 3 % 3 - 1) * a.c.by;
            s_p[idx].z += (code % 3 - 1) * a.c.bz;
        }
    }
    __syncthreads();

    // warp `warp` takes stencil column `warp` for 32 own atoms at a time
    const int e_own = OWN_COL * per + 1;      // the run's first own cell
    const int own_begin = sc.start[e_own];
    const int n_rows = sc.start[e_own + n_own] - own_begin;
    for (int r0 = 0; r0 < n_rows; r0 += 32) {
        const int ii = own_begin + r0 + lane;  // staged index of the i atom
        const bool act = r0 + lane < n_rows;
        int k = 0;                             // its own cell in the run
        while (k + 1 < n_own && sc.start[e_own + k + 1] <= ii) ++k;
        float fx = 0.0f, fy = 0.0f, fz = 0.0f, ev = 0.0f, ec = 0.0f;
        if (act) {
            const float4 pi = s_p[ii];
            const int ti = s_t[ii];
            const int j_lo = sc.start[warp * per + k];
            const int j_hi = sc.start[warp * per + k + 3];
            for (int k0 = j_lo; k0 < j_hi; k0 += WIN) {
                const int kn = min(WIN, j_hi - k0);
                // one bit per j atom of the window in range
                unsigned long long near = 0;
#pragma unroll 8
                for (int u = 0; u < kn; ++u) {
                    const float4 p = s_p[k0 + u];
                    const float dx = pi.x - p.x, dy = pi.y - p.y,
                                dz = pi.z - p.z;
                    const float r2 = dx * dx + dy * dy + dz * dz;
                    near |= static_cast<unsigned long long>(r2 <= a.c.r2_max)
                            << u;
                }
                if (static_cast<unsigned>(ii - k0) < unsigned{WIN})
                    near &= ~(1ull << (ii - k0));   // the self pair
                // two pairs at a time: the card overlaps their latencies,
                // and their sums are taken one after the other
                while (near) {
                    const int ja = k0 + __ffsll(near) - 1;
                    near &= near - 1;
                    const bool two = near != 0;
                    const int jb = two ? k0 + __ffsll(near) - 1 : ja;
                    near &= near - 1;
                    const float4 pa = s_p[ja], pb = s_p[jb];
                    const float dxa = pi.x - pa.x, dya = pi.y - pa.y,
                                dza = pi.z - pa.z;
                    const float dxb = pi.x - pb.x, dyb = pi.y - pb.y,
                                dzb = pi.z - pb.z;
                    const float r2a = dxa * dxa + dya * dya + dza * dza;
                    const float r2b = dxb * dxb + dyb * dyb + dzb * dzb;
                    const aztotmd::PairTerms ta = aztotmd::pair_terms(
                        a.c, s_tab, ti, s_t[ja], r2a, pi.w, pa.w);
                    const aztotmd::PairTerms tb = aztotmd::pair_terms(
                        a.c, s_tab, ti, s_t[jb], r2b, pi.w, pb.w);
                    if (r2a <= a.c.r2_max)
                        aztotmd::pair_add(ta, dxa, dya, dza, fx, fy, fz, ev,
                                          ec);
                    if (two && r2b <= a.c.r2_max)
                        aztotmd::pair_add(tb, dxb, dyb, dzb, fx, fy, fz, ev,
                                          ec);
                }
            }
        }
        sc.part[0][warp][lane] = fx;
        sc.part[1][warp][lane] = fy;
        sc.part[2][warp][lane] = fz;
        sc.part[3][warp][lane] = ev;
        sc.part[4][warp][lane] = ec;
        __syncthreads();
        if (warp == 0) {
            float f[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int q = 0; q < 5; ++q)
                for (int c = 0; c < COLS; ++c) f[q] += sc.part[q][c][lane];
            if (act) {
                const size_t o = static_cast<size_t>(sc.cell[e_own + k]) * cap
                                 + (ii - sc.start[e_own + k]);
                a.frc[3 * o] = f[0];
                a.frc[3 * o + 1] = f[1];
                a.frc[3 * o + 2] = f[2];
            }
            sc.row[0][lane] = f[3];
            sc.row[1][lane] = f[4];
            __syncwarp();
            if (lane < n_own) {               // a lane per cell, rows in order
                const int rb = max(sc.start[e_own + lane] - own_begin - r0, 0);
                const int re = min(sc.start[e_own + lane + 1] - own_begin - r0,
                                   32);
                float e_v = 0.0f, e_c = 0.0f;
                for (int r = rb; r < re; ++r) {
                    e_v += sc.row[0][r];
                    e_c += sc.row[1][r];
                }
                sc.ecell[0][lane] += e_v;
                sc.ecell[1][lane] += e_c;
            }
        }
        __syncthreads();
    }

    // the run's energies, and zero force on its cells' empty slots
    if (threadIdx.x < n_own) {
        const int cell = sc.cell[e_own + threadIdx.x];
        a.ev[cell] = sc.ecell[0][threadIdx.x];
        a.ec[cell] = sc.ecell[1][threadIdx.x];
    }
    for (int q = threadIdx.x; q < n_own * cap; q += THREADS) {
        const int kc = q / cap, slot = q % cap;
        if (slot < sc.start[e_own + kc + 1] - sc.start[e_own + kc]) continue;
        const size_t o = static_cast<size_t>(sc.cell[e_own + kc]) * cap + slot;
        a.frc[3 * o] = 0.0f;
        a.frc[3 * o + 1] = 0.0f;
        a.frc[3 * o + 2] = 0.0f;
    }
}

}  // namespace

// Dynamic shared memory a block needs for these sizes: x, y, z, radius and
// type of 9 columns of nz + 2 cells of cap slots, and the parameter tables
// (ops/cellblock.py::stacked_plan computes the same).
extern "C" long aztotmd_cellblock_smem_bytes(int nsp, int cap, int nz) {
    return static_cast<long>(smem_bytes(nsp, cap, nz));
}

// Launches the pass on `stream`: one block per run of nz cells along z (1
// <= nz <= 8).  Returns cudaGetLastError() of the launch.
extern "C" int aztotmd_cellblock_f32(
    const float* x, const float* y, const float* z, const int* types,
    const float* radii, const int* cnt, const float* params,
    const int* kinds, int nsp, int cap, int nz, int d0, int d1, int d2,
    int use_radii, int elec_type,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    float r2_max, float alpha, float daipi2, float fennel_c1,
    float fennel_c2, float r_real,
    float* frc, float* ev, float* ec, void* stream) {
    if (cap < 1 || nz < 1 || nz > NZ_MAX || d0 < 3 || d1 < 3 || d2 < 3)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, y, z, types, radii, cnt, params, kinds, frc, ev, ec,
                 cap, nz, d0, d1, d2,
                 {nsp, use_radii, elec_type, bx, by, bz, ibx, iby, ibz,
                  r2_max, alpha, daipi2, fennel_c1, fennel_c2, r_real}};
    // dynamic shared memory past what is left of the default 48 KB after
    // the static part needs the opt-in
    const size_t smem = smem_bytes(nsp, cap, nz);
    if (smem + sizeof(Scratch) > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cellblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = d0 * d1 * ((d2 + nz - 1) / nz);
    cellblock_kernel<<<blocks, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
