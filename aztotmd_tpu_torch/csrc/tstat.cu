// Radiative thermostat for Hopper (sm_90a): one step of photon exchange
// for every atom, with its counter-keyed noise, f32 and f64.
//
// Replaces no TPU kernel: the JAX package computes this stage in XLA
// (aztotmd_tpu/ops/thermostat.py::tstat_radiative), which fuses it on its
// own; it has no Pallas kernel.  The port's torch-ops copy,
// ops/thermostat.py::tstat_radiative_plain, runs some 230 small kernels a
// step, 124 of them the murmur3 words of ops/prng.py::counter_bits2 held
// in int64 (torch has no uint32 arithmetic).  This kernel does the whole
// stage in one pass over the atoms.
//
// Bound on the H100: bytes.  Each atom reads its velocity, internal
// energy, type and photon and writes its velocity, internal energy and
// thermal radius: ~44 bytes an atom in f32, 0.18 MB at 4,000 atoms and
// 47.5 MB at 1.08M atoms (~14 us at 3.35 TB/s).  The arithmetic (four
// murmur3 mixes, two sincos, a few square roots) is some 150 operations
// an atom, far below the card's rate.  The design:
//
// - One thread an atom, grid-stride; nothing but the outputs is written
//   to device memory.  The per-species tables are read through the
//   read-only cache (__ldg): a handful of values that every thread reads.
// - The counters are read from device memory: `step` (int32) and the seed
//   word rng[n_rng - 1].  A captured graph replays the same launch with an
//   advancing step, so neither may be a host argument.  Thread 0 of block
//   0 writes the advanced words, rng[0] + GOLD mod 2^32 and the others as
//   they are, into `rng_out`.
// - Native uint32 arithmetic for the words: they equal
//   ops/prng.py::counter_bits2's (and so the JAX package's) bit for bit.
// - The float chain repeats the plain version's operations in its order,
//   each an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
//   __fdiv_rn, __fsqrt_rn and their double forms), so nvcc contracts
//   nothing into an FMA; rsqrt, cos and sin are the CUDA math library's
//   (no fast math), as torch's CUDA kernels call them.  The 3-sums are
//   taken (x^2 + z^2) + y^2, the order of torch's CUDA reduction over a
//   last axis of 3 (read off the card: a shuffle tree over the lanes), so
//   v0^2, ermc/v0 and cos_phi are the plain version's bit for bit on the
//   card.  That matters: where ermc/v0 lies just under 1, sin_phi =
//   sqrt(1 - cos_phi^2) turns one ulp of v0^2 into ~1e-4 of the emitted
//   kick.  torch's cross product contracts a * b - c * d into an FMA and
//   this kernel does not, so the two differ by an ulp there.
// - The sum of the internal energies is not taken here: the wrapper takes
//   torch.sum of the kernel's `engs_out`, as the plain version does, so
//   the run stays deterministic (no float atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 8192;
constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr uint32_t C1 = 0x85EBCA6Bu;
constexpr uint32_t C2 = 0xC2B2AE35u;
constexpr uint32_t PHOTON_STRIDE = 2654435761u;
constexpr double REV_LIGHT = 3.33567e-5;          // 1/c, ps/A
constexpr double TWO_PI = 6.283185307179586;      // 2 * math.pi
constexpr double RADIATE_ABOVE = 1e-4;            // eV
constexpr double TINY = 1e-30;

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
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }

// murmur3 fmix32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= C1;
    x ^= x >> 13;
    x *= C2;
    return x ^ (x >> 16);
}

// x^2 + y^2 + z^2 in torch's CUDA order
template <typename T>
__device__ __forceinline__ T dot3(T x, T y, T z) {
    return add_rn(add_rn(mul_rn(x, x), mul_rn(z, z)), mul_rn(y, y));
}

template <typename T>
struct Args {
    const T* vel;            // (n, 3)
    const T* engs;           // (n,)
    const int* types;        // (n,)
    const T* photons;        // (n_photon,)
    const T* mass;           // (nsp,) spec_mass
    const T* mx_eng;         // (nsp,) spec_mx_eng
    const T* rad_a;          // (nsp,) spec_rad_a
    const T* rad_b;          // (nsp,) spec_rad_b
    const long long* rng;    // (n_rng,) uint32 words in int64
    const int* step;         // () int32
    const int* gid;          // (n,) global ids, or null: the row index
    const unsigned char* valid;   // (n,) filled slots, or null: all
    T* vel_out;              // (n, 3)
    T* engs_out;             // (n,)
    T* radii_out;            // (n,)
    long long* rng_out;      // (n_rng,)
    int n, n_photon, n_rng;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) tstat_radiative_kernel(Args<T> a) {
    const uint32_t step = static_cast<uint32_t>(*a.step);
    const uint32_t seed = static_cast<uint32_t>(a.rng[a.n_rng - 1]);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.rng_out[0] = static_cast<long long>(
            static_cast<uint32_t>(a.rng[0]) + GOLD);
        for (int k = 1; k < a.n_rng; ++k) a.rng_out[k] = a.rng[k];
    }
    const uint32_t s = mix32(seed ^ (step * GOLD));
    const unsigned long long shift = (step * PHOTON_STRIDE) % a.n_photon;

    const T rev_light = T(REV_LIGHT), two_pi = T(TWO_PI);
    const T one = T(1), two = T(2), half = T(0.5), tiny = T(TINY);
    const T u16 = T(1.0 / 65536.0);

    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
         i += gridDim.x * blockDim.x) {
        const uint32_t g = a.gid ? static_cast<uint32_t>(a.gid[i])
                                 : static_cast<uint32_t>(i);
        const bool ok = a.valid ? a.valid[i] != 0 : true;
        const int t = a.types[i];
        const T m = __ldg(a.mass + t);

        // counter-keyed words and four 16-bit uniforms
        const uint32_t h = mix32(g * C2 + s);
        const uint32_t w0 = mix32(h ^ GOLD), w1 = mix32(h + C1);
        const T u0 = mul_rn(T(w0 & 0xFFFFu), u16);
        const T u1 = mul_rn(T(w1 & 0xFFFFu), u16);
        const T u2 = mul_rn(T(w0 >> 16), u16);
        const T u3 = mul_rn(T(w1 >> 16), u16);

        // the rotating photon
        T pe = a.photons[(static_cast<unsigned long long>(g) + shift)
                         % a.n_photon];
        if (!ok) pe = T(0);

        // --- absorb ---
        T vx = a.vel[3 * i], vy = a.vel[3 * i + 1], vz = a.vel[3 * i + 2];
        T e = a.engs[i];
        const T v02a = dot3(vx, vy, vz);
        const T z = sub_rn(mul_rn(two, u0), one);
        const T rho = sqrt_rn(fmax(sub_rn(one, mul_rn(z, z)), T(0)));
        const T phi = mul_rn(two_pi, u1);
        const T k_abs = div_rn(mul_rn(pe, rev_light), m);
        vx = add_rn(vx, mul_rn(k_abs, mul_rn(rho, cos_(phi))));
        vy = add_rn(vy, mul_rn(k_abs, mul_rn(rho, sin_(phi))));
        vz = add_rn(vz, mul_rn(k_abs, z));
        const T v02 = dot3(vx, vy, vz);
        e = add_rn(add_rn(e, pe), mul_rn(mul_rn(half, m), sub_rn(v02a, v02)));

        // --- radiate, momentum-biased ---
        if (e > T(RADIATE_ABOVE)) {
            const T rv0 = rsqrt_(fmax(v02, tiny));
            const T ph = mul_rn(T(0.9), e);
            const T ermc = div_rn(mul_rn(ph, rev_light), m);
            const T ermcv0 = mul_rn(ermc, rv0);
            const T cos_phi = ermcv0 >= one ? -one
                : sub_rn(mul_rn(mul_rn(u2, two), sub_rn(one, fmin(ermcv0, one))),
                         one);
            const T theta = mul_rn(two_pi, u3);
            // unit vector at acos(cos_phi) from v, rotated by theta around
            // it: v1 = v/|v|, v2 = v1 x e_k (k the smallest |v1_k|, the
            // first on a tie), v3 = v1 x v2
            const T rn1 = rsqrt_(add_rn(v02, tiny));
            const T ax = mul_rn(vx, rn1), ay = mul_rn(vy, rn1),
                    az = mul_rn(vz, rn1);
            const T fx = fabs(ax), fy = fabs(ay), fz = fabs(az);
            T bx, by, bz;
            if (fx <= fy && fx <= fz) {
                bx = T(0); by = az; bz = -ay;
            } else if (fy <= fz) {
                bx = -az; by = T(0); bz = ax;
            } else {
                bx = ay; by = -ax; bz = T(0);
            }
            const T rn2 = rsqrt_(add_rn(dot3(bx, by, bz), tiny));
            bx = mul_rn(bx, rn2); by = mul_rn(by, rn2); bz = mul_rn(bz, rn2);
            const T cx = sub_rn(mul_rn(ay, bz), mul_rn(az, by));
            const T cy = sub_rn(mul_rn(az, bx), mul_rn(ax, bz));
            const T cz = sub_rn(mul_rn(ax, by), mul_rn(ay, bx));
            const T sin_phi = sqrt_rn(fmax(sub_rn(one, mul_rn(cos_phi, cos_phi)),
                                           T(0)));
            const T ct = cos_(theta), st = sin_(theta);
            const T rx = add_rn(mul_rn(ax, cos_phi),
                                mul_rn(sin_phi, add_rn(mul_rn(ct, bx), mul_rn(st, cx))));
            const T ry = add_rn(mul_rn(ay, cos_phi),
                                mul_rn(sin_phi, add_rn(mul_rn(ct, by), mul_rn(st, cy))));
            const T rz = add_rn(mul_rn(az, cos_phi),
                                mul_rn(sin_phi, add_rn(mul_rn(ct, bz), mul_rn(st, cz))));
            vx = add_rn(vx, mul_rn(ermc, rx));
            vy = add_rn(vy, mul_rn(ermc, ry));
            vz = add_rn(vz, mul_rn(ermc, rz));
            const T v12 = dot3(vx, vy, vz);
            e = sub_rn(e, add_rn(ph, mul_rn(mul_rn(half, m), sub_rn(v12, v02))));
        }

        // --- thermal radius ---
        const T rest = fmin(e, __ldg(a.mx_eng + t));
        T radius = div_rn(__ldg(a.rad_a + t), sub_rn(__ldg(a.rad_b + t), rest));
        if (!ok) {
            e = T(0);
            radius = one;
        }
        a.vel_out[3 * i] = vx;
        a.vel_out[3 * i + 1] = vy;
        a.vel_out[3 * i + 2] = vz;
        a.engs_out[i] = e;
        a.radii_out[i] = radius;
    }
}

template <typename T>
int launch(const T* vel, const T* engs, const int* types, const T* photons,
           const T* mass, const T* mx_eng, const T* rad_a, const T* rad_b,
           const long long* rng, const int* step, const int* gid,
           const unsigned char* valid, int n, int n_photon, int n_rng,
           T* vel_out, T* engs_out, T* radii_out, long long* rng_out,
           void* stream) {
    Args<T> a{vel, engs, types, photons, mass, mx_eng, rad_a, rad_b, rng,
              step, gid, valid, vel_out, engs_out, radii_out, rng_out, n,
              n_photon, n_rng};
    // at least one block: the rng words advance with no atom at all
    const int blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
    tstat_radiative_kernel<T><<<blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS,
                                THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One radiative-thermostat step of `n` atoms on `stream`: writes the
// velocities, internal energies and thermal radii after it and the
// advanced rng words; `gid` and `valid` may be null (row ids, all rows
// filled).  Returns cudaGetLastError() of the launch.
extern "C" int aztotmd_tstat_radiative_f32(
    const float* vel, const float* engs, const int* types,
    const float* photons, const float* mass, const float* mx_eng,
    const float* rad_a, const float* rad_b, const long long* rng,
    const int* step, const int* gid, const unsigned char* valid, int n,
    int n_photon, int n_rng, float* vel_out, float* engs_out,
    float* radii_out, long long* rng_out, void* stream) {
    return launch<float>(vel, engs, types, photons, mass, mx_eng, rad_a,
                         rad_b, rng, step, gid, valid, n, n_photon, n_rng,
                         vel_out, engs_out, radii_out, rng_out, stream);
}

extern "C" int aztotmd_tstat_radiative_f64(
    const double* vel, const double* engs, const int* types,
    const double* photons, const double* mass, const double* mx_eng,
    const double* rad_a, const double* rad_b, const long long* rng,
    const int* step, const int* gid, const unsigned char* valid, int n,
    int n_photon, int n_rng, double* vel_out, double* engs_out,
    double* radii_out, long long* rng_out, void* stream) {
    return launch<double>(vel, engs, types, photons, mass, mx_eng, rad_a,
                          rad_b, rng, step, gid, valid, n, n_photon, n_rng,
                          vel_out, engs_out, radii_out, rng_out, stream);
}
