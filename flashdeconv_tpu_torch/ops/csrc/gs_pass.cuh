// The Gauss-Seidel coordinate pass of one spot, shared by both sweep
// kernels (fused_banded_sweep.cu and cd_block_sweep.cu) so that the fused
// and unfused banded sweeps are bitwise equal on the card.
//
// Replaces the pass both Pallas TPU kernels call in
// flashdeconv_tpu/ops/bcd.py (gs_pass, _gs_prologue, _gs_pass_kb,
// _gs_pass_kb_panel); its plain PyTorch version is
// flashdeconv_tpu_torch/ops/bcd.py:gs_pass. For one spot j, with ns_k its
// neighbour sums:
//   C_k    = Xty[k, j] + lam*ns_k - (XtX beta_old)_k + XtX[k,k]*beta_old_k - rho
//   for k in 0..K-1:
//     num_k   = max(C_k - acc_k, 0)
//     delta_k = num_k * inv_den[k, j] - beta_old_k
//     acc_i  += XtX[i, k] * delta_k                            (i > k)
//   beta_new_k = delta_k + beta_old_k
// Every multiply-add is written as an explicit __fmaf_rn / __fadd_rn /
// __fsub_rn, so the compiler contracts nothing on its own and the pass
// rounds the same way in every kernel that inlines it. The plain version
// rounds each product separately and sums XtX @ beta in its own order: the
// two agree to a few ulp, not bitwise.
//
// gs_pass_spot, the register pass, runs this at K <= FDT_REGISTER_MAX_K =
// 32, one thread a spot; above, both kernels run the panel pass of
// gs_pass_panel.cuh, which has the same association, so the crossover
// moves no bit (the g++ emulation holds the two bitwise equal at K <= 64).
// What bounds the register pass on an H100: bytes. At 1M spots and K = 20
// a sweep moves about 340 MB (kernel #1) or 400 MB (kernel #2), 0.10 and
// 0.12 ms at 3.35 TB/s; its ~3K^2 f32 operations a spot take a fifth of
// that at 67 TFLOP/s (derived counts, not measurements). Its loads are
// what a design must keep in flight: per spot K x (set bands) neighbour
// values from the carry (from L1 and L2), and K values each of beta_old,
// Xty and inv_den (and ns_rest) from device memory. What the design does
// about it:
//   - the neighbour sums are formed band-major (the functors' rows<KMAX>):
//     one set band's loads of all K rows are in flight together, so a
//     thread waits once a band, not once a band and row;
//   - the kernels stage the spot's Xty and inv_den columns into shared
//     memory (stage_column) at kernel start, so those loads are in flight
//     during the band sums without holding registers, and the
//     Gauss-Seidel loop waits on no device load; beta_old's K loads are
//     issued together;
//   - XtX and its transpose sit in shared memory zero-padded to KMAX x
//     KMAX, so the prologue (rows of XtX) and the corrections (its
//     columns, rows of the transpose) read float4 broadcasts at offsets
//     fixed at compile time;
//   - every walk down a column forms each row's address from the last one
//     (fdt_next), so no row's 64-bit address is held longer than its load;
//   - the register arrays come in steps of 8 (KMAX = 8, 16, 24, 32: K = 20
//     keeps 24 floats of each live, not 32), and __launch_bounds__ caps
//     each instance (FDT_REGISTER_MIN_BLOCKS) so that 2-4 blocks of 256
//     threads fit an SM without a spill.
//
// Each kernel includes this header into its own shared library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define FDT_THREADS 256

// max(a, b) that returns NaN when either is NaN (PTX max.NaN, sm_80+), as
// torch.clamp_min and torch.amax do; one instruction like fmaxf (a
// compare-and-select form made the 1M-spot K = 20 fused sweep 3 % slower
// on an H100). A sweep on a non-finite XtX, inv_den or lambda reports NaN
// and does not pass for converged.
__device__ __forceinline__ float nan_max(float a, float b)
{
    float m;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
}

// Largest K of gs_pass_spot; above it both kernels run the panel pass of
// gs_pass_panel.cuh.
#define FDT_REGISTER_MAX_K 32

// Blocks an SM the register kernels of KMAX (with the rest input iff REST)
// ask ptxas to fit by registers (__launch_bounds__): 4 (64 registers), 3
// (80) or 2 (128), the most at which ptxas (CUDA 12.8, sm_90a) spills
// nothing.
#define FDT_REGISTER_MIN_BLOCKS(KMAX, REST) \
    ((KMAX) <= 8 ? 4 : (KMAX) <= 16 ? ((REST) ? 3 : 4) \
     : (KMAX) <= 24 ? ((REST) ? 2 : 3) : 2)

// f(std::integral_constant<int, KMAX>{}) with KMAX = K rounded up to a
// multiple of 8, 8..FDT_REGISTER_MAX_K: the launchers' choice of the
// register pass's instance at 1 <= K <= FDT_REGISTER_MAX_K.
template <class F>
static int fdt_register_dispatch(const int K, F f)
{
    switch ((K + 7) / 8) {
    case 1: return f(std::integral_constant<int, 8>{});
    case 2: return f(std::integral_constant<int, 16>{});
    case 3: return f(std::integral_constant<int, 24>{});
    default: return f(std::integral_constant<int, 32>{});
    }
}

// p + ld, the sum hidden from the compiler (an empty asm statement that
// may change it). A walk down a column, p = fdt_next(p, ld), forms each
// row's address from the last one by one 64-bit add; without it nvcc formed
// k * ld for every row at once (about eight instructions a row) and held
// all the rows' 64-bit addresses in registers until their loads issued,
// which made the register pass spill.
template <class T>
__device__ __forceinline__ T* fdt_next(T* p, const long long ld)
{
    p += ld;
    asm volatile("" : "+l"(p));
    return p;
}

// One float from device memory into shared memory by an asynchronous copy
// (PTX cp.async, sm_80+): the load is in flight without a register, and
// copy_async_wait waits for all of the calling thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 : : "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_wait()
{
    asm volatile("cp.async.wait_all;" : : : "memory");
}

// Rows 0..K-1 of the calling thread's column of a (K, ld) operand, src
// pointing at row 0, into its column of a (K, FDT_THREADS) tile in shared
// memory, dst pointing at row 0: K asynchronous copies, issued at once.
template <int KMAX>
__device__ __forceinline__ void stage_column(float* dst, const float* src,
                                             const long long ld, const int K)
{
#pragma unroll
    for (int k = 0; k < KMAX; ++k, src = fdt_next(src, ld))
        if (k < K) copy_async(dst + k * FDT_THREADS, src);
}

// Floats of shared memory the register kernels of KMAX take at K: XtX and
// its transpose (KMAX x KMAX each) and the staged tiles of Xty and inv_den
// (K x FDT_THREADS each).
__host__ __device__ __forceinline__ int fdt_register_smem_floats(int KMAX,
                                                                 int K)
{
    return 2 * KMAX * KMAX + 2 * K * FDT_THREADS;
}

// XtX (K, K) into shared memory for gs_pass_spot<KMAX>: xs[k*KMAX + i] =
// XtX[k, i] and, after it, its transpose xs[KMAX^2 + i*KMAX + k] =
// XtX[k, i], both zero outside K x K. Every thread of the block takes part.
template <int KMAX>
__device__ __forceinline__ void load_xtx(const float* __restrict__ xtx,
                                         float* __restrict__ xs, const int K)
{
    for (int e = threadIdx.x; e < KMAX * KMAX; e += blockDim.x) {
        const int k = e / KMAX, i = e % KMAX;
        const float v = (k < K && i < K) ? xtx[k * K + i] : 0.f;
        xs[e] = v;
        xs[KMAX * KMAX + i * KMAX + k] = v;
    }
}

// The pass for the spot of the calling thread. beta_in / beta_out point at
// the spot's column of a (K, ld_in) / (K, ld_out) array (the two differ in
// the fused kernel's sub-range form); xty and inv_den at its column of
// (K, ld) arrays: in device memory, or in the tiles stage_column fills,
// whose copies the pass waits for before it reads them. xs is load_xtx's
// XtX and transpose. ns.rows<KMAX>(0, 1, K, s) gives the neighbour sums of
// rows 0..K-1 (the kernel's functor: band sums from the carry in the fused
// kernel, loads in the unfused one), each band's loads of all K rows in
// flight together. beta_old and the running numerators live in register
// arrays of KMAX, K rounded up to 8, fully unrolled, so no array is
// indexed at run time. The XtX . beta_old products run over all KMAX
// columns: the padding (zero XtX, zero beta_old) adds exact zeros, since
// r0 starts at +0 and a sum of +0 and -0 is +0, so the bits are those of
// the sum over i < K. Folds the spot's |beta_new - beta_old| and
// |beta_old| into dmax and amax.
template <int KMAX, class NeighbourSum>
__device__ __forceinline__ void gs_pass_spot(
    const float* __restrict__ beta_in, const long long ld_in,
    float* __restrict__ beta_out, const long long ld_out,
    const float* __restrict__ xty,
    const float* __restrict__ inv_den, const long long ld,
    const float* __restrict__ xs, const int K, const float lam,
    const float rho, const NeighbourSum& ns, float& dmax, float& amax)
{
    static_assert(KMAX % 4 == 0, "XtX rows are read as float4");
    constexpr int Q = KMAX / 4;
    const float4* xr = reinterpret_cast<const float4*>(xs);  // XtX rows
    const float4* xc = xr + KMAX * Q;                        // its columns

    // r_k = ns_k, band-major; beta_old, K loads in flight, after the band
    // sums so that its registers are not live during them; then
    // r_k = lam*ns_k + Xty_k.
    float r[KMAX];
    ns.template rows<KMAX>(0, 1, K, r);
    copy_async_wait();
    float b[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k, beta_in = fdt_next(beta_in, ld_in))
        b[k] = k < K ? *beta_in : 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        if (k < K) r[k] = __fmaf_rn(lam, r[k], xty[k * ld]);

    // Prologue: r_k = C_k, in the association of the plain version. Each
    // row here, and each coordinate below, starts with a branch on k
    // (uniform across the block): the rows past K cost nothing, and each
    // row's XtX loads stay in a block of its own (measured faster for
    // kernel #1 than one predicated block, PERF.md).
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        float r0 = 0.f, xkk = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const float4 v = xr[k * Q + q];
            r0 = __fmaf_rn(v.x, b[4 * q], r0);
            r0 = __fmaf_rn(v.y, b[4 * q + 1], r0);
            r0 = __fmaf_rn(v.z, b[4 * q + 2], r0);
            r0 = __fmaf_rn(v.w, b[4 * q + 3], r0);
            if (q == k / 4)
                xkk = k % 4 == 0 ? v.x : k % 4 == 1 ? v.y
                      : k % 4 == 2 ? v.z : v.w;
        }
        float c = __fsub_rn(r[k], r0);
        c = __fmaf_rn(xkk, b[k], c);
        r[k] = __fsub_rn(c, rho);
    }

    // Gauss-Seidel over the coordinates; r_i carries C_i - acc_i. Column k
    // of XtX is row k of the transpose; rows i >= K take corrections (by
    // zero XtX) that nothing reads.
#pragma unroll
    for (int k = 0; k < KMAX; ++k, beta_out = fdt_next(beta_out, ld_out)) {
        if (k >= K) break;
        const float num = nan_max(r[k], 0.f);
        const float delta = __fmaf_rn(num, inv_den[k * ld], -b[k]);
#pragma unroll
        for (int q = (k + 1) / 4; q < Q; ++q) {
            const float4 v = xc[k * Q + q];
            if (4 * q > k) r[4 * q] = __fmaf_rn(-v.x, delta, r[4 * q]);
            if (4 * q + 1 > k)
                r[4 * q + 1] = __fmaf_rn(-v.y, delta, r[4 * q + 1]);
            if (4 * q + 2 > k)
                r[4 * q + 2] = __fmaf_rn(-v.z, delta, r[4 * q + 2]);
            r[4 * q + 3] = __fmaf_rn(-v.w, delta, r[4 * q + 3]);
        }
        const float nb = __fadd_rn(delta, b[k]);
        *beta_out = nb;
        dmax = nan_max(dmax, fabsf(__fsub_rn(nb, b[k])));
        amax = nan_max(amax, fabsf(b[k]));
    }
}

// Block reduction of the two statistics, warp shuffles first, then one
// partial of each per block: partials[b] (max |delta|) and
// partials[gridDim.x + b] (max |beta_old|). Every thread calls it.
__device__ __forceinline__ void store_block_partials(float dmax, float amax,
                                                     float* __restrict__ partials)
{
    __shared__ float red[2][FDT_THREADS / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        dmax = nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
        amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[0][warp] = dmax;
        red[1][warp] = amax;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float d = 0.f, a = 0.f;
        for (int w = 0; w < FDT_THREADS / 32; ++w) {
            d = nan_max(d, red[0][w]);
            a = nan_max(a, red[1][w]);
        }
        partials[blockIdx.x] = d;
        partials[gridDim.x + blockIdx.x] = a;
    }
}

// Blocks of one launch over n columns, one thread per column.
static inline long long fdt_blocks(long long n)
{
    return (n + FDT_THREADS - 1) / FDT_THREADS;
}

extern "C" const char* fdt_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
