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
// Each kernel includes this header into its own shared library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// The pass for the spot of the calling thread. beta_in / beta_out point at
// the spot's column of a (K, ld_beta) array; xty and inv_den at its column
// of (K, ld) arrays; xtx_s is XtX (K, K) in shared memory. ns(k) gives the
// neighbour sum of coordinate k (the kernel's functor: band sums from the
// carry in the fused kernel, a load in the unfused one). beta_old and the
// running numerators live in register arrays of KMAX, fully unrolled with
// k < K guards so no array is indexed at run time. Folds the spot's
// |beta_new - beta_old| and |beta_old| into dmax and amax.
template <int KMAX, class NeighbourSum>
__device__ __forceinline__ void gs_pass_spot(
    const float* __restrict__ beta_in, float* __restrict__ beta_out,
    const long long ld_beta, const float* __restrict__ xty,
    const float* __restrict__ inv_den, const long long ld,
    const float* __restrict__ xtx_s, const int K, const float lam,
    const float rho, const NeighbourSum& ns, float& dmax, float& amax)
{
    float b[KMAX];
    float r[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        if (k < K) b[k] = beta_in[k * ld_beta];

    // Prologue: r_k = C_k, in the association of the plain version.
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
            float r0 = 0.f;
#pragma unroll
            for (int i = 0; i < KMAX; ++i)
                if (i < K) r0 = __fmaf_rn(xtx_s[k * K + i], b[i], r0);
            float c = __fmaf_rn(lam, ns(k), xty[k * ld]);
            c = __fsub_rn(c, r0);
            c = __fmaf_rn(xtx_s[k * K + k], b[k], c);
            r[k] = __fsub_rn(c, rho);
        }
    }

    // Gauss-Seidel over the coordinates; r_i carries C_i - acc_i.
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
            const float num = nan_max(r[k], 0.f);
            const float delta = __fmaf_rn(num, inv_den[k * ld], -b[k]);
#pragma unroll
            for (int i = k + 1; i < KMAX; ++i)
                if (i < K) r[i] = __fmaf_rn(-xtx_s[i * K + k], delta, r[i]);
            const float nb = __fadd_rn(delta, b[k]);
            beta_out[k * ld_beta] = nb;
            dmax = nan_max(dmax, fabsf(__fsub_rn(nb, b[k])));
            amax = nan_max(amax, fabsf(b[k]));
        }
    }
}

// XtX (K, K) into shared memory; every thread of the block takes part.
__device__ __forceinline__ void load_xtx(const float* __restrict__ xtx,
                                         float* __restrict__ xtx_s,
                                         const int K)
{
    for (int i = threadIdx.x; i < K * K; i += blockDim.x) xtx_s[i] = xtx[i];
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
