// Fused banded block-coordinate-descent sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _make_fused_banded_kernel in
// flashdeconv_tpu/ops/bcd.py (run by fused_banded_sweep there), together
// with the Gauss-Seidel pass it calls (gs_pass, _gs_prologue, _gs_pass_kb,
// _gs_pass_kb_panel). Its plain PyTorch version is
// flashdeconv_tpu_torch/ops/bcd.py:fused_banded_sweep_reference.
//
// What it computes, for every data column j of the transposed carry
// (K, n_solve + 2*pad), pad = h*block:
//   ns_k   = sum_u mask[u, j] * beta_old[k, j + off_u]       (bands in order)
//   C_k    = Xty[k, j] + lam*ns_k - (XtX beta_old)_k + XtX[k,k]*beta_old_k - rho
//   for k in 0..K-1 (Gauss-Seidel within the spot):
//     num_k   = max(C_k - acc_k, 0)
//     delta_k = num_k * inv_den[k, j] - beta_old_k
//     acc_i  += XtX[i, k] * delta_k                            (i > k)
//   beta_new_k = delta_k + beta_old_k
// Pad columns are written as zeros. Each CUDA block also writes its
// max |beta_new - beta_old| and max |beta_old| to partials[0, b] and
// partials[1, b]; the wrapper reduces those.
//
// What bounds it: bytes. At 1M spots, K = 20 and 18 bands one sweep reads
// the carry (80 MB), Xty (80 MB), inv_den (80 MB) and the uint8 masks
// (18 MB) and writes the new carry (80 MB): about 340 MB, or about 0.1 ms
// at 3.35 TB/s (a derived count, not a measurement). The arithmetic,
// about K*(K + U) multiply-adds per spot, is far below the card's rate.
// What the design does about it:
//   - one thread per carry column, so a warp's loads of one row k touch 32
//     neighbouring floats; every stream is read once and the new carry is
//     written once, with no intermediate in device memory;
//   - the neighbour reads beta_old[k, j + off] come straight from the input
//     carry: the near bands (+-1, +-2) hit lines the warp is loading anyway,
//     and the far bands (+-side, +-2*side) lie a few hundred KB away per
//     row and are served from the 50 MB L2 rather than device memory;
//   - the band masks are read once per spot and kept as one 32-bit word,
//     and a band whose bit is clear costs no load (so a non-finite value
//     behind a clear bit does not reach ns, where the plain version's
//     0 * inf would; a solve's carry is finite while its operands are);
//   - beta_old and the running numerators live in registers (arrays sized by
//     the template parameter KMAX, fully unrolled so no array is indexed at
//     run time); XtX and the band offsets live in shared memory;
//   - the sweep is Jacobi across spots, so it reads one carry and writes
//     another: the caller ping-pongs two carries and nothing is in place.
// NaN propagates as in the plain version (torch.clamp_min, torch.amax):
// the clamp and the maxima below keep a NaN operand where fmaxf drops it,
// so a sweep on a non-finite XtX, inv_den or lambda reports NaN and does
// not pass for converged.
// Launch: on the caller's stream, no allocation, no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#define FDT_MAX_BANDS 32
#define FDT_THREADS 256

struct BandOffsets {
    int v[FDT_MAX_BANDS];
};

// max(a, b) that returns NaN when either is NaN: PTX max.NaN (sm_80+), one
// instruction like fmaxf; a compare-and-select form made the 1M-spot K = 20
// sweep 3 % slower on an H100.
__device__ __forceinline__ float nan_max(float a, float b)
{
    float m;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
}

template <int KMAX>
__global__ void __launch_bounds__(FDT_THREADS)
fused_banded_sweep_kernel(const float* __restrict__ carry_in,
                          float* __restrict__ carry_out,
                          const float* __restrict__ xty_t,
                          const uint8_t* __restrict__ masks,
                          const float* __restrict__ inv_den_t,
                          const float* __restrict__ xtx,
                          const BandOffsets offs, const int n_bands,
                          const int K, const long long n_ext,
                          const long long pad, const long long n_solve,
                          const float lam, const float rho,
                          float* __restrict__ partials)
{
    extern __shared__ float smem[];
    float* xtx_s = smem;                          // K*K
    int* off_s = reinterpret_cast<int*>(smem + K * K);   // n_bands
    __shared__ float red[2][FDT_THREADS / 32];

    for (int i = threadIdx.x; i < K * K; i += blockDim.x) xtx_s[i] = xtx[i];
    for (int i = threadIdx.x; i < n_bands; i += blockDim.x)
        off_s[i] = offs.v[i];
    __syncthreads();

    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long j = col - pad;              // data column
    float dmax = 0.f, amax = 0.f;

    if (col < n_ext && (j < 0 || j >= n_solve)) {
        for (int k = 0; k < K; ++k) carry_out[k * n_ext + col] = 0.f;
    } else if (col < n_ext) {
        uint32_t bits = 0u;
        for (int u = 0; u < n_bands; ++u)
            if (masks[u * n_solve + j]) bits |= 1u << u;

        float b[KMAX];
        float r[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
            if (k < K) b[k] = carry_in[k * n_ext + col];

        // Prologue: r_k = C_k, in the association of the plain version.
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
                float ns = 0.f;
                for (int u = 0; u < n_bands; ++u)
                    if ((bits >> u) & 1u)
                        ns += carry_in[k * n_ext + col + off_s[u]];
                float r0 = 0.f;
#pragma unroll
                for (int i = 0; i < KMAX; ++i)
                    if (i < K) r0 = fmaf(xtx_s[k * K + i], b[i], r0);
                r[k] = (xty_t[k * n_solve + j] + lam * ns - r0
                        + xtx_s[k * K + k] * b[k]) - rho;
            }
        }

        // Gauss-Seidel over the coordinates; r_i carries C_i - acc_i.
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
                const float num = nan_max(r[k], 0.f);
                const float delta = num * inv_den_t[k * n_solve + j] - b[k];
#pragma unroll
                for (int i = k + 1; i < KMAX; ++i)
                    if (i < K) r[i] -= xtx_s[i * K + k] * delta;
                const float nb = delta + b[k];
                carry_out[k * n_ext + col] = nb;
                dmax = nan_max(dmax, fabsf(nb - b[k]));
                amax = nan_max(amax, fabsf(b[k]));
            }
        }
    }

    // Block reduction of the two statistics: warp shuffles, then one
    // partial per block.
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

// CUDA blocks of one sweep over n_ext carry columns: each writes one
// partial of each statistic.
extern "C" long long fdt_fused_banded_sweep_blocks(long long n_ext)
{
    return (n_ext + FDT_THREADS - 1) / FDT_THREADS;
}

template <int KMAX>
static void launch(const float* carry_in, float* carry_out, const float* xty_t,
                   const uint8_t* masks, const float* inv_den_t,
                   const float* xtx, const BandOffsets& offs, int n_bands,
                   int K, long long n_ext, long long pad, long long n_solve,
                   float lam, float rho, float* partials, size_t smem,
                   cudaStream_t stream)
{
    const unsigned blocks = (unsigned)fdt_fused_banded_sweep_blocks(n_ext);
    fused_banded_sweep_kernel<KMAX><<<blocks, FDT_THREADS, smem, stream>>>(
        carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs, n_bands, K,
        n_ext, pad, n_solve, lam, rho, partials);
}

// Launches one sweep on `stream`. `partials` holds
// 2 * fdt_fused_banded_sweep_blocks(n_ext) floats. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int fdt_fused_banded_sweep(
    const float* carry_in, float* carry_out, const float* xty_t,
    const uint8_t* masks, const float* inv_den_t, const float* xtx,
    const int* offsets, int n_bands, int K, long long n_ext, long long pad,
    long long n_solve, float lam, float rho, float* partials, void* stream)
{
    if (n_bands < 1 || n_bands > FDT_MAX_BANDS || K < 1 || K > 64 ||
        n_solve < 1 || n_ext != n_solve + 2 * pad)
        return (int)cudaErrorInvalidValue;
    BandOffsets offs;
    for (int u = 0; u < FDT_MAX_BANDS; ++u)
        offs.v[u] = u < n_bands ? offsets[u] : 0;
    // XtX is 16 KB at K = 64, under the 48 KB a block gets without
    // cudaFuncSetAttribute.
    const size_t smem = (size_t)K * K * sizeof(float)
                        + FDT_MAX_BANDS * sizeof(int);
    cudaStream_t s = (cudaStream_t)stream;
    if (K <= 8)
        launch<8>(carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs,
                  n_bands, K, n_ext, pad, n_solve, lam, rho, partials,
                  smem, s);
    else if (K <= 16)
        launch<16>(carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs,
                   n_bands, K, n_ext, pad, n_solve, lam, rho, partials,
                   smem, s);
    else if (K <= 32)
        launch<32>(carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs,
                   n_bands, K, n_ext, pad, n_solve, lam, rho, partials,
                   smem, s);
    else
        launch<64>(carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs,
                   n_bands, K, n_ext, pad, n_solve, lam, rho, partials,
                   smem, s);
    return (int)cudaGetLastError();
}

extern "C" const char* fdt_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
