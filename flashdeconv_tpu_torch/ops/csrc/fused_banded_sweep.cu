// Fused banded block-coordinate-descent sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _make_fused_banded_kernel in
// flashdeconv_tpu/ops/bcd.py (run by fused_banded_sweep there). Its plain
// PyTorch version is flashdeconv_tpu_torch/ops/bcd.py:
// fused_banded_sweep_reference; its Gauss-Seidel pass is the one of
// gs_pass.cuh, shared with cd_block_sweep.cu.
//
// What it computes, for every data column j of the transposed carry
// (K, n_solve + 2*pad), pad = h*block:
//   ns_k = sum_u mask[u, j] * beta_old[k, j + off_u]      (bands in order)
// then the Gauss-Seidel pass of gs_pass.cuh on those sums. Pad columns are
// written as zeros. Each CUDA block also writes its max |beta_new -
// beta_old| and max |beta_old| to partials[0, b] and partials[1, b]; the
// wrapper reduces those.
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
//     0 * inf would; a solve's carry is finite while its operands are).
//     Set bands add in band order from 0, so the sum equals the plain
//     version's sum of 1*x and 0*x terms bit for bit;
//   - XtX and the band offsets live in shared memory;
//   - the sweep is Jacobi across spots, so it reads one carry and writes
//     another: the caller ping-pongs two carries and nothing is in place.
//
// At 64 < K <= 256 a second kernel, fused_banded_sweep_panel_kernel, runs
// the same band sums into the panel pass of gs_pass_panel.cuh (the
// counterpart of _make_fused_banded_kernel with _gs_pass_kb_panel in
// flashdeconv_tpu/ops/bcd.py). It is bound by operations at K = 128 and
// 256 (about 3K^2 f32 operations per spot against about 16K bytes: 0.75 ms
// and 3.0 ms at 1M spots, derived, not measured). A block owns 32 spots,
// one per lane; their beta_old and delta tiles live in shared memory and
// XtX is staged 16 rows at a time (gs_pass_panel.cuh says why), so no
// thread keeps K floats in registers. Its shared memory passes 48 KB above
// K = 128, so every launch sets cudaFuncAttributeMaxDynamicSharedMemorySize
// first and returns that call's error if it fails.
// Launch: on the caller's stream, no allocation, no synchronisation.

#include "gs_pass_panel.cuh"

#define FDT_MAX_BANDS 32

struct BandOffsets {
    int v[FDT_MAX_BANDS];
};

// ns(k) of one spot: the set bands' carry values of row k, in band order.
struct BandSum {
    const float* col;  // the spot's column of the input carry
    long long ld;      // the carry's row length n_ext
    uint32_t bits;     // bit u set iff band u has an edge at this spot
    const int* off_s;  // band offsets, in shared memory
    int n_bands;

    __device__ __forceinline__ float operator()(int k) const
    {
        float s = 0.f;
        for (int u = 0; u < n_bands; ++u)
            if ((bits >> u) & 1u) s = __fadd_rn(s, col[k * ld + off_s[u]]);
        return s;
    }
};

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
    float* xtx_s = smem;                                 // K*K
    int* off_s = reinterpret_cast<int*>(smem + K * K);   // n_bands

    load_xtx(xtx, xtx_s, K);
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
        const BandSum ns{carry_in + col, n_ext, bits, off_s, n_bands};
        gs_pass_spot<KMAX>(carry_in + col, carry_out + col, n_ext,
                           xty_t + j, inv_den_t + j, n_solve, xtx_s, K, lam,
                           rho, ns, dmax, amax);
    }
    store_block_partials(dmax, amax, partials);
}

// 64 < K <= 256: a block of 256 threads sweeps FDT_TILE_SPOTS carry
// columns, lane l of every warp column blockIdx.x * 32 + l.
__global__ void __launch_bounds__(FDT_THREADS)
fused_banded_sweep_panel_kernel(const float* __restrict__ carry_in,
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
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    int* off_s = reinterpret_cast<int*>(smem + fdt_panel_smem_floats(K));
    for (int i = threadIdx.x; i < n_bands; i += blockDim.x)
        off_s[i] = offs.v[i];
    __syncthreads();

    const long long col =
        (long long)blockIdx.x * FDT_TILE_SPOTS + (threadIdx.x & 31);
    const long long j = col - pad;  // data column
    const bool valid = col < n_ext && j >= 0 && j < n_solve;
    if (col < n_ext && !valid)
        for (int k = threadIdx.x >> 5; k < K; k += FDT_THREADS / 32)
            carry_out[k * n_ext + col] = 0.f;
    uint32_t bits = 0u;
    if (valid)
        for (int u = 0; u < n_bands; ++u)
            if (masks[u * n_solve + j]) bits |= 1u << u;
    const long long c = valid ? col : 0, jj = valid ? j : 0;
    const BandSum ns{carry_in + c, n_ext, bits, off_s, n_bands};
    float dmax = 0.f, amax = 0.f;
    gs_pass_panel(carry_in + c, carry_out + c, n_ext, xty_t + jj,
                  inv_den_t + jj, n_solve, xtx, K, lam, rho, ns, valid, smem,
                  dmax, amax);
    store_block_partials(dmax, amax, partials);
}

// CUDA blocks of one sweep over n_ext carry columns at K: each writes one
// partial of each statistic.
extern "C" long long fdt_fused_banded_sweep_blocks(long long n_ext, int K)
{
    if (K > FDT_REGISTER_MAX_K)
        return (n_ext + FDT_TILE_SPOTS - 1) / FDT_TILE_SPOTS;
    return fdt_blocks(n_ext);
}

template <int KMAX>
static void launch(const float* carry_in, float* carry_out, const float* xty_t,
                   const uint8_t* masks, const float* inv_den_t,
                   const float* xtx, const BandOffsets& offs, int n_bands,
                   int K, long long n_ext, long long pad, long long n_solve,
                   float lam, float rho, float* partials, size_t smem,
                   cudaStream_t stream)
{
    const unsigned blocks = (unsigned)fdt_blocks(n_ext);
    fused_banded_sweep_kernel<KMAX><<<blocks, FDT_THREADS, smem, stream>>>(
        carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs, n_bands, K,
        n_ext, pad, n_solve, lam, rho, partials);
}

// Launches one sweep on `stream`. `partials` holds
// 2 * fdt_fused_banded_sweep_blocks(n_ext, K) floats. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fdt_fused_banded_sweep(
    const float* carry_in, float* carry_out, const float* xty_t,
    const uint8_t* masks, const float* inv_den_t, const float* xtx,
    const int* offsets, int n_bands, int K, long long n_ext, long long pad,
    long long n_solve, float lam, float rho, float* partials, void* stream)
{
    if (n_bands < 1 || n_bands > FDT_MAX_BANDS || K < 1 ||
        K > FDT_PANEL_MAX_K || n_solve < 1 || n_ext != n_solve + 2 * pad)
        return (int)cudaErrorInvalidValue;
    BandOffsets offs;
    for (int u = 0; u < FDT_MAX_BANDS; ++u)
        offs.v[u] = u < n_bands ? offsets[u] : 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (K > FDT_REGISTER_MAX_K) {
        const size_t smem = fdt_panel_smem_floats(K) * sizeof(float)
                            + FDT_MAX_BANDS * sizeof(int);
        const cudaError_t err = cudaFuncSetAttribute(
            fused_banded_sweep_panel_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        const unsigned blocks =
            (unsigned)fdt_fused_banded_sweep_blocks(n_ext, K);
        fused_banded_sweep_panel_kernel<<<blocks, FDT_THREADS, smem, s>>>(
            carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs, n_bands,
            K, n_ext, pad, n_solve, lam, rho, partials);
        return (int)cudaGetLastError();
    }
    // XtX is 16 KB at K = 64, under the 48 KB a block gets without
    // cudaFuncSetAttribute.
    const size_t smem = (size_t)K * K * sizeof(float)
                        + FDT_MAX_BANDS * sizeof(int);
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
