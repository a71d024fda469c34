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

// Sub-range form (the counterpart of fused_banded_sweep(sub=...) in
// flashdeconv_tpu/ops/bcd.py, which the spot-sharded banded mesh runs):
// both kernels sweep a window of n_sub + 2*pad columns that starts at
// column in_col0 of the input carry, its n_sub data columns being the data
// columns [data0, data0 + n_sub) of xty, masks and inv_den (row length
// ld_data). Window column w (0 <= w < n_sub + 2*pad) is written to column
// out_col0 + w of the output carry. The whole sweep is in_col0 = data0 =
// out_col0 = 0 and n_sub = n_solve. With write_pads the pad columns of the
// window are written as zeros (a whole sweep, or a sub-carry of its own);
// without it only the data columns are launched and written, so a split
// sweep fills one full carry without touching its pads. Every data column
// sees the same window values and runs the same per-column arithmetic
// whatever the range, so a split sweep recomposes the whole one bit for bit.
// In both kernels thread t of the launch takes window column w0 + t, w0 = 0
// with write_pads and pad without.

template <int KMAX>
__global__ void __launch_bounds__(FDT_THREADS)
fused_banded_sweep_kernel(const float* __restrict__ carry_in,
                          const long long ld_in,
                          float* __restrict__ carry_out,
                          const long long ld_out,
                          const float* __restrict__ xty_t,
                          const uint8_t* __restrict__ masks,
                          const float* __restrict__ inv_den_t,
                          const long long ld_data,
                          const float* __restrict__ xtx,
                          const BandOffsets offs, const int n_bands,
                          const int K, const long long pad,
                          const long long n_sub, const long long w0,
                          const long long n_cols, const float lam,
                          const float rho, float* __restrict__ partials)
{
    extern __shared__ float smem[];
    float* xtx_s = smem;                                 // K*K
    int* off_s = reinterpret_cast<int*>(smem + K * K);   // n_bands

    load_xtx(xtx, xtx_s, K);
    for (int i = threadIdx.x; i < n_bands; i += blockDim.x)
        off_s[i] = offs.v[i];
    __syncthreads();

    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long w = w0 + t;                 // window column
    const long long j = w - pad;                // data column of the range
    float dmax = 0.f, amax = 0.f;

    if (t < n_cols && (j < 0 || j >= n_sub)) {
        for (int k = 0; k < K; ++k) carry_out[k * ld_out + w] = 0.f;
    } else if (t < n_cols) {
        uint32_t bits = 0u;
        for (int u = 0; u < n_bands; ++u)
            if (masks[u * ld_data + j]) bits |= 1u << u;
        const BandSum ns{carry_in + w, ld_in, bits, off_s, n_bands};
        gs_pass_spot<KMAX>(carry_in + w, ld_in, carry_out + w, ld_out,
                           xty_t + j, inv_den_t + j, ld_data, xtx_s, K, lam,
                           rho, ns, dmax, amax);
    }
    store_block_partials(dmax, amax, partials);
}

// 64 < K <= 256: a block of 256 threads sweeps FDT_TILE_SPOTS window
// columns, lane l of every warp column w0 + blockIdx.x * 32 + l.
__global__ void __launch_bounds__(FDT_THREADS)
fused_banded_sweep_panel_kernel(const float* __restrict__ carry_in,
                                const long long ld_in,
                                float* __restrict__ carry_out,
                                const long long ld_out,
                                const float* __restrict__ xty_t,
                                const uint8_t* __restrict__ masks,
                                const float* __restrict__ inv_den_t,
                                const long long ld_data,
                                const float* __restrict__ xtx,
                                const BandOffsets offs, const int n_bands,
                                const int K, const long long pad,
                                const long long n_sub, const long long w0,
                                const long long n_cols, const float lam,
                                const float rho, float* __restrict__ partials)
{
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    int* off_s = reinterpret_cast<int*>(smem + fdt_panel_smem_floats(K));
    for (int i = threadIdx.x; i < n_bands; i += blockDim.x)
        off_s[i] = offs.v[i];
    __syncthreads();

    const long long t =
        (long long)blockIdx.x * FDT_TILE_SPOTS + (threadIdx.x & 31);
    const long long w = w0 + t;  // window column
    const long long j = w - pad;  // data column of the range
    const bool valid = t < n_cols && j >= 0 && j < n_sub;
    if (t < n_cols && !valid)
        for (int k = threadIdx.x >> 5; k < K; k += FDT_THREADS / 32)
            carry_out[k * ld_out + w] = 0.f;
    uint32_t bits = 0u;
    if (valid)
        for (int u = 0; u < n_bands; ++u)
            if (masks[u * ld_data + j]) bits |= 1u << u;
    const long long c = valid ? w : 0, jj = valid ? j : 0;
    const BandSum ns{carry_in + c, ld_in, bits, off_s, n_bands};
    float dmax = 0.f, amax = 0.f;
    gs_pass_panel(carry_in + c, ld_in, carry_out + c, ld_out, xty_t + jj,
                  inv_den_t + jj, ld_data, xtx, K, lam, rho, ns, valid, smem,
                  dmax, amax);
    store_block_partials(dmax, amax, partials);
}

// CUDA blocks of one launch over n_cols window columns at K: each writes
// one partial of each statistic.
extern "C" long long fdt_fused_banded_sweep_blocks(long long n_cols, int K)
{
    if (K > FDT_REGISTER_MAX_K)
        return (n_cols + FDT_TILE_SPOTS - 1) / FDT_TILE_SPOTS;
    return fdt_blocks(n_cols);
}

#define FDT_SWEEP_ARGS                                                      \
    carry_in, ld_in, carry_out, ld_out, xty_t, masks, inv_den_t, ld_data,   \
        xtx, offs, n_bands, K, pad, n_sub, w0, n_cols, lam, rho, partials

template <int KMAX>
static void launch(const float* carry_in, long long ld_in, float* carry_out,
                   long long ld_out, const float* xty_t, const uint8_t* masks,
                   const float* inv_den_t, long long ld_data,
                   const float* xtx, const BandOffsets& offs, int n_bands,
                   int K, long long pad, long long n_sub, long long w0,
                   long long n_cols, float lam, float rho, float* partials,
                   size_t smem, cudaStream_t stream)
{
    const unsigned blocks = (unsigned)fdt_blocks(n_cols);
    fused_banded_sweep_kernel<KMAX><<<blocks, FDT_THREADS, smem, stream>>>(
        FDT_SWEEP_ARGS);
}

// Launches one sweep of the data columns [data0, data0 + n_sub) on
// `stream`: the window starts at column in_col0 of carry_in (row length
// ld_in) and its column w goes to column out_col0 + w of carry_out (row
// length ld_out); xty_t, masks and inv_den_t have rows of ld_data. With
// write_pads the window's 2*pad pad columns are written as zeros, without
// it they are neither launched nor written. `partials` holds
// 2 * fdt_fused_banded_sweep_blocks(n_cols, K) floats, n_cols = n_sub +
// 2*pad with write_pads and n_sub without. Refuses (cudaErrorInvalidValue)
// a window, a data range or a write that leaves its array. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fdt_fused_banded_sweep(
    const float* carry_in, long long ld_in, long long in_col0,
    float* carry_out, long long ld_out, long long out_col0,
    const float* xty_t, const uint8_t* masks, const float* inv_den_t,
    long long ld_data, long long data0, const float* xtx, const int* offsets,
    int n_bands, int K, long long pad, long long n_sub, int write_pads,
    float lam, float rho, float* partials, void* stream)
{
    const long long w0 = write_pads ? 0 : pad;
    const long long n_cols = write_pads ? n_sub + 2 * pad : n_sub;
    if (n_bands < 1 || n_bands > FDT_MAX_BANDS || K < 1 ||
        K > FDT_PANEL_MAX_K || n_sub < 1 || pad < 0 || in_col0 < 0 ||
        in_col0 + n_sub + 2 * pad > ld_in || data0 < 0 ||
        data0 + n_sub > ld_data || out_col0 < 0 ||
        out_col0 + w0 + n_cols > ld_out)
        return (int)cudaErrorInvalidValue;
    BandOffsets offs;
    for (int u = 0; u < FDT_MAX_BANDS; ++u)
        offs.v[u] = u < n_bands ? offsets[u] : 0;
    carry_in += in_col0;
    carry_out += out_col0;
    xty_t += data0;
    masks += data0;
    inv_den_t += data0;
    cudaStream_t s = (cudaStream_t)stream;
    if (K > FDT_REGISTER_MAX_K) {
        const size_t smem = fdt_panel_smem_floats(K) * sizeof(float)
                            + FDT_MAX_BANDS * sizeof(int);
        const cudaError_t err = cudaFuncSetAttribute(
            fused_banded_sweep_panel_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        const unsigned blocks =
            (unsigned)fdt_fused_banded_sweep_blocks(n_cols, K);
        fused_banded_sweep_panel_kernel<<<blocks, FDT_THREADS, smem, s>>>(
            FDT_SWEEP_ARGS);
        return (int)cudaGetLastError();
    }
    // XtX is 16 KB at K = 64, under the 48 KB a block gets without
    // cudaFuncSetAttribute.
    const size_t smem = (size_t)K * K * sizeof(float)
                        + FDT_MAX_BANDS * sizeof(int);
    if (K <= 8)
        launch<8>(FDT_SWEEP_ARGS, smem, s);
    else if (K <= 16)
        launch<16>(FDT_SWEEP_ARGS, smem, s);
    else if (K <= 32)
        launch<32>(FDT_SWEEP_ARGS, smem, s);
    else
        launch<64>(FDT_SWEEP_ARGS, smem, s);
    return (int)cudaGetLastError();
}
