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
//   ns_k = ns_k + ns_rest[k, j]            (only when ns_rest is given)
// then the Gauss-Seidel pass of gs_pass.cuh on those sums. ns_rest (K,
// n_solve), the rest stream, holds each spot's sum over the graph's edges
// off the bands (refreshed by the caller before each sweep, zero where a
// spot has none); it replaces the ns_rest_t input of the Pallas kernel
// (flashdeconv_tpu/ops/bcd.py:724-729). It is added once, after the band
// loop, with one __fadd_rn: the association of the unfused banded tier
// (bands, then the rest table's total), so the two stay bitwise equal.
// Both kernels are compiled with and without the rest input (template
// REST), chosen by whether ns_rest is null: a wholly banded grid runs the
// code it ran before the rest stream and moves no extra bytes. Pad
// columns are written as zeros. Each CUDA block also writes its max
// |beta_new - beta_old| and max |beta_old| to partials[0, b] and
// partials[1, b]; the wrapper reduces those.
//
// What bounds it at K <= 32: bytes. At 1M spots, K = 20 and 16 bands one
// sweep reads the carry (80 MB), Xty (80 MB), inv_den (80 MB) and the
// uint8 masks (16 MB) and writes the new carry (80 MB): about 340 MB, or
// about 0.1 ms at 3.35 TB/s (a derived count, not a measurement). The
// arithmetic, about K*(K + U) multiply-adds per spot, is far below the
// card's rate; the loads must be kept in flight. What the design does
// about it, with the register pass of gs_pass.cuh (fused_banded_sweep_kernel,
// templated on KMAX = K rounded up to 8, 8..32, and on REST):
//   - one thread per carry column, so a warp's loads of one row k touch 32
//     neighbouring floats; every stream is read once and the new carry is
//     written once, with no intermediate in device memory;
//   - the neighbour reads beta_old[k, j + off] come straight from the input
//     carry: the near bands (+-1, +-2) hit lines the warp is loading anyway,
//     and the far bands (+-side, +-2*side) lie a few hundred KB away per
//     row and are served from the 50 MB L2 rather than device memory. A
//     band's loads of all K rows are issued together (BandSum::rows), so
//     a thread waits once a band;
//   - the band masks are read once per spot, all bands' loads in flight
//     together, and kept as one 32-bit word, and a band whose bit is clear
//     costs no load (so a non-finite value behind a clear bit does not
//     reach ns, where the plain version's 0 * inf would; a solve's carry is
//     finite while its operands are). Set bands add in band order from 0,
//     so the sum equals the plain version's sum of 1*x and 0*x terms bit
//     for bit;
//   - the spot's Xty and inv_den columns are staged into shared memory at
//     kernel start (stage_column), in flight during the band sums;
//   - XtX (with its transpose) and the band offsets live in shared memory;
//     the offsets are read from the kernel parameter at fixed indices, so
//     it stays out of local memory;
//   - the sweep is Jacobi across spots, so it reads one carry and writes
//     another: the caller ping-pongs two carries and nothing is in place.
// Shared memory passes 48 KB from K = 22, so every launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize first and returns that
// call's error if it fails.
//
// At 64 < K <= 384 a second kernel, fused_banded_sweep_panel_kernel, runs
// the same band sums into the panel pass of gs_pass_panel.cuh (the
// counterpart of _make_fused_banded_kernel with _gs_pass_kb_panel in
// flashdeconv_tpu/ops/bcd.py). It is bound by operations at K = 128 and
// 256 (about 3K^2 f32 operations per spot against about 16K bytes: 0.75 ms
// and 3.0 ms at 1M spots, derived, not measured) and by bytes below
// K = 96. A block owns 64 spots; the pass runs its XtX products as
// register-tiled tile products of TM rows x 8 spots a thread
// (gs_pass_panel.cuh says why), so the kernel is templated on TM =
// ceil(K/32), 3..12 (one block an SM above TM = 8, K > 256), and on REST;
// every instance keeps the name fused_banded_sweep_panel_kernel, which
// the benchmark's trace reads. Its register tiles keep the registers a
// thread needs flat in K, where the register pass's arrays grow with it;
// on the card it ran K = 48 and 64 faster than the old register pass of
// KMAX = 64 (PERF.md). Its shared memory passes 48 KB above K = 80, so
// every launch sets the attribute first, as the register kernel's.
// At 32 < K <= 64 (the tile pass's TM = 2 range, which this kernel does
// not build), where a sweep is bound by bytes, the sweep is
// fused_banded_sweep_panel_kernel_spot<REST>, the spot-panel pass of
// gs_pass_panel.cuh (one thread a spot, panels of 16 rows in registers):
// bitwise the tile pass that kernel #2 keeps there, 2.4 times as fast at
// K = 34 on the card (PERF.md); the choice is by K alone.
// Launch: on the caller's stream, no allocation, no synchronisation.
//
// A third kernel, fused_banded_objective_kernel<KMAX, REST> (K <= 56),
// forms the sums of the solve's objective from the same carry in one pass,
// one thread per data column j:
//   cross_j = sum_k beta[k, j] * Xty[k, j]
//   deg_j   = nnb[j] * sum_k beta[k, j]^2
//   adj_j   = sum_k beta[k, j] * ns_k       (ns_k: the band sums above)
//   l1_j    = sum_k |beta[k, j]|
//   quad_j  = beta_j^T XtX beta_j
// and each block writes its five sums, tree-reduced in a fixed order, to
// partials[q, b]; the wrapper (ops/bcd.py: fused_banded_objective) adds
// them up and forms the objective. What bounds it: bytes. At 1M spots and
// K = 20 it reads the carry (80 MB), Xty (80 MB), the uint8 masks (16-24
// MB) and the degrees (4 MB): about 190 MB, about 0.057 ms at 3.35 TB/s
// (a derived count); quad_j's K^2 multiply-adds a spot are far below the
// card's rate. Its neighbour sums are BandSum's, the band loader of the
// sweep kernels (band_bits, load_offsets, rows in band order with the
// clear-bit skip, ns_rest added once after the bands), so there is one
// band-sum code path and the objective's ns are the sweep's bit for bit;
// Xty is staged into shared memory while they run, and XtX sits there as
// load_xtx lays it out for the register pass. It runs most of the panel
// pass's TM = 2 range too (32 < K <= 56, KMAX = 40, 48, 56; the sweep
// there is the panel kernel's): those instances form the band sums 8 rows
// at a time (objective_spot_wide), since the K-row arrays of both the band
// sums and beta would not fit the registers of two blocks an SM, and set
// the shared-memory attribute before each launch (past 48 KB from K = 36).
// KMAX = 64 is not built: at the 128 registers of two blocks an SM ptxas
// (CUDA 12.8, sm_90a) spilled 4 bytes of it (20 with REST), where KMAX =
// 40, 48 and 56 take 112, 124-128 and 126-128 registers and spill nothing;
// 56 < K <= 64 keeps the plain path.

#include "gs_pass_panel.cuh"

#define FDT_MAX_BANDS 32

struct BandOffsets {
    int v[FDT_MAX_BANDS];
};

// The band offsets into shared memory, offset u by thread u: each read of
// the kernel parameter at an index fixed at compile time, which keeps the
// parameter out of local memory (the register kernel's; the panel kernel
// keeps the plain loop, which measured faster there).
__device__ __forceinline__ void load_offsets(const BandOffsets& offs,
                                             const int n_bands,
                                             int* __restrict__ off_s)
{
#pragma unroll
    for (int u = 0; u < FDT_MAX_BANDS; ++u)
        if (threadIdx.x == u && u < n_bands) off_s[u] = offs.v[u];
}

// The neighbour sums of one spot: for row k, the set bands' carry values of
// row k added in band order, then, with REST, the spot's rest-stream sum.
template <bool REST>
struct BandSum {
    const float* col;   // the spot's column of the input carry
    long long ld;       // the carry's row length n_ext
    uint32_t bits;      // bit u set iff band u has an edge at this spot
    const int* off_s;   // band offsets, in shared memory
    int n_bands;
    const float* rest;  // the spot's column of ns_rest (read with REST)
    long long ld_rest;  // ns_rest's row length (that of xty)

    // s[j] = the sum of row k0 + j * step for the rows below lim (0 for the
    // others); the N rows' loads of one band are issued together. Batches
    // of 8 rows or more walk each band's column (fdt_next); for the panel
    // pass's batches of 4 the walk's asm statements kept nvcc from
    // overlapping consecutive bands' loads (3-5 % slower at K = 96-256,
    // measured), and 4 row offsets are cheap to keep.
    template <int N>
    __device__ __forceinline__ void rows(int k0, int step, int lim,
                                         float (&s)[N]) const
    {
#pragma unroll
        for (int j = 0; j < N; ++j) s[j] = 0.f;
        for (int u = 0; u < n_bands; ++u)
            if ((bits >> u) & 1u) {
                if constexpr (N >= 8) {  // the register pass: K rows
                    const float* c = col + off_s[u] + k0 * ld;
#pragma unroll
                    for (int j = 0; j < N; ++j, c = fdt_next(c, step * ld))
                        if (k0 + j * step < lim) s[j] = __fadd_rn(s[j], *c);
                } else {  // the panel pass: a few rows, offsets kept
                    const float* c = col + off_s[u];
#pragma unroll
                    for (int j = 0; j < N; ++j)
                        if (k0 + j * step < lim)
                            s[j] = __fadd_rn(s[j], c[(k0 + j * step) * ld]);
                }
            }
        if (REST) {
            const float* c = rest + k0 * ld_rest;
#pragma unroll
            for (int j = 0; j < N; ++j, c = fdt_next(c, step * ld_rest))
                if (k0 + j * step < lim) s[j] = __fadd_rn(s[j], *c);
        }
    }
};

// Sub-range form (the counterpart of fused_banded_sweep(sub=...) in
// flashdeconv_tpu/ops/bcd.py, which the spot-sharded banded mesh runs):
// both kernels sweep a window of n_sub + 2*pad columns that starts at
// column in_col0 of the input carry, its n_sub data columns being the data
// columns [data0, data0 + n_sub) of xty, masks, inv_den and ns_rest (row
// length ld_data). Window column w (0 <= w < n_sub + 2*pad) is written to
// column out_col0 + w of the output carry. The whole sweep is in_col0 =
// data0 = out_col0 = 0 and n_sub = n_solve. With write_pads the pad columns of the
// window are written as zeros (a whole sweep, or a sub-carry of its own);
// without it only the data columns are launched and written, so a split
// sweep fills one full carry without touching its pads. Every data column
// sees the same window values and runs the same per-column arithmetic
// whatever the range, so a split sweep recomposes the whole one bit for bit.
// In both kernels thread t of the launch takes window column w0 + t, w0 = 0
// with write_pads and pad without.

// The band bits of data column j: bit u set iff masks[u, j] is nonzero;
// the n_bands loads are in flight together (the register kernel's; the
// panel kernel keeps the plain loop, which measured faster there).
__device__ __forceinline__ uint32_t band_bits(const uint8_t* __restrict__ masks,
                                              const long long ld,
                                              const long long j,
                                              const int n_bands)
{
    uint32_t bits = 0u;
#pragma unroll
    for (int u = 0; u < FDT_MAX_BANDS; ++u)
        if (u < n_bands && masks[u * ld + j]) bits |= 1u << u;
    return bits;
}

// K <= FDT_REGISTER_MAX_K, KMAX = K rounded up to 8: one thread per window
// column. A spot's Xty and inv_den columns are staged into shared memory
// by asynchronous copies first, so their loads are in flight while the
// band sums run.
template <int KMAX, bool REST>
__global__ void
__launch_bounds__(FDT_THREADS, FDT_REGISTER_MIN_BLOCKS(KMAX, REST))
fused_banded_sweep_kernel(const float* __restrict__ carry_in,
                          const long long ld_in,
                          float* __restrict__ carry_out,
                          const long long ld_out,
                          const float* __restrict__ xty_t,
                          const uint8_t* __restrict__ masks,
                          const float* __restrict__ inv_den_t,
                          const float* __restrict__ ns_rest,
                          const long long ld_data,
                          const float* __restrict__ xtx,
                          const BandOffsets offs, const int n_bands,
                          const int K, const long long pad,
                          const long long n_sub, const long long w0,
                          const long long n_cols, const float lam,
                          const float rho, float* __restrict__ partials)
{
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);         // 2 KMAX^2
    float* xty_s = xs + 2 * KMAX * KMAX;                 // (K, FDT_THREADS)
    float* inv_s = xty_s + K * FDT_THREADS;              // (K, FDT_THREADS)
    int* off_s = reinterpret_cast<int*>(inv_s + K * FDT_THREADS);

    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long w = w0 + t;                 // window column
    const long long j = w - pad;                // data column of the range
    const bool spot = t < n_cols && j >= 0 && j < n_sub;
    uint32_t bits = 0u;
    if (spot) {
        stage_column<KMAX>(xty_s + threadIdx.x, xty_t + j, ld_data, K);
        stage_column<KMAX>(inv_s + threadIdx.x, inv_den_t + j, ld_data, K);
        bits = band_bits(masks, ld_data, j, n_bands);
    }
    load_xtx<KMAX>(xtx, xs, K);
    load_offsets(offs, n_bands, off_s);
    __syncthreads();

    float dmax = 0.f, amax = 0.f;
    if (t < n_cols && !spot) {
        for (int k = 0; k < K; ++k) carry_out[k * ld_out + w] = 0.f;
    } else if (spot) {
        const BandSum<REST> ns{carry_in + w, ld_in, bits, off_s, n_bands,
                               ns_rest + j, ld_data};
        gs_pass_spot<KMAX>(carry_in + w, ld_in, carry_out + w, ld_out,
                           xty_s + threadIdx.x, inv_s + threadIdx.x,
                           FDT_THREADS, xs, K, lam, rho, ns, dmax, amax);
    }
    store_block_partials(dmax, amax, partials);
}

// FDT_SPOT_PANEL_MAX_K < K <= FDT_PANEL_MAX_K, TM = fdt_panel_tm(K) >=
// FUSED_MIN_TM: a block of 256 threads sweeps FDT_TILE_SPOTS window
// columns, thread t column w0 + blockIdx.x * FDT_TILE_SPOTS +
// fdt_panel_spot() (the spot layout of gs_pass_panel.cuh).
constexpr int FUSED_MIN_TM = FDT_SPOT_PANEL_MAX_K / 32 + 1;
static_assert(FDT_SPOT_PANEL_MAX_K % 32 == 0,
              "the tile pass starts at a whole register tile");
template <int TM, bool REST>
__global__ void
__launch_bounds__(FDT_THREADS, FDT_PANEL_MIN_BLOCKS(TM))
fused_banded_sweep_panel_kernel(const float* __restrict__ carry_in,
                                const long long ld_in,
                                float* __restrict__ carry_out,
                                const long long ld_out,
                                const float* __restrict__ xty_t,
                                const uint8_t* __restrict__ masks,
                                const float* __restrict__ inv_den_t,
                                const float* __restrict__ ns_rest,
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
        (long long)blockIdx.x * FDT_TILE_SPOTS + fdt_panel_spot();
    const long long w = w0 + t;  // window column
    const long long j = w - pad;  // data column of the range
    const bool valid = t < n_cols && j >= 0 && j < n_sub;
    if (t < n_cols && !valid)
        for (int k = fdt_panel_spot_row(); k < K; k += FDT_SPOT_ROWS)
            carry_out[k * ld_out + w] = 0.f;
    uint32_t bits = 0u;
    if (valid)
        for (int u = 0; u < n_bands; ++u)
            if (masks[u * ld_data + j]) bits |= 1u << u;
    const long long c = valid ? w : 0, jj = valid ? j : 0;
    const BandSum<REST> ns{carry_in + c, ld_in, bits, off_s, n_bands,
                           ns_rest + jj, ld_data};
    float dmax = 0.f, amax = 0.f;
    gs_pass_panel<TM>(carry_in + c, ld_in, carry_out + c, ld_out,
                      xty_t + jj, inv_den_t + jj, ld_data, xtx, K, lam, rho,
                      ns, valid, smem, dmax, amax);
    store_block_partials(dmax, amax, partials);
}

// FDT_REGISTER_MAX_K < K <= FDT_SPOT_PANEL_MAX_K: the spot-panel pass of
// gs_pass_panel.cuh, one thread per window column as in the register
// kernel. The spot's beta_old column is staged into shared memory by
// asynchronous copies first, so its loads are in flight while the first
// band sums run. (Its name holds the panel kernel's: both are kernel #1b.)
template <bool REST>
__global__ void
__launch_bounds__(FDT_THREADS, FDT_SPOT_PANEL_MIN_BLOCKS)
fused_banded_sweep_panel_kernel_spot(const float* __restrict__ carry_in,
                                     const long long ld_in,
                                     float* __restrict__ carry_out,
                                     const long long ld_out,
                                     const float* __restrict__ xty_t,
                                     const uint8_t* __restrict__ masks,
                                     const float* __restrict__ inv_den_t,
                                     const float* __restrict__ ns_rest,
                                     const long long ld_data,
                                     const float* __restrict__ xtx,
                                     const BandOffsets offs,
                                     const int n_bands, const int K,
                                     const long long pad,
                                     const long long n_sub,
                                     const long long w0,
                                     const long long n_cols, const float lam,
                                     const float rho,
                                     float* __restrict__ partials)
{
    extern __shared__ float4 smem4[];
    const int ldx = fdt_spot_panel_ldx(K);
    float* xs = reinterpret_cast<float*>(smem4);      // K x ldx
    float* bs = xs + K * ldx;                         // (K, FDT_THREADS)
    float* ds = bs + K * FDT_THREADS;                 // (n_delta, FDT_THREADS)
    int* off_s = reinterpret_cast<int*>(
        ds + fdt_spot_panel_delta_rows(K) * FDT_THREADS);

    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long w = w0 + t;                 // window column
    const long long j = w - pad;                // data column of the range
    const bool spot = t < n_cols && j >= 0 && j < n_sub;
    uint32_t bits = 0u;
    if (spot) {
        stage_column<FDT_SPOT_PANEL_MAX_K>(bs + threadIdx.x, carry_in + w,
                                           ld_in, K);
        bits = band_bits(masks, ld_data, j, n_bands);
    }
    load_xtx_t(xtx, xs, K, ldx);
    load_offsets(offs, n_bands, off_s);
    __syncthreads();

    float dmax = 0.f, amax = 0.f;
    if (t < n_cols && !spot) {
        for (int k = 0; k < K; ++k) carry_out[k * ld_out + w] = 0.f;
    } else if (spot) {
        const BandSum<REST> ns{carry_in + w, ld_in, bits, off_s, n_bands,
                               ns_rest + j, ld_data};
        gs_pass_spot_panel(bs + threadIdx.x, ds + threadIdx.x, xs,
                           carry_out + w, ld_out, xty_t + j, inv_den_t + j,
                           ld_data, K, lam, rho, ns, dmax, amax);
    }
    store_block_partials(dmax, amax, partials);
}

// Whether kernel #1 runs the spot-panel pass at K.
static bool spot_panel_takes(int K)
{
    return K > FDT_REGISTER_MAX_K && K <= FDT_SPOT_PANEL_MAX_K;
}

// CUDA blocks of one launch over n_cols window columns at K: each writes
// one partial of each statistic.
extern "C" long long fdt_fused_banded_sweep_blocks(long long n_cols, int K)
{
    if (K > FDT_REGISTER_MAX_K && !spot_panel_takes(K))
        return (n_cols + FDT_TILE_SPOTS - 1) / FDT_TILE_SPOTS;
    return fdt_blocks(n_cols);
}

#define FDT_SWEEP_ARGS                                                      \
    carry_in, ld_in, carry_out, ld_out, xty_t, masks, inv_den_t, ns_rest,   \
        ld_data, xtx, offs, n_bands, K, pad, n_sub, w0, n_cols, lam, rho,     \
        partials

#define FDT_SWEEP_PARAMS                                                    \
    const float *carry_in, long long ld_in, float *carry_out,               \
        long long ld_out, const float *xty_t, const uint8_t *masks,         \
        const float *inv_den_t, const float *ns_rest, long long ld_data,    \
        const float *xtx, const BandOffsets &offs, int n_bands, int K,      \
        long long pad, long long n_sub, long long w0, long long n_cols,     \
        float lam, float rho, float *partials, size_t smem,                 \
        cudaStream_t stream

// The objective's sums, in the order of the partials' rows: cross, degree,
// adjacency, L1, quad (see the note at the head of this file).
#define FDT_OBJECTIVE_TERMS 5

// The five sums of one spot, j its data column: col points at its column
// of the carry (row length ld), xty at its column of the staged Xty tile
// (row length FDT_THREADS), xs is load_xtx's XtX. beta's K loads are in
// flight together, after the band sums.
template <int KMAX, bool REST>
__device__ __forceinline__ void objective_spot(
    const float* __restrict__ col, const long long ld,
    const float* __restrict__ xty, const float deg,
    const float* __restrict__ xs, const int K, const BandSum<REST>& ns,
    float (&sum)[FDT_OBJECTIVE_TERMS])
{
    static_assert(KMAX % 4 == 0, "XtX rows are read as float4");
    constexpr int Q = KMAX / 4;
    const float4* xr = reinterpret_cast<const float4*>(xs);
    float s[KMAX];
    ns.template rows<KMAX>(0, 1, K, s);
    copy_async_wait();
    float b[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k, col = fdt_next(col, ld))
        b[k] = k < K ? *col : 0.f;
    float cross = 0.f, sq = 0.f, adj = 0.f, l1 = 0.f, quad = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        cross = __fmaf_rn(b[k], xty[k * FDT_THREADS], cross);
        sq = __fmaf_rn(b[k], b[k], sq);
        adj = __fmaf_rn(b[k], s[k], adj);
        l1 = __fadd_rn(l1, fabsf(b[k]));
        float r = 0.f;  // (XtX beta)_k; the zero padding adds exact zeros
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const float4 v = xr[k * Q + q];
            r = __fmaf_rn(v.x, b[4 * q], r);
            r = __fmaf_rn(v.y, b[4 * q + 1], r);
            r = __fmaf_rn(v.z, b[4 * q + 2], r);
            r = __fmaf_rn(v.w, b[4 * q + 3], r);
        }
        quad = __fmaf_rn(b[k], r, quad);
    }
    sum[0] = cross;
    sum[1] = __fmul_rn(deg, sq);
    sum[2] = adj;
    sum[3] = l1;
    sum[4] = quad;
}

// The same five sums at FDT_REGISTER_MAX_K < K <= FDT_OBJECTIVE_MAX_K
// (KMAX = 40, 48, 56). beta's K loads are issued first and stay in registers
// (quad needs all of them); the band sums then come 8 rows at a time
// (BandSum::rows<8> from row k0), each batch folded into the sums at once,
// so no K-row array of band sums is live. Every sum still adds over k = 0,
// 1, ..., K-1 in order, as objective_spot's do.
template <int KMAX, bool REST>
__device__ __forceinline__ void objective_spot_wide(
    const float* __restrict__ col, const long long ld,
    const float* __restrict__ xty, const float deg,
    const float* __restrict__ xs, const int K, const BandSum<REST>& ns,
    float (&sum)[FDT_OBJECTIVE_TERMS])
{
    static_assert(KMAX % 8 == 0, "band sums come 8 rows at a time");
    constexpr int Q = KMAX / 4, NB = 8;
    const float4* xr = reinterpret_cast<const float4*>(xs);
    float b[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k, col = fdt_next(col, ld))
        b[k] = k < K ? *col : 0.f;
    float cross = 0.f, sq = 0.f, adj = 0.f, l1 = 0.f, quad = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KMAX; k0 += NB) {
        if (k0 >= K) break;
        float s[NB];
        ns.template rows<NB>(k0, 1, K, s);
        if (k0 == 0) copy_async_wait();
#pragma unroll
        for (int i = 0; i < NB; ++i) {
            const int k = k0 + i;
            if (k >= K) break;
            cross = __fmaf_rn(b[k], xty[k * FDT_THREADS], cross);
            sq = __fmaf_rn(b[k], b[k], sq);
            adj = __fmaf_rn(b[k], s[i], adj);
            l1 = __fadd_rn(l1, fabsf(b[k]));
            float r = 0.f;  // (XtX beta)_k, as in objective_spot
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const float4 v = xr[k * Q + q];
                r = __fmaf_rn(v.x, b[4 * q], r);
                r = __fmaf_rn(v.y, b[4 * q + 1], r);
                r = __fmaf_rn(v.z, b[4 * q + 2], r);
                r = __fmaf_rn(v.w, b[4 * q + 3], r);
            }
            quad = __fmaf_rn(b[k], r, quad);
        }
    }
    sum[0] = cross;
    sum[1] = __fmul_rn(deg, sq);
    sum[2] = adj;
    sum[3] = l1;
    sum[4] = quad;
}

// Block reduction of the five sums in a fixed order, warp shuffles first,
// then the warps' sums in warp order: partials[q * gridDim.x + b]. Every
// thread calls it.
__device__ __forceinline__ void store_objective_partials(
    float (&sum)[FDT_OBJECTIVE_TERMS], float* __restrict__ partials)
{
    __shared__ float red[FDT_OBJECTIVE_TERMS][FDT_THREADS / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < FDT_OBJECTIVE_TERMS; ++q)
            sum[q] = __fadd_rn(sum[q],
                               __shfl_xor_sync(0xffffffffu, sum[q], o));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0)
#pragma unroll
        for (int q = 0; q < FDT_OBJECTIVE_TERMS; ++q) red[q][warp] = sum[q];
    __syncthreads();
    if (threadIdx.x < FDT_OBJECTIVE_TERMS) {
        float t = 0.f;
        for (int w = 0; w < FDT_THREADS / 32; ++w)
            t = __fadd_rn(t, red[threadIdx.x][w]);
        partials[threadIdx.x * gridDim.x + blockIdx.x] = t;
    }
}

// K <= FDT_OBJECTIVE_MAX_K, KMAX = K rounded up to 8: thread t of the
// launch takes data column j = t, carry column j + pad. A spot's Xty column
// is staged into shared memory by asynchronous copies first, in flight while
// the band sums run.
template <int KMAX, bool REST>
__global__ void
__launch_bounds__(FDT_THREADS, FDT_REGISTER_MIN_BLOCKS(KMAX, REST))
fused_banded_objective_kernel(const float* __restrict__ carry,
                              const long long ld,
                              const float* __restrict__ xty_t,
                              const uint8_t* __restrict__ masks,
                              const float* __restrict__ nnb,
                              const float* __restrict__ ns_rest,
                              const long long n_solve,
                              const float* __restrict__ xtx,
                              const BandOffsets offs, const int n_bands,
                              const int K, const long long pad,
                              float* __restrict__ partials)
{
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);         // 2 KMAX^2
    float* xty_s = xs + 2 * KMAX * KMAX;                 // (K, FDT_THREADS)
    int* off_s = reinterpret_cast<int*>(xty_s + K * FDT_THREADS);

    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool spot = j < n_solve;
    uint32_t bits = 0u;
    float deg = 0.f;
    if (spot) {
        stage_column<KMAX>(xty_s + threadIdx.x, xty_t + j, n_solve, K);
        bits = band_bits(masks, n_solve, j, n_bands);
        deg = nnb[j];
    }
    load_xtx<KMAX>(xtx, xs, K);
    load_offsets(offs, n_bands, off_s);
    __syncthreads();

    float sum[FDT_OBJECTIVE_TERMS] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (spot) {
        const BandSum<REST> ns{carry + pad + j, ld, bits, off_s, n_bands,
                               ns_rest + j, n_solve};
        if constexpr (KMAX > FDT_REGISTER_MAX_K)
            objective_spot_wide<KMAX>(carry + pad + j, ld, xty_s + threadIdx.x,
                                      deg, xs, K, ns, sum);
        else
            objective_spot<KMAX>(carry + pad + j, ld, xty_s + threadIdx.x,
                                 deg, xs, K, ns, sum);
    }
    store_objective_partials(sum, partials);
}

// Dynamic shared memory of the register kernel of KMAX at K, in bytes.
static size_t register_smem(int KMAX, int K)
{
    return fdt_register_smem_floats(KMAX, K) * sizeof(float)
           + FDT_MAX_BANDS * sizeof(int);
}

// The KMAX of the register kernel that runs K's KMAX, with the rest input
// iff REST. With it the smallest instance is KMAX = 16: at KMAX = 8 ptxas
// (CUDA 12.8, sm_90a) held the first form of this kernel to 40 registers
// and spilled 20 bytes. A larger KMAX runs the same operations for every
// k < K, so the bits are the same.
template <int KMAX, bool REST>
constexpr int register_kmax()
{
    return REST && KMAX < 16 ? 16 : KMAX;
}
template <int KMAX, bool REST>
static auto register_kernel()
{
    return fused_banded_sweep_kernel<register_kmax<KMAX, REST>(), REST>;
}

// K <= FDT_REGISTER_MAX_K: the register kernel of KMAX; its shared memory
// passes 48 KB from K = 22, so the attribute is set before every launch.
template <int KMAX, bool REST>
static int launch(FDT_SWEEP_PARAMS)
{
    const auto kernel = register_kernel<KMAX, REST>();
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)fdt_blocks(n_cols);
    kernel<<<blocks, FDT_THREADS, smem, stream>>>(FDT_SWEEP_ARGS);
    return (int)cudaGetLastError();
}

// FDT_SPOT_PANEL_MAX_K < K <= FDT_PANEL_MAX_K: the panel kernel of TM;
// its shared memory may pass 48 KB, so the attribute is set before every
// launch.
template <int TM, bool REST>
static int launch_panel(FDT_SWEEP_PARAMS)
{
    const cudaError_t err = cudaFuncSetAttribute(
        fused_banded_sweep_panel_kernel<TM, REST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks =
        (unsigned)fdt_fused_banded_sweep_blocks(n_cols, K);
    fused_banded_sweep_panel_kernel<TM, REST>
        <<<blocks, FDT_THREADS, smem, stream>>>(FDT_SWEEP_ARGS);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of the panel kernel at K, in bytes.
static size_t panel_smem(int K)
{
    return fdt_panel_smem_floats(K) * sizeof(float)
           + FDT_MAX_BANDS * sizeof(int);
}

// FDT_REGISTER_MAX_K < K <= FDT_SPOT_PANEL_MAX_K: the spot-panel kernel;
// its shared memory passes 48 KB, so the attribute is set before every
// launch.
template <bool REST>
static int launch_spot_panel(FDT_SWEEP_PARAMS)
{
    const cudaError_t err = cudaFuncSetAttribute(
        fused_banded_sweep_panel_kernel_spot<REST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)fdt_blocks(n_cols);
    fused_banded_sweep_panel_kernel_spot<REST>
        <<<blocks, FDT_THREADS, smem, stream>>>(FDT_SWEEP_ARGS);
    return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory the spot-panel kernel takes at K (its
// band offsets included).
extern "C" long long fdt_spot_panel_pass_smem_bytes(int K)
{
    return (long long)fdt_spot_panel_smem_floats(K) * sizeof(float)
           + FDT_MAX_BANDS * sizeof(int);
}

// Blocks of kernel #1's form at FDT_REGISTER_MAX_K < K <= FDT_PANEL_MAX_K
// (with the rest input iff rest), the spot-panel kernel up to
// FDT_SPOT_PANEL_MAX_K and the panel kernel above, that one SM holds at
// once, by registers and shared memory; a negative cudaError_t if the
// query fails.
extern "C" int fdt_fused_banded_sweep_panel_occupancy(int K, int rest)
{
    if (K <= FDT_REGISTER_MAX_K || K > FDT_PANEL_MAX_K)
        return -(int)cudaErrorInvalidValue;
    if (spot_panel_takes(K)) {
        const size_t smem = fdt_spot_panel_pass_smem_bytes(K);
        return rest ? fdt_occupancy(fused_banded_sweep_panel_kernel_spot<true>,
                                    smem)
                    : fdt_occupancy(
                          fused_banded_sweep_panel_kernel_spot<false>, smem);
    }
    return fdt_panel_dispatch<FUSED_MIN_TM>(K, [&](auto tm) {
        constexpr int TM = decltype(tm)::value;
        return rest ? fdt_occupancy(
                          fused_banded_sweep_panel_kernel<TM, true>,
                          panel_smem(K))
                    : fdt_occupancy(
                          fused_banded_sweep_panel_kernel<TM, false>,
                          panel_smem(K));
    });
}

// The same for the register kernel at 1 <= K <= FDT_REGISTER_MAX_K.
extern "C" int fdt_fused_banded_sweep_register_occupancy(int K, int rest)
{
    if (K < 1 || K > FDT_REGISTER_MAX_K) return -(int)cudaErrorInvalidValue;
    return fdt_register_dispatch(K, [&](auto kmax) {
        constexpr int KMAX = decltype(kmax)::value;
        return rest ? fdt_occupancy(
                          register_kernel<KMAX, true>(),
                          register_smem(register_kmax<KMAX, true>(), K))
                    : fdt_occupancy(register_kernel<KMAX, false>(),
                                    register_smem(KMAX, K));
    });
}

// Launches one sweep of the data columns [data0, data0 + n_sub) on
// `stream`: the window starts at column in_col0 of carry_in (row length
// ld_in) and its column w goes to column out_col0 + w of carry_out (row
// length ld_out); xty_t, masks, inv_den_t and ns_rest (null: no rest
// stream) have rows of ld_data. With
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
    const float* ns_rest, long long ld_data, long long data0,
    const float* xtx, const int* offsets, int n_bands, int K, long long pad,
    long long n_sub, int write_pads, float lam, float rho, float* partials,
    void* stream)
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
    if (ns_rest) ns_rest += data0;
    cudaStream_t s = (cudaStream_t)stream;
    if (spot_panel_takes(K)) {
        const size_t smem = fdt_spot_panel_pass_smem_bytes(K);
        return ns_rest ? launch_spot_panel<true>(FDT_SWEEP_ARGS, smem, s)
                       : launch_spot_panel<false>(FDT_SWEEP_ARGS, smem, s);
    }
    if (K > FDT_REGISTER_MAX_K) {
        const size_t smem = panel_smem(K);
        return fdt_panel_dispatch<FUSED_MIN_TM>(K, [&](auto tm) {
            constexpr int TM = decltype(tm)::value;
            return ns_rest ? launch_panel<TM, true>(FDT_SWEEP_ARGS, smem, s)
                           : launch_panel<TM, false>(FDT_SWEEP_ARGS, smem, s);
        });
    }
    return fdt_register_dispatch(K, [&](auto kmax) {
        constexpr int KMAX = decltype(kmax)::value;
        return ns_rest
                   ? launch<KMAX, true>(
                         FDT_SWEEP_ARGS,
                         register_smem(register_kmax<KMAX, true>(), K), s)
                   : launch<KMAX, false>(FDT_SWEEP_ARGS,
                                         register_smem(KMAX, K), s);
    });
}

// CUDA blocks of one objective launch over n_solve data columns: each
// writes one partial of each sum.
extern "C" long long fdt_fused_banded_objective_blocks(long long n_solve)
{
    return fdt_blocks(n_solve);
}

#define FDT_OBJECTIVE_ARGS                                                  \
    carry, ld, xty_t, masks, nnb, ns_rest, n_solve, xtx, offs, n_bands, K,  \
        pad, partials

// Largest K of the objective kernel.
#define FDT_OBJECTIVE_MAX_K 56

// f(std::integral_constant<int, KMAX>{}) with KMAX = K rounded up to a
// multiple of 8, 8..FDT_OBJECTIVE_MAX_K: the objective kernel's instance at
// 1 <= K <= FDT_OBJECTIVE_MAX_K (the register pass's choice at K <= 32).
template <class F>
static int fdt_objective_dispatch(const int K, F f)
{
    switch ((K + 7) / 8) {
    case 5: return f(std::integral_constant<int, 40>{});
    case 6: return f(std::integral_constant<int, 48>{});
    case 7: return f(std::integral_constant<int, 56>{});
    default: return fdt_register_dispatch(K, f);
    }
}

// The objective kernel of KMAX at K, with the rest input iff REST. Its
// shared memory (XtX, its transpose and the Xty tile) stays under 48 KB at
// K <= 32 (40 KB at K = 32), so no attribute is set there; above, it passes
// 48 KB from K = 36 (82,560 bytes at K = 56), so the attribute is set
// before every launch.
template <int KMAX, bool REST>
static int launch_objective(const float* carry, long long ld,
                            const float* xty_t, const uint8_t* masks,
                            const float* nnb, const float* ns_rest,
                            long long n_solve, const float* xtx,
                            const BandOffsets& offs, int n_bands, int K,
                            long long pad, float* partials,
                            cudaStream_t stream)
{
    const size_t smem = (2 * KMAX * KMAX + K * FDT_THREADS) * sizeof(float)
                        + FDT_MAX_BANDS * sizeof(int);
    if constexpr (KMAX > FDT_REGISTER_MAX_K) {
        const cudaError_t err = cudaFuncSetAttribute(
            fused_banded_objective_kernel<KMAX, REST>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned blocks = (unsigned)fdt_blocks(n_solve);
    fused_banded_objective_kernel<KMAX, REST>
        <<<blocks, FDT_THREADS, smem, stream>>>(FDT_OBJECTIVE_ARGS);
    return (int)cudaGetLastError();
}

// Launches the objective's sums over the carry (K, ld) whose data columns
// are [pad, pad + n_solve), on `stream`: xty_t, masks, nnb and ns_rest
// (null: no rest stream) have rows of n_solve, `partials` holds
// FDT_OBJECTIVE_TERMS * fdt_fused_banded_objective_blocks(n_solve) floats,
// row q the blocks' sums of term q. Refuses (cudaErrorInvalidValue) K
// outside 1..FDT_OBJECTIVE_MAX_K, a band count outside 1..FDT_MAX_BANDS, a
// band offset past the pad and a carry too narrow for its data columns.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fdt_fused_banded_objective(
    const float* carry, long long ld, const float* xty_t,
    const uint8_t* masks, const float* nnb, const float* ns_rest,
    long long n_solve, const float* xtx, const int* offsets, int n_bands,
    int K, long long pad, float* partials, void* stream)
{
    if (n_bands < 1 || n_bands > FDT_MAX_BANDS || K < 1 ||
        K > FDT_OBJECTIVE_MAX_K || n_solve < 1 || pad < 0 ||
        n_solve + 2 * pad > ld)
        return (int)cudaErrorInvalidValue;
    BandOffsets offs;
    for (int u = 0; u < FDT_MAX_BANDS; ++u) {
        offs.v[u] = u < n_bands ? offsets[u] : 0;
        if (offs.v[u] > pad || -offs.v[u] > pad)
            return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    return fdt_objective_dispatch(K, [&](auto kmax) {
        constexpr int KMAX = decltype(kmax)::value;
        return ns_rest ? launch_objective<KMAX, true>(FDT_OBJECTIVE_ARGS, s)
                       : launch_objective<KMAX, false>(FDT_OBJECTIVE_ARGS, s);
    });
}
