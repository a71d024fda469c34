// Gauss-Seidel coordinate-descent pass over given neighbour sums, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _cd_block_kernel in
// flashdeconv_tpu/ops/bcd.py (run by coordinate_descent_pallas there),
// which the gather and unfused banded tiers launch once per sweep after
// forming the neighbour sums outside the kernel. Its plain PyTorch version
// is flashdeconv_tpu_torch/ops/bcd.py:coordinate_descent_block_reference.
//
// What it computes, for every spot j of the (K, n) operands: the
// Gauss-Seidel pass of gs_pass.cuh with ns_k = ns[k, j], the same device
// function the fused kernel runs on its band sums, so the two tiers give
// the same beta bit for bit on the same operands. Each CUDA block also
// writes its max |beta_new - beta_old| and max |beta_old| to
// partials[0, b] and partials[1, b]; the wrapper reduces those.
//
// What bounds it at K <= 32: bytes. At 1M spots and K = 20 one launch
// reads beta, Xty, ns and inv_den (4 x 80 MB) and writes the new beta
// (80 MB): 400 MB, about 0.12 ms at 3.35 TB/s (a derived count, not a
// measurement); about K*K multiply-adds per spot are far below the card's
// rate, so the loads must be kept in flight. What the design does about
// it, with the register pass of gs_pass.cuh (cd_block_sweep_kernel,
// templated on KMAX = K rounded up to 8, 8..32): one thread per spot, so a
// warp's loads of one row k touch 32 neighbouring floats and every operand
// is read once and the new beta written once; the spot's Xty and inv_den
// columns are staged into shared memory at kernel start, and its K
// neighbour sums and K values of beta_old are each loaded in one batch, so
// a thread waits on device memory about three times a pass, not about 2K
// times; beta_old and the numerators stay in registers, XtX (and its
// transpose) in shared memory. Shared memory passes 48 KB from K = 22, so
// every launch sets cudaFuncAttributeMaxDynamicSharedMemorySize first and
// returns that call's error if it fails. The pass is Jacobi across spots:
// it reads one beta and writes another, never in place.
//
// At 32 < K <= 384 a second kernel, cd_block_sweep_panel_kernel, runs the
// panel pass of gs_pass_panel.cuh on the same operands (the counterpart of
// _cd_block_kernel with _gs_pass_kb_panel in flashdeconv_tpu/ops/bcd.py;
// the JAX package runs it there to K = 128 and its XLA pass above). It is
// bound by operations at K = 128 and 256 (about 3K^2 f32 operations per
// spot against about 20K bytes: 0.75 ms and 3.0 ms at 1M spots, derived,
// not measured) and by bytes below K = 96. A block owns 64 spots; the pass
// runs its XtX products as register-tiled tile products of TM rows x 8
// spots a thread (gs_pass_panel.cuh says why), so the kernel is templated
// on TM = ceil(K/32), 2..12 (one block an SM above TM = 8, K > 256). Its
// shared memory passes 48 KB above K = 80, so every launch sets the
// attribute first, as the register kernel's.
// Launch: on the caller's stream, no allocation, no synchronisation.

#include "gs_pass_panel.cuh"

// The neighbour sums of one spot: loads from the precomputed ones.
struct LoadSum {
    const float* col;  // the spot's column of ns (K, n)
    long long ld;      // n

    // s[j] = ns[k0 + j * step] for the rows below lim (0 for the others),
    // the N loads issued together.
    template <int N>
    __device__ __forceinline__ void rows(int k0, int step, int lim,
                                         float (&s)[N]) const
    {
        const float* c = col + k0 * ld;
#pragma unroll
        for (int j = 0; j < N; ++j, c = fdt_next(c, step * ld))
            s[j] = k0 + j * step < lim ? *c : 0.f;
    }
};

// K <= FDT_REGISTER_MAX_K, KMAX = K rounded up to 8: one thread per spot.
// A spot's Xty and inv_den columns are staged into shared memory by
// asynchronous copies first, so their loads are in flight while the
// neighbour sums and beta_old are loaded.
template <int KMAX>
__global__ void
__launch_bounds__(FDT_THREADS, FDT_REGISTER_MIN_BLOCKS(KMAX, false))
cd_block_sweep_kernel(const float* __restrict__ beta_in,
                      float* __restrict__ beta_out,
                      const float* __restrict__ xty_t,
                      const float* __restrict__ ns_t,
                      const float* __restrict__ inv_den_t,
                      const float* __restrict__ xtx, const int K,
                      const long long n, const float lam, const float rho,
                      float* __restrict__ partials)
{
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);  // 2 KMAX^2
    float* xty_s = xs + 2 * KMAX * KMAX;          // (K, FDT_THREADS)
    float* inv_s = xty_s + K * FDT_THREADS;       // (K, FDT_THREADS)

    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j < n) {
        stage_column<KMAX>(xty_s + threadIdx.x, xty_t + j, n, K);
        stage_column<KMAX>(inv_s + threadIdx.x, inv_den_t + j, n, K);
    }
    load_xtx<KMAX>(xtx, xs, K);
    __syncthreads();

    float dmax = 0.f, amax = 0.f;
    if (j < n) {
        const LoadSum ns{ns_t + j, n};
        gs_pass_spot<KMAX>(beta_in + j, n, beta_out + j, n,
                           xty_s + threadIdx.x, inv_s + threadIdx.x,
                           FDT_THREADS, xs, K, lam, rho, ns, dmax, amax);
    }
    store_block_partials(dmax, amax, partials);
}

// FDT_REGISTER_MAX_K < K <= FDT_PANEL_MAX_K, TM = fdt_panel_tm(K): a
// block of 256 threads passes over FDT_TILE_SPOTS spots, thread t spot
// blockIdx.x * FDT_TILE_SPOTS + fdt_panel_spot() (the spot layout of
// gs_pass_panel.cuh).
template <int TM>
__global__ void
__launch_bounds__(FDT_THREADS, FDT_PANEL_MIN_BLOCKS(TM))
cd_block_sweep_panel_kernel(const float* __restrict__ beta_in,
                            float* __restrict__ beta_out,
                            const float* __restrict__ xty_t,
                            const float* __restrict__ ns_t,
                            const float* __restrict__ inv_den_t,
                            const float* __restrict__ xtx, const int K,
                            const long long n, const float lam,
                            const float rho, float* __restrict__ partials)
{
    extern __shared__ float4 smem4[];
    const long long j =
        (long long)blockIdx.x * FDT_TILE_SPOTS + fdt_panel_spot();
    const bool valid = j < n;
    const long long jj = valid ? j : 0;
    const LoadSum ns{ns_t + jj, n};
    float dmax = 0.f, amax = 0.f;
    gs_pass_panel<TM>(beta_in + jj, n, beta_out + jj, n, xty_t + jj,
                      inv_den_t + jj, n, xtx, K, lam, rho, ns, valid,
                      reinterpret_cast<float*>(smem4), dmax, amax);
    store_block_partials(dmax, amax, partials);
}

// CUDA blocks of one launch over n spots at K: each writes one partial of
// each statistic.
extern "C" long long fdt_cd_block_sweep_blocks(long long n, int K)
{
    if (K > FDT_REGISTER_MAX_K)
        return (n + FDT_TILE_SPOTS - 1) / FDT_TILE_SPOTS;
    return fdt_blocks(n);
}

// Blocks of the panel kernel at FDT_REGISTER_MAX_K < K <= FDT_PANEL_MAX_K
// that one SM holds at once, by registers and shared memory; a negative
// cudaError_t if the query fails.
extern "C" int fdt_cd_block_sweep_panel_occupancy(int K)
{
    if (K <= FDT_REGISTER_MAX_K || K > FDT_PANEL_MAX_K)
        return -(int)cudaErrorInvalidValue;
    return fdt_panel_dispatch(K, [&](auto tm) {
        return fdt_occupancy(
            cd_block_sweep_panel_kernel<decltype(tm)::value>,
            fdt_panel_smem_floats(K) * sizeof(float));
    });
}

// FDT_REGISTER_MAX_K < K <= FDT_PANEL_MAX_K: the panel kernel of TM; its
// shared memory may pass 48 KB, so the attribute is set before every
// launch.
template <int TM>
static int launch_panel(const float* beta_in, float* beta_out,
                        const float* xty_t, const float* ns_t,
                        const float* inv_den_t, const float* xtx, int K,
                        long long n, float lam, float rho, float* partials,
                        cudaStream_t stream)
{
    const size_t smem = fdt_panel_smem_floats(K) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        cd_block_sweep_panel_kernel<TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)fdt_cd_block_sweep_blocks(n, K);
    cd_block_sweep_panel_kernel<TM><<<blocks, FDT_THREADS, smem, stream>>>(
        beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam, rho,
        partials);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of the register kernel of KMAX at K, in bytes.
static size_t register_smem(int KMAX, int K)
{
    return fdt_register_smem_floats(KMAX, K) * sizeof(float);
}

// The same for the register kernel at 1 <= K <= FDT_REGISTER_MAX_K.
extern "C" int fdt_cd_block_sweep_register_occupancy(int K)
{
    if (K < 1 || K > FDT_REGISTER_MAX_K) return -(int)cudaErrorInvalidValue;
    return fdt_register_dispatch(K, [&](auto kmax) {
        constexpr int KMAX = decltype(kmax)::value;
        return fdt_occupancy(cd_block_sweep_kernel<KMAX>,
                             register_smem(KMAX, K));
    });
}

// K <= FDT_REGISTER_MAX_K: the register kernel of KMAX; its shared memory
// passes 48 KB from K = 22, so the attribute is set before every launch.
template <int KMAX>
static int launch(const float* beta_in, float* beta_out, const float* xty_t,
                  const float* ns_t, const float* inv_den_t,
                  const float* xtx, int K, long long n, float lam, float rho,
                  float* partials, cudaStream_t stream)
{
    const size_t smem = register_smem(KMAX, K);
    const cudaError_t err = cudaFuncSetAttribute(
        cd_block_sweep_kernel<KMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)fdt_blocks(n);
    cd_block_sweep_kernel<KMAX><<<blocks, FDT_THREADS, smem, stream>>>(
        beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam, rho,
        partials);
    return (int)cudaGetLastError();
}

// Launches one pass on `stream`. `partials` holds
// 2 * fdt_cd_block_sweep_blocks(n, K) floats. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int fdt_cd_block_sweep(
    const float* beta_in, float* beta_out, const float* xty_t,
    const float* ns_t, const float* inv_den_t, const float* xtx, int K,
    long long n, float lam, float rho, float* partials, void* stream)
{
    if (K < 1 || K > FDT_PANEL_MAX_K || n < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (K > FDT_REGISTER_MAX_K)
        return fdt_panel_dispatch(K, [&](auto tm) {
            return launch_panel<decltype(tm)::value>(
                beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam,
                rho, partials, s);
        });
    return fdt_register_dispatch(K, [&](auto kmax) {
        return launch<decltype(kmax)::value>(beta_in, beta_out, xty_t, ns_t,
                                             inv_den_t, xtx, K, n, lam, rho,
                                             partials, s);
    });
}

// ---------------------------------------------------------------------------
// The gather tier's neighbour sums, in one launch.
//
// Replaces no Pallas kernel: the JAX package forms these sums in XLA
// (neighbor_sum in flashdeconv_tpu/ops/bcd.py, a gather and an add per
// degree slot), and so did the port in plain PyTorch until this kernel
// (flashdeconv_tpu_torch/ops/bcd.py:neighbor_sum_reference, still the path
// of a CPU or f64 carry). It writes ns[k, j] = sum over the slots d of
// src[k, nbr[d, j]] for a (K, n_cols) f32 source and a (D, n) int32
// slot-major table, in that path's order bit for bit: ns = src[:, slot 0],
// then one round-to-nearest add a slot, slot 1 first, no reassociation and
// no atomics. An index of n_cols (the sentinel of an unpadded carry) reads
// +0.0, as the plain path's zero column does, so a padding slot still adds
// +0.0 (which turns a -0.0 sum into +0.0, as there); an index below n_cols
// reads its column, so a source that carries its own zero column works too.
// Precondition: every index lies in [0, n_cols]. The table lives on the
// card and is not checked; the plain path raises on any other index.
//
// What bounds it: bytes. The tissue cell (417,768 spots, K = 20, D = 10)
// reads the table (16.7 MB) and the source (33.4 MB) and writes the sums
// (33.4 MB): 83.6 MB, 0.0249 ms at 3.35 TB/s (a derived count). The plain
// path moved ~1.6 GB in 20 launches for the same sums (a padded copy, D
// gathers, D - 1 adds). What the design does about it: one thread a spot,
// so a warp's load of one slot's indices is one coalesced 128-byte row of
// the slot-major table, and its writes of one row of ns are coalesced; the
// gathers of a row k land on neighbouring columns (kNN neighbours of a
// row-major section lie within about a row), so the source is read from
// L2 after its first touch; the K rows run in register chunks of NK
// (fdt_register_dispatch's 8, 16, 24 or 32: K rounded up to 8 at K <= 32,
// chunks of 32 above, so K has no limit), all NK loads of a slot issued
// together, and the next slot's index is loaded before this slot's values
// are summed.
template <int NK>
__global__ void __launch_bounds__(FDT_THREADS)
neighbor_sum_kernel(const float* __restrict__ src, const long long n_cols,
                    const int* __restrict__ nbr, const int D,
                    const long long n, const int K, float* __restrict__ out)
{
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    for (int k0 = 0; k0 < K; k0 += NK) {
        const float* rows = src + (long long)k0 * n_cols;
        const int rows_left = K - k0;
        float acc[NK];
        int c = __ldg(nbr + j);
        for (int d = 0; d < D; ++d) {
            const int c_next = d + 1 < D ? __ldg(nbr + (d + 1) * n + j) : 0;
            const bool in = c != n_cols;
            const float* p = rows + (in ? c : 0);
            float v[NK];
#pragma unroll
            for (int i = 0; i < NK; ++i, p += n_cols)
                v[i] = in && i < rows_left ? __ldg(p) : 0.f;
            if (d == 0) {
#pragma unroll
                for (int i = 0; i < NK; ++i) acc[i] = v[i];
            } else {
#pragma unroll
                for (int i = 0; i < NK; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
            }
            c = c_next;
        }
        float* o = out + (long long)k0 * n + j;
#pragma unroll
        for (int i = 0; i < NK; ++i, o += n)
            if (i < rows_left) *o = acc[i];
    }
}

template <int NK>
static int launch_neighbor_sum(const float* src, long long n_cols,
                               const int* nbr, int D, long long n, int K,
                               float* out, cudaStream_t stream)
{
    const unsigned blocks = (unsigned)fdt_blocks(n);
    const size_t smem = 0;
    neighbor_sum_kernel<NK><<<blocks, FDT_THREADS, smem, stream>>>(
        src, n_cols, nbr, D, n, K, out);
    return (int)cudaGetLastError();
}

// Launches the neighbour sums of `nbr` (D, n) int32 over `src` (K, n_cols)
// f32 into `out` (K, n) f32, all contiguous, on `stream`. Refuses (as
// cudaErrorInvalidValue) K, D, n or n_cols below 1, and n_cols past the
// int32 range of the table's indices. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fdt_neighbor_sum(const float* src, long long n_cols,
                                const int* nbr, int D, long long n, int K,
                                float* out, void* stream)
{
    if (K < 1 || D < 1 || n < 1 || n_cols < 1 || n_cols > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    return fdt_register_dispatch(K, [&](auto nk) {
        return launch_neighbor_sum<decltype(nk)::value>(
            src, n_cols, nbr, D, n, K, out, (cudaStream_t)stream);
    });
}
