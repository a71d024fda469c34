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
// What bounds it: bytes. At 1M spots and K = 20 one launch reads beta,
// Xty, ns and inv_den (4 x 80 MB) and writes the new beta (80 MB): 400 MB,
// about 0.12 ms at 3.35 TB/s (a derived count, not a measurement); about
// K*K multiply-adds per spot are far below the card's rate. What the
// design does about it: one thread per spot, so a warp's loads of one row
// k touch 32 neighbouring floats and every operand is read once and the
// new beta written once; beta_old and the numerators stay in registers
// (gs_pass.cuh) and XtX in shared memory. The pass is Jacobi across spots:
// it reads one beta and writes another, never in place.
//
// At 64 < K <= 256 a second kernel, cd_block_sweep_panel_kernel, runs the
// panel pass of gs_pass_panel.cuh on the same operands (the counterpart of
// _cd_block_kernel with _gs_pass_kb_panel in flashdeconv_tpu/ops/bcd.py;
// the JAX package runs it there to K = 128 and its XLA pass above). It is
// bound by operations at K = 128 and 256 (about 3K^2 f32 operations per
// spot against about 20K bytes: 0.75 ms and 3.0 ms at 1M spots, derived,
// not measured). A block owns 64 spots; the pass runs its XtX products as
// register-tiled tile products of TM rows x 8 spots a thread
// (gs_pass_panel.cuh says why), so the kernel is templated on TM =
// ceil(K/32), 3..8. Its shared memory passes 48 KB above K = 80, so every
// launch sets cudaFuncAttributeMaxDynamicSharedMemorySize first and
// returns that call's error if it fails.
// Launch: on the caller's stream, no allocation, no synchronisation.

#include "gs_pass_panel.cuh"

// ns(k) of one spot: a load from the precomputed neighbour sums.
struct LoadSum {
    const float* col;  // the spot's column of ns (K, n)
    long long ld;      // n

    __device__ __forceinline__ float operator()(int k) const
    {
        return col[k * ld];
    }

    // s[j] = (*this)(k0 + j * step) for the rows below lim.
    template <int N>
    __device__ __forceinline__ void rows(int k0, int step, int lim,
                                         float (&s)[N]) const
    {
#pragma unroll
        for (int j = 0; j < N; ++j)
            s[j] = k0 + j * step < lim ? col[(k0 + j * step) * ld] : 0.f;
    }
};

template <int KMAX>
__global__ void __launch_bounds__(FDT_THREADS)
cd_block_sweep_kernel(const float* __restrict__ beta_in,
                      float* __restrict__ beta_out,
                      const float* __restrict__ xty_t,
                      const float* __restrict__ ns_t,
                      const float* __restrict__ inv_den_t,
                      const float* __restrict__ xtx, const int K,
                      const long long n, const float lam, const float rho,
                      float* __restrict__ partials)
{
    extern __shared__ float xtx_s[];  // K*K
    load_xtx(xtx, xtx_s, K);
    __syncthreads();

    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float dmax = 0.f, amax = 0.f;
    if (j < n) {
        const LoadSum ns{ns_t + j, n};
        gs_pass_spot<KMAX>(beta_in + j, n, beta_out + j, n, xty_t + j,
                           inv_den_t + j, n, xtx_s, K, lam, rho, ns, dmax,
                           amax);
    }
    store_block_partials(dmax, amax, partials);
}

// 64 < K <= 256, TM = fdt_panel_tm(K): a block of 256 threads passes over
// FDT_TILE_SPOTS spots, thread t spot blockIdx.x * FDT_TILE_SPOTS +
// fdt_panel_spot() (the spot layout of gs_pass_panel.cuh).
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

// Blocks of the panel kernel at 64 < K <= 256 that one SM holds at once,
// by registers and shared memory; a negative cudaError_t if the query
// fails.
extern "C" int fdt_cd_block_sweep_panel_occupancy(int K)
{
    if (K <= FDT_REGISTER_MAX_K || K > FDT_PANEL_MAX_K)
        return -(int)cudaErrorInvalidValue;
    return fdt_panel_dispatch(K, [&](auto tm) {
        return fdt_panel_occupancy(
            cd_block_sweep_panel_kernel<decltype(tm)::value>,
            fdt_panel_smem_floats(K) * sizeof(float));
    });
}

// 64 < K <= 256: the panel kernel of TM; its shared memory may pass 48 KB,
// so the attribute is set before every launch.
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

template <int KMAX>
static void launch(const float* beta_in, float* beta_out, const float* xty_t,
                   const float* ns_t, const float* inv_den_t,
                   const float* xtx, int K, long long n, float lam, float rho,
                   float* partials, cudaStream_t stream)
{
    const unsigned blocks = (unsigned)fdt_blocks(n);
    const size_t smem = (size_t)K * K * sizeof(float);  // 16 KB at K = 64
    cd_block_sweep_kernel<KMAX><<<blocks, FDT_THREADS, smem, stream>>>(
        beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam, rho,
        partials);
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
    if (K <= 8)
        launch<8>(beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam,
                  rho, partials, s);
    else if (K <= 16)
        launch<16>(beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n,
                   lam, rho, partials, s);
    else if (K <= 32)
        launch<32>(beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n,
                   lam, rho, partials, s);
    else
        launch<64>(beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n,
                   lam, rho, partials, s);
    return (int)cudaGetLastError();
}
