// CPU emulation of one sweep kernel, built with g++ from a copy of its
// source that tests/test_torch_kernel_emulation.py prepares (dynamic
// shared memory pointed at fdt_emu_smem, launches and the PTX max.NaN
// replaced by host code). -DFUSED selects fused_banded_sweep.cu, else
// cd_block_sweep.cu. Each entry point dispatches on K as the source's own
// launcher does and runs the CUDA blocks one after another, each as
// FDT_THREADS std::threads.
#include <thread>
#include <vector>

#ifdef FUSED
#include "fused_banded_sweep.cu"
#else
#include "cd_block_sweep.cu"
#endif

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim, gridDim;
std::barrier<>* fdt_emu_barrier;
float fdt_emu_lanes[FDT_THREADS];
float4 fdt_emu_smem[1 << 16];  // 1 MB

template <class Body>
static void run_blocks(long long blocks, Body body)
{
    std::barrier<> bar(FDT_THREADS);
    fdt_emu_barrier = &bar;
    blockDim = {FDT_THREADS, 1, 1};
    gridDim = {(unsigned)blocks, 1, 1};
    for (long long b = 0; b < blocks; ++b) {
        blockIdx = {(unsigned)b, 0, 0};
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < FDT_THREADS; ++t)
            threads.emplace_back([&body, t] {
                threadIdx = {t, 0, 0};
                body();
            });
        for (auto& th : threads) th.join();
    }
}

#ifdef FUSED
extern "C" long long emu_fused_banded_sweep(
    const float* carry_in, float* carry_out, const float* xty_t,
    const uint8_t* masks, const float* inv_den_t, const float* xtx,
    const int* offsets, int n_bands, int K, long long n_ext, long long pad,
    long long n_solve, float lam, float rho, float* partials)
{
    BandOffsets offs;
    for (int u = 0; u < FDT_MAX_BANDS; ++u)
        offs.v[u] = u < n_bands ? offsets[u] : 0;
    const long long blocks = fdt_fused_banded_sweep_blocks(n_ext, K);
#define FDT_EMU_ARGS                                                        \
    carry_in, carry_out, xty_t, masks, inv_den_t, xtx, offs, n_bands, K,    \
        n_ext, pad, n_solve, lam, rho, partials
    if (K > FDT_REGISTER_MAX_K)
        run_blocks(blocks, [&] { fused_banded_sweep_panel_kernel(FDT_EMU_ARGS); });
    else if (K <= 8)
        run_blocks(blocks, [&] { fused_banded_sweep_kernel<8>(FDT_EMU_ARGS); });
    else if (K <= 16)
        run_blocks(blocks, [&] { fused_banded_sweep_kernel<16>(FDT_EMU_ARGS); });
    else if (K <= 32)
        run_blocks(blocks, [&] { fused_banded_sweep_kernel<32>(FDT_EMU_ARGS); });
    else
        run_blocks(blocks, [&] { fused_banded_sweep_kernel<64>(FDT_EMU_ARGS); });
    return blocks;
}
#else
extern "C" long long emu_cd_block_sweep(
    const float* beta_in, float* beta_out, const float* xty_t,
    const float* ns_t, const float* inv_den_t, const float* xtx, int K,
    long long n, float lam, float rho, float* partials)
{
    const long long blocks = fdt_cd_block_sweep_blocks(n, K);
#define FDT_EMU_ARGS                                                        \
    beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam, rho, partials
    if (K > FDT_REGISTER_MAX_K)
        run_blocks(blocks, [&] { cd_block_sweep_panel_kernel(FDT_EMU_ARGS); });
    else if (K <= 8)
        run_blocks(blocks, [&] { cd_block_sweep_kernel<8>(FDT_EMU_ARGS); });
    else if (K <= 16)
        run_blocks(blocks, [&] { cd_block_sweep_kernel<16>(FDT_EMU_ARGS); });
    else if (K <= 32)
        run_blocks(blocks, [&] { cd_block_sweep_kernel<32>(FDT_EMU_ARGS); });
    else
        run_blocks(blocks, [&] { cd_block_sweep_kernel<64>(FDT_EMU_ARGS); });
    return blocks;
}
#endif
