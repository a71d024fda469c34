// CPU emulation of one sweep kernel's library, built with g++ from a copy
// of its source that tests/test_torch_kernel_emulation.py prepares
// (dynamic shared memory pointed at fdt_emu_smem, each launch turned into
// fdt_emu_launch, the PTX max.NaN and cp.async and an empty asm replaced
// by host code).
// -DFUSED selects fused_banded_sweep.cu, else cd_block_sweep.cu (with two
// test-only entries below); the library exports the source's own C entry
// points, so the wrappers' launch code drives it.
#include <cuda_runtime.h>  // the copy beside the sources, as they include it

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim, gridDim;
std::barrier<>* fdt_emu_barrier;
float fdt_emu_lanes[FDT_THREADS];
float4 fdt_emu_smem[FDT_EMU_SMEM_BYTES / sizeof(float4)];
cudaError_t fdt_emu_error = cudaSuccess;

#ifdef FUSED
#include "fused_banded_sweep.cu"
#else
#include "cd_block_sweep.cu"

// Test-only entries, in this emulation of kernel #2 and not in the
// product: its register pass (cd_block_sweep_kernel<KMAX>, KMAX = K rounded
// up to 8, to 64) and its panel pass (cd_block_sweep_panel_kernel<TM>, TM =
// ceil(K/32)) on the same operands at any K <= 64, whichever form the
// product's dispatch takes there. Each writes the partials of its own grid
// (fdt_blocks(n) blocks, and one block per FDT_TILE_SPOTS spots).
#define FDT_EMU_PASS_PARAMS                                                 \
    const float *beta_in, float *beta_out, const float *xty_t,              \
        const float *ns_t, const float *inv_den_t, const float *xtx, int K, \
        long long n, float lam, float rho, float *partials
#define FDT_EMU_PASS_ARGS                                                   \
    beta_in, beta_out, xty_t, ns_t, inv_den_t, xtx, K, n, lam, rho, partials

template <int KMAX>
static int emu_register_pass(FDT_EMU_PASS_PARAMS)
{
    fdt_emu_launch((unsigned)fdt_blocks(n),
                   register_smem(KMAX, K), [&] {
                       cd_block_sweep_kernel<KMAX>(FDT_EMU_PASS_ARGS);
                   });
    return cudaGetLastError();
}

extern "C" int fdt_emu_register_pass(FDT_EMU_PASS_PARAMS)
{
    switch ((K + 7) / 8) {
    case 1: return emu_register_pass<8>(FDT_EMU_PASS_ARGS);
    case 2: return emu_register_pass<16>(FDT_EMU_PASS_ARGS);
    case 3: return emu_register_pass<24>(FDT_EMU_PASS_ARGS);
    case 4: return emu_register_pass<32>(FDT_EMU_PASS_ARGS);
    case 5: return emu_register_pass<40>(FDT_EMU_PASS_ARGS);
    case 6: return emu_register_pass<48>(FDT_EMU_PASS_ARGS);
    case 7: return emu_register_pass<56>(FDT_EMU_PASS_ARGS);
    case 8: return emu_register_pass<64>(FDT_EMU_PASS_ARGS);
    default: return cudaErrorInvalidValue;
    }
}

extern "C" int fdt_emu_panel_pass(FDT_EMU_PASS_PARAMS)
{
    const unsigned blocks = (unsigned)((n + FDT_TILE_SPOTS - 1) / FDT_TILE_SPOTS);
    if (K < 1 || K > 64) return cudaErrorInvalidValue;
    fdt_emu_launch(blocks, fdt_panel_smem_floats(K) * sizeof(float), [&] {
        if (K <= 32)
            cd_block_sweep_panel_kernel<1>(FDT_EMU_PASS_ARGS);
        else
            cd_block_sweep_panel_kernel<2>(FDT_EMU_PASS_ARGS);
    });
    return cudaGetLastError();
}
#endif
