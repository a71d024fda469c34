// CPU emulation of one sweep kernel's library, built with g++ from a copy
// of its source that tests/test_torch_kernel_emulation.py prepares
// (dynamic shared memory pointed at fdt_emu_smem, each launch turned into
// fdt_emu_launch, the PTX max.NaN replaced by host code). -DFUSED selects
// fused_banded_sweep.cu, else cd_block_sweep.cu; the library exports the
// source's own C entry points, so the wrappers' launch code drives it.
#include <cuda_runtime.h>  // the copy beside the sources, as they include it

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim, gridDim;
std::barrier<>* fdt_emu_barrier;
float fdt_emu_lanes[FDT_THREADS];
float4 fdt_emu_smem[1 << 16];  // 1 MB

#ifdef FUSED
#include "fused_banded_sweep.cu"
#else
#include "cd_block_sweep.cu"
#endif
