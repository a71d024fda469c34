// Host stand-ins for the CUDA names the port's sweep kernels use, so that
// their sources compile with g++ and run on the CPU: one std::thread per
// CUDA thread, a std::barrier for __syncthreads, round-to-nearest float
// operations for the __f*_rn intrinsics (compile with -ffp-contract=off).
// A launch `kernel<<<blocks, FDT_THREADS, smem, stream>>>(args)` becomes
// fdt_emu_launch(blocks, smem, [&] { kernel(args); }) in the host copy of a
// source: its CUDA blocks run one after another, so a block's shared
// memory is one static buffer. The FDT_EMU_GUARD bytes after the launch's
// smem bytes are filled with 0xff (a NaN as f32) before each block and
// checked after it: a block that writes past its dynamic shared memory
// fails the launch (cudaGetLastError returns cudaErrorIllegalAddress), and
// one that reads there reads NaN.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// The sources' own block size, which the launch emulation needs before
// gs_pass.cuh defines it (again, with the same value).
#define FDT_THREADS 256

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
    unsigned x, y, z;
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, blockDim, gridDim;

struct alignas(16) float4 {
    float x, y, z, w;
};
struct alignas(8) float2 {
    float x, y;
};
inline float4 make_float4(float x, float y, float z, float w)
{
    return {x, y, z, w};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
    cudaSuccess = 0,
    cudaErrorInvalidValue = 1,
    cudaErrorIllegalAddress = 700
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int)
{
    return cudaSuccess;
}
// One block an SM: the emulator runs its blocks one after another.
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, T, int, std::size_t)
{
    *n = 1;
    return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
extern cudaError_t fdt_emu_error;  // the last launch's, as on the card
inline cudaError_t cudaGetLastError()
{
    const cudaError_t err = fdt_emu_error;
    fdt_emu_error = cudaSuccess;
    return err;
}

// A read through the read-only data cache: a plain load on the host.
template <class T>
inline T __ldg(const T* p)
{
    return *p;
}

inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }

extern std::barrier<>* fdt_emu_barrier;
extern float fdt_emu_lanes[];
extern float4 fdt_emu_smem[];
#define FDT_EMU_SMEM_BYTES (1 << 20)
#define FDT_EMU_GUARD 4096

inline void __syncthreads() { fdt_emu_barrier->arrive_and_wait(); }

// Every thread of the block calls it at the same point, as the kernels'
// block reduction does.
inline float __shfl_xor_sync(unsigned, float v, int offset)
{
    fdt_emu_lanes[threadIdx.x] = v;
    fdt_emu_barrier->arrive_and_wait();
    const float r = fdt_emu_lanes[threadIdx.x ^ offset];
    fdt_emu_barrier->arrive_and_wait();
    return r;
}

// Runs `body` as `blocks` CUDA blocks of FDT_THREADS threads, one block
// after another, each with smem bytes of dynamic shared memory.
template <class Body>
inline void fdt_emu_launch(unsigned blocks, std::size_t smem, Body body)
{
    std::barrier<> bar(FDT_THREADS);
    fdt_emu_barrier = &bar;
    blockDim = {FDT_THREADS, 1, 1};
    gridDim = {blocks, 1, 1};
    if (smem + FDT_EMU_GUARD > FDT_EMU_SMEM_BYTES) {
        fdt_emu_error = cudaErrorInvalidValue;
        return;
    }
    unsigned char* guard =
        reinterpret_cast<unsigned char*>(fdt_emu_smem) + smem;
    for (unsigned b = 0; b < blocks; ++b) {
        std::memset(guard, 0xff, FDT_EMU_GUARD);
        blockIdx = {b, 0, 0};
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < FDT_THREADS; ++t)
            threads.emplace_back([&body, t] {
                threadIdx = {t, 0, 0};
                body();
            });
        for (auto& th : threads) th.join();
        for (int i = 0; i < FDT_EMU_GUARD; ++i)
            if (guard[i] != 0xff) fdt_emu_error = cudaErrorIllegalAddress;
    }
}
