// Host stand-ins for the CUDA names the port's sweep kernels use, so that
// their sources compile with g++ and run on the CPU: one std::thread per
// CUDA thread, a std::barrier for __syncthreads, round-to-nearest float
// operations for the __f*_rn intrinsics (compile with -ffp-contract=off).
// The CUDA blocks of a launch run one after another (emulate.cpp), so a
// block's shared memory is one static buffer.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
    unsigned x, y, z;
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, blockDim, gridDim;

struct alignas(16) float4 {
    float x, y, z, w;
};

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int)
{
    return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

extern std::barrier<>* fdt_emu_barrier;
extern float fdt_emu_lanes[];
extern float4 fdt_emu_smem[];

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
