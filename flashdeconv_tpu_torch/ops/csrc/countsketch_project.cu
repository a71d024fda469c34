// CountSketch projection of dense rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _countsketch_kernel in
// flashdeconv_tpu/ops/countsketch.py (run by countsketch_project_pallas
// there), which the dense-count sketch runs when G >= 4096 and N >= 1024.
// Its plain PyTorch version is
// flashdeconv_tpu_torch/ops/countsketch.py:countsketch_project_reference.
//
// What it computes: out[r, c] = sum over the genes g with bucket[g] == c of
// w[g] * y[r, g], for y (n, g) f32 row-major and out (n, d) f32, with the
// operator Omega never stored. The genes of each bucket are summed in
// ascending gene order with explicit __fmaf_rn from 0, every output is
// written once by one thread, and there are no atomics, so two calls on the
// same input give the same bits.
//
// The wrapper hands the genes sorted by (gene tile, bucket, gene):
// genes[i] and w[i] are the i-th gene of that order and its weight, and
// ptr[t * d + c] .. ptr[t * d + c + 1] is the range of tile t's genes of
// bucket c (ptr has n_tiles * d + 1 entries). Summing tile by tile, each
// tile's genes ascending, is summing every bucket's genes ascending.
//
// What bounds it: bytes. At 262,144 x 5,001 -> 512 a call reads y (5.24 GB)
// and writes out (0.54 GB): about 1.73 ms at 3.35 TB/s (a count from the
// shapes, not a measurement); its N*G multiply-adds are far below the
// card's rate. The TPU built a weighted one-hot (gene block x d) per block
// and multiplied it on the MXU, d-fold the needed work; here each element
// of y is read from device memory once and used once. What the design does
// about it: a block stages CS_ROWS rows x CS_GENE_TILE genes of y in shared
// memory with coalesced streaming loads (consecutive threads, consecutive
// genes), then each thread sums its own output columns' genes of that tile
// from shared memory into registers (CS_COLS_PER_THREAD columns x CS_ROWS
// rows), and carries the sums across the gene tiles. A d wider than
// CS_COLS columns takes more blocks along grid y, each reading its rows of
// y again; any n, g and d launch, nothing is sized at compile time but the
// tile. A simple plan: no cp.async double buffer, no TMA.
// Launch: on the caller's stream, no allocation, no synchronisation.

#include <cuda_runtime.h>

#define CS_THREADS 256
#define CS_ROWS 8
#define CS_GENE_TILE 1024
#define CS_COLS_PER_THREAD 2
#define CS_COLS (CS_THREADS * CS_COLS_PER_THREAD)

__global__ void __launch_bounds__(CS_THREADS)
countsketch_project_kernel(const float* __restrict__ y, const long long n,
                           const int g, const int* __restrict__ genes,
                           const float* __restrict__ w,
                           const int* __restrict__ ptr, const int d,
                           float* __restrict__ out)
{
    __shared__ float tile[CS_ROWS][CS_GENE_TILE];  // 32 KB

    const long long r0 = (long long)blockIdx.x * CS_ROWS;
    const int rows = (int)min((long long)CS_ROWS, n - r0);
    const int c0 = blockIdx.y * CS_COLS;
    const int t = threadIdx.x;
    const int n_tiles = (g + CS_GENE_TILE - 1) / CS_GENE_TILE;

    float acc[CS_COLS_PER_THREAD][CS_ROWS];
#pragma unroll
    for (int q = 0; q < CS_COLS_PER_THREAD; ++q)
#pragma unroll
        for (int r = 0; r < CS_ROWS; ++r)
            acc[q][r] = 0.f;

    for (int tt = 0; tt < n_tiles; ++tt) {
        const int g0 = tt * CS_GENE_TILE;
        const int width = min(CS_GENE_TILE, g - g0);
        __syncthreads();  // every thread is done with the previous tile
#pragma unroll
        for (int r = 0; r < CS_ROWS; ++r) {
#pragma unroll
            for (int k = 0; k < CS_GENE_TILE / CS_THREADS; ++k) {
                const int j = k * CS_THREADS + t;
                float v = 0.f;
                if (r < rows && j < width)
                    v = __ldcs(y + (r0 + r) * (long long)g + g0 + j);
                tile[r][j] = v;
            }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < CS_COLS_PER_THREAD; ++q) {
            const int c = c0 + q * CS_THREADS + t;
            if (c < d) {
                const int* p = ptr + (long long)tt * d + c;
                const int end = p[1];
                for (int i = p[0]; i < end; ++i) {
                    const int j = genes[i] - g0;
                    const float wv = w[i];
#pragma unroll
                    for (int r = 0; r < CS_ROWS; ++r)
                        acc[q][r] = __fmaf_rn(wv, tile[r][j], acc[q][r]);
                }
            }
        }
    }

#pragma unroll
    for (int q = 0; q < CS_COLS_PER_THREAD; ++q) {
        const int c = c0 + q * CS_THREADS + t;
        if (c < d) {
#pragma unroll
            for (int r = 0; r < CS_ROWS; ++r)
                if (r < rows)
                    out[(r0 + r) * (long long)d + c] = acc[q][r];
        }
    }
}

// The gene tile of the sort order the wrapper builds.
extern "C" int fdt_countsketch_gene_tile(void)
{
    return CS_GENE_TILE;
}

// Launches one projection on `stream`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fdt_countsketch_project(const float* y, long long n, int g,
                                       const int* genes, const float* w,
                                       const int* ptr, int d, float* out,
                                       void* stream)
{
    if (n < 1 || g < 1 || d < 1)
        return (int)cudaErrorInvalidValue;
    const long long row_blocks = (n + CS_ROWS - 1) / CS_ROWS;
    const long long col_blocks = (d + CS_COLS - 1) / CS_COLS;
    if (row_blocks > 0x7fffffffLL || col_blocks > 65535)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)row_blocks, (unsigned)col_blocks);
    countsketch_project_kernel<<<grid, CS_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        y, n, g, genes, w, ptr, d, out);
    return (int)cudaGetLastError();
}

extern "C" const char* fdt_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
