// The Gauss-Seidel coordinate pass at 32 < K <= 384, in panels of 16
// coordinates, shared by both sweep kernels (fused_banded_sweep.cu and
// cd_block_sweep.cu) so that the fused and unfused banded sweeps stay
// bitwise equal on the card at every K. Two schedules of it: the tile pass
// (gs_pass_panel, this note) and, for kernel #1 at K <= 64, the spot-panel
// pass (gs_pass_spot_panel, its note at the end of this file).
//
// Replaces the panel pass of the Pallas TPU kernels in
// flashdeconv_tpu/ops/bcd.py (_gs_prologue, _gs_pass_kb_panel with
// _gs_panel_width = 16 above K = 64, dispatched by gs_pass); its plain
// PyTorch version is flashdeconv_tpu_torch/ops/bcd.py:gs_pass. It computes
// what gs_pass_spot (gs_pass.cuh) computes, with the same association:
//   C_k   = Xty[k] + lam*ns_k - sum_i XtX[k,i]*beta_old_i (i ascending)
//           + XtX[k,k]*beta_old_k - rho
//   r_k   = C_k - XtX[k,0]*delta_0 - XtX[k,1]*delta_1 - ...   (one FMA each,
//           c ascending over the coordinates already done)
//   delta_k = max(r_k, 0) * inv_den[k] - beta_old_k,  beta_new_k = delta_k
//           + beta_old_k
// Only the schedule differs: gs_pass_spot keeps beta_old and r of one spot
// in two register arrays of KMAX floats, which at K = 128 would need more
// than the 255 registers a thread may have, and above K = 32 hold too few
// blocks an SM to hide its loads.
//
// What bounds it on an H100: at 1M spots about 3K^2 f32 operations per
// spot (the prologue's K^2 multiply-adds and the corrections' K^2/2)
// against about 20K bytes per spot (beta in and out, Xty, inv_den, and ns
// for kernel #2): operations at K = 128 (0.75 ms at 67 TFLOP/s against
// 0.61-0.76 ms of bytes at 3.35 TB/s) and K = 256 (3.0 ms against 1.3-1.5
// ms), about level at K = 96 (derived counts, not measurements). So the
// multiply-adds must run near the FMA rate, which needs (1) few
// shared-memory loads per FMA, (2) no warp left idle for long, and (3)
// enough loads from device memory in flight in the phases that have no
// FMAs to hide them.
//
// The design: one CUDA block of 256 threads owns FDT_TILE_SPOTS = 64 spots.
//   - Two layouts. In the spot layout each thread stands for one spot
//     (fdt_panel_spot: two warps cover the 64 spots, so a warp's load of
//     row k of a (K, n) operand reads 32 neighbouring floats, and the 8
//     warps cover 4 rows at a time); the neighbour sums, numerators and
//     the recurrence run there. In the tile layout thread t owns a
//     register tile of TM rows x 8 spots of the (RP, 64) numerator matrix
//     R, rows TM*(t/8) .. +TM-1, spots 8*(t%8) .. +7, RP = 32*TM >= K
//     (TM = ceil(K/32): 2 at K = 33-64, 3 at 96, 4 at 128, 8 at 256, 11 at
//     338, 12 at 384); the two tile products run there.
//   - (1) The prologue is one tile product over all rows at once,
//     P = XtX[:RP, :kp] . B_old (kp = K rounded up to 16). XtX is streamed
//     through shared memory in strips of 16 columns, stored transposed so
//     that a thread's TM rows at one column are contiguous; per column a
//     thread loads its TM XtX values (float4 / float2 / scalar as TM
//     allows) and two float4s of beta and runs 8*TM FMAs: at K = 256, 4
//     loads feed 64 FMAs. A warp's float4 load is served as four
//     quarter-warp wavefronts, so 8 x 8 is the tile at which the loads
//     keep pace with the FMAs (8 x 4 needs 1.5 times the FMAs' time in
//     wavefronts).
//   - Then the spot layout turns P into C (panel_numerator) through an R
//     tile in shared memory, in two rounds of RP/2 rows (the tile reuses
//     the strip buffers), and every thread takes its rows of C back into
//     its register tile. (3) The neighbour sums go NB = 4 rows at a time
//     (the functors' rows()), so a band's four loads are in flight
//     together; beta_old is loaded 8 rows at a time for the same reason.
//   - Per panel [a, a+16): the owners of rows a..a+15 hand them to the
//     recurrence through shared memory; the two warps of spot-layout row
//     0 run the 16-step recurrence for their 32 spots each (in-panel
//     coefficients from the same strip) and write the panel's 16 delta
//     rows; then all 256 threads apply them to
//     every row below, right-looking, in one register-tiled product:
//     R[k, s] -= sum_c XtX[k, c] * delta[c, s] for k >= a + 16, c
//     ascending (the strip XtX[a:RP, a:a+16], the prologue's shape, so
//     both steps share one staging routine and one micro-kernel). Panels
//     go in ascending order, so every r_k takes its corrections with c
//     ascending, the association above. (2) A warp whose rows
//     are all done skips the product, so the SM's issue slots go to the
//     other warps and blocks.
//   - Each strip is loaded and stored just before its barrier; measured
//     on the card, holding the next strip in registers across the FMAs
//     cost more in registers (spills, fewer blocks) than it hid. A block
//     streams XtX about 1.5 times a pass (all of it for the prologue, the
//     rows below each panel for the corrections), from the 50 MB L2.
//   - Shared memory: beta_old (kp x 64), two strip buffers (16 x (RP + 4)
//     each, the +4 spreading the transposing stores over the banks), and
//     16 x 64 each of the panel's r, delta and inv_den: 111,104 B at
//     K = 256 (2 blocks an SM), 61,952 B at K = 128 and 49,664 B at K = 96
//     (3 blocks an SM, the registers' limit: 80 a thread). The launchers
//     set cudaFuncAttributeMaxDynamicSharedMemorySize before every launch.
//   - Above K = 256 (TM = 9..12, to FDT_PANEL_MAX_K = 384) the same code
//     runs one block an SM: 119,296 B at K = 257, 147,968 B at K = 338 and
//     160,256 B at K = 384 leave no room for a second block under the
//     H100's 227 KB, so ptxas may give a thread up to 255 registers, which
//     hold the 72- to 96-float register tile (ptxas, CUDA 12.8: 168 / 193 /
//     207 / 223 registers at TM = 9 / 10 / 11 / 12, no spill; a 1M-spot
//     sweep at K = 338 took 33.3 ms against a 5.2 ms bound, PERF.md).
//   - Every sum has one fixed order and every operation is an explicit
//     __fmaf_rn / __fadd_rn / __fsub_rn, with no atomics, so two launches
//     are bitwise equal and both kernels give the same bits on the same
//     operands.

#pragma once

#include <type_traits>

#include "gs_pass.cuh"

#define FDT_PANEL 16        // coordinates of one panel, columns of a strip
#define FDT_TILE_SPOTS 64   // spots of one CUDA block
#define FDT_TILE_TN (FDT_TILE_SPOTS / 8)     // spots of a register tile
#define FDT_SPOT_WARPS (FDT_TILE_SPOTS / 32) // warps of a spot-layout row
#define FDT_SPOT_ROWS (FDT_THREADS / 32 / FDT_SPOT_WARPS)  // rows a pass
#define FDT_PANEL_MAX_K 384

static_assert(FDT_THREADS == 256 && FDT_TILE_TN % 4 == 0 &&
              FDT_TILE_SPOTS % 32 == 0,
              "8 threads of TN spots cover a tile row; 32 row groups");

// The spot (0 .. FDT_TILE_SPOTS - 1) of the calling thread in the spot
// layout, and the first spot-layout row of its warp.
__device__ __forceinline__ int fdt_panel_spot()
{
    return (threadIdx.x >> 5) % FDT_SPOT_WARPS * 32 + (threadIdx.x & 31);
}
__device__ __forceinline__ int fdt_panel_spot_row()
{
    return (threadIdx.x >> 5) / FDT_SPOT_WARPS;
}

// Blocks an SM the panel kernel of TM asks ptxas to fit by registers
// (__launch_bounds__): 3 (80 registers) at TM <= 4, 2 (128) to TM = 8,
// where shared memory holds 2-3 blocks at K = 161-256 anyway, and 1 (255)
// above, where shared memory holds one.
#define FDT_PANEL_MIN_BLOCKS(TM) ((TM) <= 4 ? 3 : (TM) <= 8 ? 2 : 1)

// K rounded up to a whole panel.
__host__ __device__ __forceinline__ int fdt_panel_kp(int K)
{
    return (K + FDT_PANEL - 1) / FDT_PANEL * FDT_PANEL;
}

// Rows of a thread's register tile at K: RP = 32 * TM rows cover K.
__host__ __device__ __forceinline__ int fdt_panel_tm(int K)
{
    return (K + 31) / 32;
}

// Floats of dynamic shared memory gs_pass_panel takes at K: the beta_old
// tile (kp x 32), two strips (16 x (RP + 4) each), the panel's r, delta
// and reciprocal denominators (16 x 32 each).
__host__ __device__ __forceinline__ int fdt_panel_smem_floats(int K)
{
    const int rp = 32 * fdt_panel_tm(K);
    return fdt_panel_kp(K) * FDT_TILE_SPOTS + 2 * FDT_PANEL * (rp + 4)
           + 3 * FDT_PANEL * FDT_TILE_SPOTS;
}

// f(std::integral_constant<int, TM>{}) with TM = fdt_panel_tm(K), 2..12
// at FDT_REGISTER_MAX_K < K <= FDT_PANEL_MAX_K: the launchers' choice of
// the pass's instance. A launcher whose tile pass starts at MIN_TM = 3
// (kernel #1, which runs the spot-panel pass below) builds no TM = 2
// instance, and K of that tile is refused.
template <int MIN_TM = 2, class F>
static int fdt_panel_dispatch(const int K, F f)
{
    switch (fdt_panel_tm(K)) {
    case 2:
        if constexpr (MIN_TM > 2) return -(int)cudaErrorInvalidValue;
        else return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    default: return f(std::integral_constant<int, 12>{});
    }
}

// Blocks of a `kernel` one SM holds at once with smem bytes of dynamic
// shared memory; a negative cudaError_t if a query fails.
template <class Kernel>
static int fdt_occupancy(Kernel kernel, const size_t smem)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int n = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, FDT_THREADS, smem);
    return err == cudaSuccess ? n : -(int)err;
}

// Bytes of dynamic shared memory the panel pass takes at K (the fused
// kernel adds its band offsets).
extern "C" long long fdt_panel_pass_smem_bytes(int K)
{
    return (long long)fdt_panel_smem_floats(K) * sizeof(float);
}

// C_k of the thread's spot, given p = sum_i XtX[k,i]*beta_old_i and its
// neighbour sum nsk; 0 for a padding row or a thread without a spot.
__device__ __forceinline__ float panel_numerator(
    const int k, const int K, const bool valid, const float p,
    const float* __restrict__ xty, const long long ld, const float xkk,
    const float bk, const float lam, const float rho, const float nsk)
{
    if (!valid || k >= K) return 0.f;
    float c = __fmaf_rn(lam, nsk, xty[k * ld]);
    c = __fsub_rn(c, p);
    c = __fmaf_rn(xkk, bk, c);
    return __fsub_rn(c, rho);
}

// The TM floats at p (a thread's rows at one strip column), in the widest
// loads their alignment allows (p is TM-float aligned, the strip's row
// length a multiple of 4).
template <int TM>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[TM])
{
    if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int j = 0; j < TM / 4; ++j) {
            const float4 v = reinterpret_cast<const float4*>(p)[j];
            x[4 * j] = v.x;
            x[4 * j + 1] = v.y;
            x[4 * j + 2] = v.z;
            x[4 * j + 3] = v.w;
        }
    } else if constexpr (TM % 2 == 0) {
#pragma unroll
        for (int j = 0; j < TM / 2; ++j) {
            const float2 v = reinterpret_cast<const float2*>(p)[j];
            x[2 * j] = v.x;
            x[2 * j + 1] = v.y;
        }
    } else {
#pragma unroll
        for (int m = 0; m < TM; ++m) x[m] = p[m];
    }
}

// The register-tiled product of one strip: for c = 0..15 ascending,
// acc[m][n] = fma(+-xs[c, row0 + m], bt[c, s0 + n], acc[m][n]), the minus
// sign with SUB; with SUB only rows >= lo change. xs is a strip (16 x ld,
// transposed: column c's rows contiguous), bt a (16, FDT_TILE_SPOTS) tile
// of beta_old or delta.
template <int TM, bool SUB>
__device__ __forceinline__ void strip_product(
    float (&acc)[TM][FDT_TILE_TN], const float* __restrict__ xs,
    const int ldx, const float* __restrict__ bt, const int row0,
    const int s0, const int lo)
{
    constexpr int TN = FDT_TILE_TN;
#pragma unroll 2
    for (int c = 0; c < FDT_PANEL; ++c) {
        float x[TM];
        load_rows<TM>(xs + c * ldx + row0, x);
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(
                bt + c * FDT_TILE_SPOTS + s0 + 4 * j);
            b[4 * j] = v.x;
            b[4 * j + 1] = v.y;
            b[4 * j + 2] = v.z;
            b[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            if (SUB && row0 + m < lo) continue;
            const float u = SUB ? -x[m] : x[m];
#pragma unroll
            for (int n = 0; n < TN; ++n)
                acc[m][n] = __fmaf_rn(u, b[n], acc[m][n]);
        }
    }
}

// The thread's register tile rows [row0 - r0, row0 - r0 + TM) into (LOAD
// false) or out of (LOAD true) a (rows, FDT_TILE_SPOTS) tile t.
template <int TM, bool LOAD>
__device__ __forceinline__ void tile_rows(float (&acc)[TM][FDT_TILE_TN],
                                          float* __restrict__ t,
                                          const int row, const int s0)
{
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < FDT_TILE_TN / 4; ++j) {
            float4* v = reinterpret_cast<float4*>(
                t + (row + m) * FDT_TILE_SPOTS + s0 + 4 * j);
            if (LOAD) {
                const float4 w = *v;
                acc[m][4 * j] = w.x;
                acc[m][4 * j + 1] = w.y;
                acc[m][4 * j + 2] = w.z;
                acc[m][4 * j + 3] = w.w;
            } else {
                *v = make_float4(acc[m][4 * j], acc[m][4 * j + 1],
                                 acc[m][4 * j + 2], acc[m][4 * j + 3]);
            }
        }
}

// Strip XtX[row_lo:RP, col0:col0+16] (zero outside XtX) into a strip
// buffer, transposed (rows contiguous per column, row length ldx): element
// e = row * 16 + c, thread t takes e = row_lo * 16 + t + 256 * u, all its
// loads issued before its stores.
template <int TM>
__device__ __forceinline__ void stage_strip(float* __restrict__ xs,
                                            const int ldx,
                                            const float* __restrict__ xtx,
                                            const int K, const int col0,
                                            const int row_lo)
{
    constexpr int RP = 32 * TM;
    float v[2 * TM];
#pragma unroll
    for (int u = 0; u < 2 * TM; ++u) {
        const int e = row_lo * FDT_PANEL + threadIdx.x + FDT_THREADS * u;
        const int row = e >> 4, col = col0 + (e & 15);
        v[u] = (row < K && col < K && row < RP) ? xtx[row * K + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2 * TM; ++u) {
        const int e = row_lo * FDT_PANEL + threadIdx.x + FDT_THREADS * u;
        if (e < RP * FDT_PANEL) xs[(e & 15) * ldx + (e >> 4)] = v[u];
    }
}

// The pass for the FDT_TILE_SPOTS spots of the calling block; every
// thread of the block calls it (it synchronises the block), with TM =
// fdt_panel_tm(K). Each thread stands for spot fdt_panel_spot() of the
// block: beta_in / beta_out point at that spot's column of a (K, ld_in) /
// (K, ld_out) array, xty / inv_den at its column of (K, ld) arrays, and
// ns(k) gives its neighbour sum of coordinate k. A thread whose `valid` is
// false has no spot: it reads and writes nothing. xtx is XtX (K, K) in
// device memory; smem holds fdt_panel_smem_floats(K) floats, 16-byte
// aligned. The warps of spot-layout row 0 fold their spots'
// |beta_new - beta_old| and |beta_old| into dmax and amax.
template <int TM, class NeighbourSum>
__device__ __forceinline__ void gs_pass_panel(
    const float* __restrict__ beta_in, const long long ld_in,
    float* __restrict__ beta_out, const long long ld_out,
    const float* __restrict__ xty,
    const float* __restrict__ inv_den, const long long ld,
    const float* __restrict__ xtx, const int K, const float lam,
    const float rho, const NeighbourSum& ns, const bool valid,
    float* __restrict__ smem, float& dmax, float& amax)
{
    constexpr int S = FDT_TILE_SPOTS, TN = FDT_TILE_TN;
    constexpr int ROWS = FDT_SPOT_ROWS;  // spot-layout rows a pass covers
    constexpr int NI = FDT_PANEL / ROWS;  // inv_den values a thread stages
    constexpr int RP = 32 * TM;
    constexpr int LDX = RP + 4;
    constexpr int RR = RP / FDT_SPOT_WARPS;  // R tile rows a round
    const int sp = fdt_panel_spot(), wr = fdt_panel_spot_row();
    const bool rec = wr == 0;  // the warps that run the recurrence
    const int kp = fdt_panel_kp(K);
    const int row0 = (threadIdx.x >> 3) * TM;  // the register tile's rows
    const int s0 = TN * (threadIdx.x & 7);     // and spots
    float* bs = smem;                  // beta_old, (kp, S)
    float* xs = bs + kp * S;           // two strips, (16, LDX) each
    float* ds = xs + 2 * FDT_PANEL * LDX;  // delta of the panel, (16, S)
    float* rs = ds + FDT_PANEL * S;    // r of the panel's rows, (16, S)
    float* is = rs + FDT_PANEL * S;    // inv_den of the panel's rows
    float* rt = xs;                    // the R tile, (RR, S), between steps
    static_assert(RR * S <= 2 * FDT_PANEL * LDX, "R tile over the strips");

    // Padding rows stay zero: the prologue's products run to kp. Unrolled,
    // as the numerators' loop below, so that each warp keeps several rows'
    // loads from device memory in flight.
#pragma unroll 8
    for (int k = wr; k < kp; k += ROWS)
        bs[k * S + sp] = (valid && k < K) ? beta_in[k * ld_in] : 0.f;

    // The prologue, P = XtX . B_old over all rows, i ascending.
    float acc[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
    for (int i0 = 0, j = 0; i0 < kp; i0 += FDT_PANEL, ++j) {
        float* x = xs + (j & 1) * FDT_PANEL * LDX;
        stage_strip<TM>(x, LDX, xtx, K, i0, 0);
        __syncthreads();  // the strip (and at j = 0 bs) stored
        if (row0 < K)
            strip_product<TM, false>(acc, x, LDX, bs + i0 * S, row0, s0, 0);
    }
    float inv[NI];
#pragma unroll
    for (int u = 0; u < NI; ++u) {
        const int k = wr + ROWS * u;
        inv[u] = (valid && k < K) ? inv_den[k * ld] : 0.f;
    }

    // The numerators, in the spot layout, through the R tile over the
    // strips, RR rows a round.
#pragma unroll
    for (int r0 = 0; r0 < RP; r0 += RR) {
        const bool mine = row0 >= r0 && row0 < r0 + RR;
        __syncthreads();  // the strips (or the last round's tile) read
        if (mine) tile_rows<TM, false>(acc, rt, row0 - r0, s0);
        __syncthreads();
        // NB rows at a time, their neighbour sums through ns.rows, which
        // issues the NB rows' loads of each band together.
        constexpr int NB = 4;
        const int lim = K < r0 + RR ? K : r0 + RR;
        for (int k = r0 + wr; k < lim; k += NB * ROWS) {
            float nsk[NB];
            ns.template rows<NB>(k, ROWS, lim, nsk);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                const int kj = k + j * ROWS;
                if (kj < lim)
                    rt[(kj - r0) * S + sp] = panel_numerator(
                        kj, K, valid, rt[(kj - r0) * S + sp], xty, ld,
                        xtx[kj * K + kj], bs[kj * S + sp], lam, rho, nsk[j]);
            }
        }
        __syncthreads();
        if (mine) tile_rows<TM, true>(acc, rt, row0 - r0, s0);
    }
    __syncthreads();  // the R tile read: strips over it again

    for (int a = 0, j = 0; a < K; a += FDT_PANEL, ++j) {
        float* x = xs + (j & 1) * FDT_PANEL * LDX;
        stage_strip<TM>(x, LDX, xtx, K, a, a);
#pragma unroll
        for (int u = 0; u < NI; ++u) is[(wr + ROWS * u) * S + sp] = inv[u];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int q = row0 + m - a;
            if (q >= 0 && q < FDT_PANEL)
#pragma unroll
                for (int jj = 0; jj < TN / 4; ++jj)
                    *reinterpret_cast<float4*>(rs + q * S + s0 + 4 * jj) =
                        make_float4(acc[m][4 * jj], acc[m][4 * jj + 1],
                                    acc[m][4 * jj + 2], acc[m][4 * jj + 3]);
        }
        __syncthreads();  // the strip, the panel's r and inv_den stored
        const int b = a + FDT_PANEL;  // the first row below the panel
        // The next panel's inv_den: loaded before the recurrence by the
        // other warps, after it by the recurrence's, whose registers hold
        // the panel's r meanwhile.
        const auto next_inv = [&] {
#pragma unroll
            for (int u = 0; u < NI; ++u) {
                const int k = b + wr + ROWS * u;
                inv[u] = (valid && k < K) ? inv_den[k * ld] : 0.f;
            }
        };
        if (!rec) next_inv();

        if (rec) {
            float r[FDT_PANEL];
#pragma unroll
            for (int q = 0; q < FDT_PANEL; ++q) r[q] = rs[q * S + sp];
#pragma unroll
            for (int q = 0; q < FDT_PANEL; ++q) {
                const int k = a + q;
                if (k < K) {
                    const float bk = bs[k * S + sp];
                    const float num = nan_max(r[q], 0.f);
                    const float delta = __fmaf_rn(num, is[q * S + sp], -bk);
                    // XtX[a + t, k] is column q of the strip at row a + t.
#pragma unroll
                    for (int t = q + 1; t < FDT_PANEL; ++t)
                        r[t] = __fmaf_rn(-x[q * LDX + a + t], delta, r[t]);
                    ds[q * S + sp] = delta;
                    if (valid) {
                        const float nb = __fadd_rn(delta, bk);
                        beta_out[k * ld_out] = nb;
                        dmax = nan_max(dmax, fabsf(__fsub_rn(nb, bk)));
                        amax = nan_max(amax, fabsf(bk));
                    }
                }
            }
            next_inv();
        }
        __syncthreads();  // the panel's deltas written

        // The panel's corrections to every row below it, c ascending.
        if (b < K && row0 + TM > b && row0 < K)
            strip_product<TM, true>(acc, x, LDX, ds, row0, s0, b);
    }
}

// The spot-panel pass: the same pass at FDT_REGISTER_MAX_K < K <=
// FDT_SPOT_PANEL_MAX_K with one thread a spot, for kernel #1
// (fused_banded_sweep.cu); kernel #2 keeps the tile pass above.
//
// What bounds it: bytes. At 1M spots and K = 34 a sweep moves about
// 0.436 GB (0.130 ms at 3.35 TB/s) against about 0.05 ms of operations
// (derived counts, not measurements); the tile pass above, built for the
// operations of K = 96-256, spends that range on padding rows, two warps of
// eight running the recurrence and about 18 block barriers a pass, with
// few loads in flight. Here every thread runs its own spot's whole pass,
// as the register pass does, with no block barrier after staging, and
// keeps its register arrays at one panel (16 rows) whatever K is, where
// the register pass's grow with K (its KMAX = 48 / 64 took 5-6 times the
// tile pass's time, PERF.md):
//   - staging, once a block: XtX transposed into shared memory, zero-padded
//     to K x ldx (ldx = K rounded up to 4), so a row of XtX's column i is
//     read as float4 broadcasts; the thread's beta_old column into shared
//     memory by asynchronous copies, in flight during the first band sums;
//   - per panel [a, a + W) (W = 16; a last one of 12 rows or fewer K - a
//     rounded up to 4),
//     left-looking, with the panel's rows in registers: Xty's loads, then
//     the band sums (BandSum::rows<W>, each band's W loads in flight
//     together), inv_den's loads; the prologue p_k = sum_i XtX[k,i] *
//     beta_old_i from +0 over i ascending (beta_old_i read once for the W
//     chains); C_k as panel_numerator forms it; the corrections of every
//     earlier coordinate, c = 0 .. a-1 ascending, from the deltas the
//     thread keeps in shared memory; then the recurrence within the panel
//     as gs_pass_spot runs it, writing beta_new and the panel's deltas.
// So every r_k takes the operations of the association above in the same
// order, and the pass is the tile pass and the register pass bit for bit.
// Its shared memory is ldx * K + (K + n_delta) * FDT_THREADS floats, n_delta
// = the first row of the last panel (the last panel's deltas are never
// read): 72,608 B at K = 34 and 91,264 B at K = 48 with the band offsets.
// Registers, not shared memory, set the blocks an SM: at the 128 of two
// blocks (ptxas, CUDA 12.8, sm_90a: 125 and, with REST, 128, no spill) it
// ran K = 34 in 0.467 ms a 1M-spot sweep and K = 48 in 0.658 ms, where the
// 80 of three spilled and took 0.492 / 0.832 ms (the tile pass: 1.113 /
// 1.339 ms); 2 blocks fit an SM to K = 54, 1 above, and the pass still ran
// K = 56 and 64 in 1.159 / 1.372 ms against the tile pass's 1.691 / 1.849
// (PERF.md). Measured slower, and left out: the loads of two to four bands
// in flight together, and the band sums of all K rows formed first into a
// shared tile (0.530 ms at K = 34, faster only from K = 56).

// Largest K of the spot-panel pass; above it kernel #1 runs the tile pass.
#define FDT_SPOT_PANEL_MAX_K 64

// Blocks an SM the spot-panel kernel asks ptxas to fit by registers.
#define FDT_SPOT_PANEL_MIN_BLOCKS 2

// Row length of the spot-panel pass's transposed XtX: K rounded up to 4.
__host__ __device__ __forceinline__ int fdt_spot_panel_ldx(int K)
{
    return (K + 3) / 4 * 4;
}

// Rows whose deltas the spot-panel pass keeps: those before its last panel.
__host__ __device__ __forceinline__ int fdt_spot_panel_delta_rows(int K)
{
    return (K - 1) / FDT_PANEL * FDT_PANEL;
}

// Floats of dynamic shared memory the spot-panel pass takes at K: the
// transposed XtX (K x ldx), beta_old and the kept deltas, (K, FDT_THREADS)
// and (n_delta, FDT_THREADS).
__host__ __device__ __forceinline__ int fdt_spot_panel_smem_floats(int K)
{
    return K * fdt_spot_panel_ldx(K)
           + (K + fdt_spot_panel_delta_rows(K)) * FDT_THREADS;
}

// XtX (K, K) transposed into shared memory for the spot-panel pass:
// xs[i * ldx + k] = XtX[k, i], zero at k >= K. Every thread of the block
// takes part.
__device__ __forceinline__ void load_xtx_t(const float* __restrict__ xtx,
                                           float* __restrict__ xs,
                                           const int K, const int ldx)
{
    for (int e = threadIdx.x; e < K * ldx; e += blockDim.x) {
        const int i = e / ldx, k = e % ldx;
        xs[e] = k < K ? xtx[k * K + i] : 0.f;
    }
}

// One panel [a, a + W) of the spot-panel pass (see the note above); bs and
// ds point at the thread's column of the (K, FDT_THREADS) beta_old and
// (n_delta, FDT_THREADS) delta tiles, beta_out at row a of its output
// column. Rows of the panel past K (the last panel's padding) are neither
// read nor written.
template <int W, class NeighbourSum>
__device__ __forceinline__ void spot_panel(
    const int a, const float* __restrict__ bs, float* __restrict__ ds,
    const int n_delta, const float* __restrict__ xs, const int ldx,
    float* __restrict__ beta_out, const long long ld_out,
    const float* __restrict__ xty, const float* __restrict__ inv_den,
    const long long ld, const int K, const float lam, const float rho,
    const NeighbourSum& ns, float& dmax, float& amax)
{
    static_assert(W % 4 == 0 && W <= FDT_PANEL, "rows read as float4");
    constexpr int Q = W / 4, T = FDT_THREADS;
    float r[W], y[W], inv[W];
    {
        const float* p = xty + a * ld;
#pragma unroll
        for (int q = 0; q < W; ++q, p = fdt_next(p, ld))
            y[q] = a + q < K ? *p : 0.f;
    }
    ns.template rows<W>(a, 1, K, r);
#pragma unroll
    for (int q = 0; q < W; ++q)
        if (a + q < K) r[q] = __fmaf_rn(lam, r[q], y[q]);
    {
        const float* p = inv_den + a * ld;
#pragma unroll
        for (int q = 0; q < W; ++q, p = fdt_next(p, ld))
            inv[q] = a + q < K ? *p : 0.f;
    }
    copy_async_wait();  // beta_old staged

    // The prologue, i ascending; then C_k.
    float p[W];
#pragma unroll
    for (int q = 0; q < W; ++q) p[q] = 0.f;
    for (int i = 0; i < K; ++i) {
        const float bi = bs[i * T];
        const float4* x = reinterpret_cast<const float4*>(xs + i * ldx + a);
#pragma unroll
        for (int g = 0; g < Q; ++g) {
            const float4 v = x[g];
            p[4 * g] = __fmaf_rn(v.x, bi, p[4 * g]);
            p[4 * g + 1] = __fmaf_rn(v.y, bi, p[4 * g + 1]);
            p[4 * g + 2] = __fmaf_rn(v.z, bi, p[4 * g + 2]);
            p[4 * g + 3] = __fmaf_rn(v.w, bi, p[4 * g + 3]);
        }
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
        const int k = a + q;
        if (k < K) {
            const float c = __fsub_rn(r[q], p[q]);
            r[q] = __fsub_rn(__fmaf_rn(xs[k * ldx + k], bs[k * T], c), rho);
        }
    }

    // The corrections of the coordinates before the panel, c ascending.
    for (int c = 0; c < a; ++c) {
        const float d = ds[c * T];
        const float4* x = reinterpret_cast<const float4*>(xs + c * ldx + a);
#pragma unroll
        for (int g = 0; g < Q; ++g) {
            const float4 v = x[g];
            r[4 * g] = __fmaf_rn(-v.x, d, r[4 * g]);
            r[4 * g + 1] = __fmaf_rn(-v.y, d, r[4 * g + 1]);
            r[4 * g + 2] = __fmaf_rn(-v.z, d, r[4 * g + 2]);
            r[4 * g + 3] = __fmaf_rn(-v.w, d, r[4 * g + 3]);
        }
    }

    // Gauss-Seidel within the panel, as gs_pass_spot runs it.
#pragma unroll
    for (int q = 0; q < W; ++q, beta_out = fdt_next(beta_out, ld_out)) {
        const int k = a + q;
        if (k >= K) break;
        const float bk = bs[k * T];
        const float num = nan_max(r[q], 0.f);
        const float delta = __fmaf_rn(num, inv[q], -bk);
        const float4* x = reinterpret_cast<const float4*>(xs + k * ldx + a);
#pragma unroll
        for (int g = (q + 1) / 4; g < Q; ++g) {
            const float4 v = x[g];
            if (4 * g > q) r[4 * g] = __fmaf_rn(-v.x, delta, r[4 * g]);
            if (4 * g + 1 > q)
                r[4 * g + 1] = __fmaf_rn(-v.y, delta, r[4 * g + 1]);
            if (4 * g + 2 > q)
                r[4 * g + 2] = __fmaf_rn(-v.z, delta, r[4 * g + 2]);
            r[4 * g + 3] = __fmaf_rn(-v.w, delta, r[4 * g + 3]);
        }
        if (k < n_delta) ds[k * T] = delta;
        const float nb = __fadd_rn(delta, bk);
        *beta_out = nb;
        dmax = nan_max(dmax, fabsf(__fsub_rn(nb, bk)));
        amax = nan_max(amax, fabsf(bk));
    }
}

// The spot-panel pass for the spot of the calling thread, at
// FDT_REGISTER_MAX_K < K <= FDT_SPOT_PANEL_MAX_K: bs is its column of the
// beta_old tile, whose asynchronous copies (stage_column) the pass waits
// for, ds its column of the delta tile, xs load_xtx_t's XtX; beta_out, xty,
// inv_den and ns as for gs_pass_spot. Folds the spot's |beta_new -
// beta_old| and |beta_old| into dmax and amax.
template <class NeighbourSum>
__device__ __forceinline__ void gs_pass_spot_panel(
    const float* __restrict__ bs, float* __restrict__ ds,
    const float* __restrict__ xs, float* __restrict__ beta_out,
    const long long ld_out, const float* __restrict__ xty,
    const float* __restrict__ inv_den, const long long ld, const int K,
    const float lam, const float rho, const NeighbourSum& ns, float& dmax,
    float& amax)
{
    const int ldx = fdt_spot_panel_ldx(K);
    const int n_delta = fdt_spot_panel_delta_rows(K);
    // Panels of 16 while more than 12 rows are left (a last panel of 13-15
    // rows runs as one of 16, the rows past K idle: one call site of the
    // widest panel, which a second one made spill); then 0-12 rows.
    int a = 0;
    for (; K - a > 12; a += FDT_PANEL)
        spot_panel<FDT_PANEL>(a, bs, ds, n_delta, xs, ldx,
                              beta_out + a * ld_out, ld_out, xty, inv_den, ld,
                              K, lam, rho, ns, dmax, amax);
    const auto tail = [&](auto w) {
        spot_panel<decltype(w)::value>(a, bs, ds, n_delta, xs, ldx,
                                       beta_out + a * ld_out, ld_out, xty,
                                       inv_den, ld, K, lam, rho, ns, dmax,
                                       amax);
    };
    switch ((K - a + 3) / 4) {  // the last K - a rows, 0 to 12
    case 0: break;                // none left
    case 1: tail(std::integral_constant<int, 4>{}); break;
    case 2: tail(std::integral_constant<int, 8>{}); break;
    default: tail(std::integral_constant<int, 12>{}); break;
    }
}
