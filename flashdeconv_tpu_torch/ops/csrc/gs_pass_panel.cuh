// The Gauss-Seidel coordinate pass at 64 < K <= 256, in panels of 16
// coordinates, shared by both sweep kernels (fused_banded_sweep.cu and
// cd_block_sweep.cu) so that the fused and unfused banded sweeps stay
// bitwise equal on the card at every K.
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
// than the 255 registers a thread may have.
//
// What bounds it on an H100: at 1M spots about 3K^2 f32 operations per
// spot (the prologue's K^2 multiply-adds and the recurrence's K^2/2) against
// about 16K bytes per spot (beta in and out, Xty, inv_den): operations at
// K = 128 (0.75 ms at 67 TFLOP/s against 0.61 ms of bytes at 3.35 TB/s) and
// K = 256 (3.0 ms against 1.3 ms), about level at K = 96 (derived counts,
// not measurements).
//
// The design:
//   - one CUDA block of 256 threads owns FDT_TILE_SPOTS = 32 spots, one per
//     lane, so a warp's load of row k of any (K, n) operand reads 32
//     neighbouring floats;
//   - the spots' beta_old and their deltas live in shared memory as
//     (K, 32) tiles (32 KB each at K = 256), never in registers or local
//     memory;
//   - XtX does not fit in shared memory whole at K = 256 (256 KB, above the
//     227 KB a block may have), so it is staged one panel of 16 rows at a
//     time (16 x K floats, 16 KB at K = 256); the whole matrix stays hot in
//     the 50 MB L2. Its shared memory is 86,016 B at K = 256 and 45,056 B
//     at K = 128, so the launchers set
//     cudaFuncAttributeMaxDynamicSharedMemorySize before every launch;
//   - per panel [a, a+16): the 8 warps compute C and the cross-panel part
//     of r (rows a..a+15, two rows a warp, float4 broadcasts of XtX rows
//     against the lanes' tile columns: tile products of f32 FMAs on the
//     CUDA cores, no tensor cores); then warp 0 runs the panel's 16-step
//     recurrence with the 16 values of r of its lane's spot in registers;
//   - every sum has one fixed order and every operation is an explicit
//     __fmaf_rn / __fadd_rn / __fsub_rn, with no atomics, so two launches
//     are bitwise equal and both kernels give the same bits on the same
//     operands.

#pragma once

#include "gs_pass.cuh"

#define FDT_PANEL 16        // coordinates of one panel
#define FDT_TILE_SPOTS 32   // spots of one CUDA block: one per lane
#define FDT_REGISTER_MAX_K 64   // largest K of gs_pass_spot
#define FDT_PANEL_MAX_K 256

static_assert(2 * (FDT_THREADS / 32) == FDT_PANEL,
              "each warp computes two rows of a panel");

// K rounded up to a whole panel.
__host__ __device__ __forceinline__ int fdt_panel_kp(int K)
{
    return (K + FDT_PANEL - 1) / FDT_PANEL * FDT_PANEL;
}

// Floats of dynamic shared memory gs_pass_panel takes at K: the XtX panel
// (16 x kp), the beta_old and delta tiles (kp x 32 each), the panel's
// numerators and reciprocal denominators (16 x 32 each).
__host__ __device__ __forceinline__ int fdt_panel_smem_floats(int K)
{
    const int kp = fdt_panel_kp(K);
    return FDT_PANEL * kp + 2 * kp * FDT_TILE_SPOTS
           + 2 * FDT_PANEL * FDT_TILE_SPOTS;
}

// C_k of the lane's spot, given p = sum_i XtX[k,i]*beta_old_i; 0 for a
// padding row or a lane without a spot.
template <class NeighbourSum>
__device__ __forceinline__ float panel_numerator(
    const int k, const int K, const bool valid, const float p,
    const float* __restrict__ xty, const long long ld, const float xkk,
    const float bk, const float lam, const float rho, const NeighbourSum& ns)
{
    if (!valid || k >= K) return 0.f;
    float c = __fmaf_rn(lam, ns(k), xty[k * ld]);
    c = __fsub_rn(c, p);
    c = __fmaf_rn(xkk, bk, c);
    return __fsub_rn(c, rho);
}

// The pass for the 32 spots of the calling block; every thread of the
// block calls it (it synchronises the block). Lane l of every warp stands
// for one spot: beta_in / beta_out point at that spot's column of a (K,
// ld_beta) array, xty / inv_den at its column of (K, ld) arrays, and ns(k)
// gives its neighbour sum of coordinate k. A lane whose `valid` is false
// has no spot: it reads and writes nothing. xtx is XtX (K, K) in device
// memory; smem holds fdt_panel_smem_floats(K) floats, 16-byte aligned.
// Warp 0 folds its spots' |beta_new - beta_old| and |beta_old| into dmax
// and amax.
template <class NeighbourSum>
__device__ __forceinline__ void gs_pass_panel(
    const float* __restrict__ beta_in, float* __restrict__ beta_out,
    const long long ld_beta, const float* __restrict__ xty,
    const float* __restrict__ inv_den, const long long ld,
    const float* __restrict__ xtx, const int K, const float lam,
    const float rho, const NeighbourSum& ns, const bool valid,
    float* __restrict__ smem, float& dmax, float& amax)
{
    constexpr int S = FDT_TILE_SPOTS;
    constexpr int WARPS = FDT_THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kp = fdt_panel_kp(K);
    const int k4 = (K + 3) & ~3;
    float* xs = smem;                   // XtX rows a..a+15, (16, kp)
    float* bs = xs + FDT_PANEL * kp;    // beta_old, (kp, S)
    float* ds = bs + kp * S;            // delta, (kp, S)
    float* rs = ds + kp * S;            // r of the panel's rows, (16, S)
    float* is = rs + FDT_PANEL * S;     // inv_den of the panel's rows

    // Padding rows stay zero: the prologue's products run to k4.
    for (int k = warp; k < kp; k += WARPS)
        bs[k * S + lane] = (valid && k < K) ? beta_in[k * ld_beta] : 0.f;

    const int q0 = 2 * warp, q1 = q0 + 1;  // this warp's rows of a panel
    for (int a = 0; a < K; a += FDT_PANEL) {
        __syncthreads();  // bs loaded, the last panel's ds rows written
        for (int e = threadIdx.x; e < FDT_PANEL * kp; e += FDT_THREADS) {
            const int q = e / kp, c = e - q * kp;
            xs[e] = (a + q < K && c < K) ? xtx[(a + q) * K + c] : 0.f;
        }
        __syncthreads();

        const float4* x0 = reinterpret_cast<const float4*>(xs + q0 * kp);
        const float4* x1 = reinterpret_cast<const float4*>(xs + q1 * kp);
        // Prologue rows: p = XtX[k, :] . beta_old, i ascending.
        float p0 = 0.f, p1 = 0.f;
        for (int i = 0; i < k4; i += 4) {
            const float4 u = x0[i >> 2], v = x1[i >> 2];
            const float b0 = bs[i * S + lane], b1 = bs[(i + 1) * S + lane];
            const float b2 = bs[(i + 2) * S + lane];
            const float b3 = bs[(i + 3) * S + lane];
            p0 = __fmaf_rn(u.x, b0, p0);
            p0 = __fmaf_rn(u.y, b1, p0);
            p0 = __fmaf_rn(u.z, b2, p0);
            p0 = __fmaf_rn(u.w, b3, p0);
            p1 = __fmaf_rn(v.x, b0, p1);
            p1 = __fmaf_rn(v.y, b1, p1);
            p1 = __fmaf_rn(v.z, b2, p1);
            p1 = __fmaf_rn(v.w, b3, p1);
        }
        const int k0 = a + q0, k1 = a + q1;
        float r0 = panel_numerator(k0, K, valid, p0, xty, ld,
                                   xs[q0 * kp + k0], bs[k0 * S + lane], lam,
                                   rho, ns);
        float r1 = panel_numerator(k1, K, valid, p1, xty, ld,
                                   xs[q1 * kp + k1], bs[k1 * S + lane], lam,
                                   rho, ns);
        // The finished panels' corrections, coordinate c ascending.
        for (int c = 0; c < a; c += 4) {
            const float4 u = x0[c >> 2], v = x1[c >> 2];
            const float d0 = ds[c * S + lane], d1 = ds[(c + 1) * S + lane];
            const float d2 = ds[(c + 2) * S + lane];
            const float d3 = ds[(c + 3) * S + lane];
            r0 = __fmaf_rn(-u.x, d0, r0);
            r0 = __fmaf_rn(-u.y, d1, r0);
            r0 = __fmaf_rn(-u.z, d2, r0);
            r0 = __fmaf_rn(-u.w, d3, r0);
            r1 = __fmaf_rn(-v.x, d0, r1);
            r1 = __fmaf_rn(-v.y, d1, r1);
            r1 = __fmaf_rn(-v.z, d2, r1);
            r1 = __fmaf_rn(-v.w, d3, r1);
        }
        rs[q0 * S + lane] = r0;
        rs[q1 * S + lane] = r1;
        is[q0 * S + lane] = (valid && k0 < K) ? inv_den[k0 * ld] : 0.f;
        is[q1 * S + lane] = (valid && k1 < K) ? inv_den[k1 * ld] : 0.f;
        __syncthreads();

        if (warp == 0) {
            float r[FDT_PANEL];
#pragma unroll
            for (int q = 0; q < FDT_PANEL; ++q) r[q] = rs[q * S + lane];
#pragma unroll
            for (int q = 0; q < FDT_PANEL; ++q) {
                const int k = a + q;
                if (k < K) {
                    const float b = bs[k * S + lane];
                    const float num = nan_max(r[q], 0.f);
                    const float delta = __fmaf_rn(num, is[q * S + lane], -b);
#pragma unroll
                    for (int t = q + 1; t < FDT_PANEL; ++t)
                        r[t] = __fmaf_rn(-xs[t * kp + k], delta, r[t]);
                    ds[k * S + lane] = delta;
                    if (valid) {
                        const float nb = __fadd_rn(delta, b);
                        beta_out[k * ld_beta] = nb;
                        dmax = nan_max(dmax, fabsf(__fsub_rn(nb, b)));
                        amax = nan_max(amax, fabsf(b));
                    }
                }
            }
        }
    }
}
