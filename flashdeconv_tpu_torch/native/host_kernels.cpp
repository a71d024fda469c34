// Native host kernels for the O(nnz) CSR passes that feed the TPU solver.
//
// The TPU owns the iterative solve; these kernels own the single-pass host
// stages whose numpy implementations are memory-bound and GIL-threaded:
//
//   * log1p_cpm_moments_*  — per-gene sum / sum-of-squares of
//     log1p(count * per-row scale) over a CSR matrix (the Seurat-v3 HVG
//     moments, reference flashdeconv/utils/genes.py:52-83). One fused pass:
//     scale -> log1p -> two column accumulations, instead of numpy's four
//     materialized temporaries + two bincounts per block.
//
//   * countsketch_project_* — CountSketch projection out[r, bucket[g]] +=
//     weight[g] * Y[r, g] (reference flashdeconv/core/sketching.py:160-206).
//     Each CSR row writes one 8 KB output row: a pure scatter that a
//     sparse-sparse matmul (scipy) pays hash/sort overhead for.
//
//   * csr_row_sums_* — per-row sums in the data dtype (scipy's
//     ``.sum(axis=1)`` semantics: sequential nnz-order accumulation per
//     row). Rows are independent outputs, so threading is bitwise-free.
//
//   * log1p_cpm_transform_* — out[i] = log1p(data[i] * scale[row]) in the
//     data dtype (the log_cpm preprocess on CSR ``.data``,
//     reference flashdeconv/core/deconv.py:177-197). Pure element-wise map
//     (threading is bitwise-free); matches the numpy expression to <= 1
//     ULP and never materializes its 8-byte-per-nnz ``np.repeat``
//     temporary.
//
//   * sq_sum_f64 — float64 sum of squares of a dense buffer (the YtY
//     objective constant), chunk-ordered reduction.
//
// Determinism contract: every kernel is a pure function of its operands —
// accumulation happens in fixed nnz/element order within a block whose size
// is a pure function of the row count (block_rows below), and block
// partials are reduced in block order on the calling thread, regardless of
// thread count or scheduling. Kernels with no cross-row accumulation
// (projection rows, row sums, the transform) are additionally independent
// of the block size; the projection and row sums are bit-identical to
// their scipy counterparts, the log1p-bearing kernels match numpy to
// <= 1 ULP per value (bitwise where libm log1p == numpy's — the
// Python-side self-test reports which), and the moments kernels' f64
// column sums follow the documented block order.
//
// Parallelism: std::thread over contiguous block ranges; each thread writes
// only its own blocks' partials (moments) or its own rows (projection), so
// there is no sharing and no atomics.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see native/__init__.py;
// loaded via ctypes — no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ---- vectorized float32 log1p (moments fast path) --------------------------
//
// The HVG moments pass spends most of its cycles in libm's scalar log1pf
// (~40-50 cycles each over O(nnz) entries). This 8-lane AVX2 path computes
// log1p in DOUBLE precision (4-lane pairs) and rounds once to float32 —
// i.e. the correctly-rounded float32 log1p to within 1 ULP, at least as
// accurate as libm's log1pf (the two may differ in the last bit). It is
// used ONLY for the f32-intermediate moments kernel, whose downstream
// consumer is a rank-based gene selection already tolerant of last-ULP
// wiggle (tests pin rtol 2e-6); the value-bearing kernels (transform,
// fused projection) keep scalar libm so fused and staged native paths
// stay mutually bit-identical. Deterministic per input either way:
// runtime dispatch is by CPU capability, not data.
//
// Algorithm (inputs restricted to x >= 0, finite — enforced by the caller):
//   u = 1 + x (double);  correction c = (x - (u - 1)) / u
//   u = m * 2^e with m in [sqrt(2)/2, sqrt(2)], e >= 0
//   log(m) = 2*atanh(s), s = (m-1)/(m+1), truncated odd series through s^11
//   log1p(x) = e*ln2 + log(m) + c
// Max relative error ~1e-15 — far below float32 resolution (6e-8).

#if defined(__x86_64__)

__attribute__((target("avx2,fma"))) inline __m256d log1p4d_pos(__m256d x) {
  const __m256d one = _mm256_set1_pd(1.0);
  const __m256d u = _mm256_add_pd(one, x);
  // c = (x - (u - 1)) / u   (exact low-order bits lost in 1 + x)
  const __m256d c = _mm256_div_pd(
      _mm256_sub_pd(x, _mm256_sub_pd(u, one)), u);

  // m, e decomposition via the IEEE-754 bit layout (u >= 1 -> e >= 0).
  const __m256i bits = _mm256_castpd_si256(u);
  __m256i e_i = _mm256_sub_epi64(_mm256_srli_epi64(bits, 52),
                                 _mm256_set1_epi64x(1023));
  const __m256i mant_mask = _mm256_set1_epi64x(0x000FFFFFFFFFFFFFLL);
  const __m256i one_exp = _mm256_set1_epi64x(0x3FF0000000000000LL);
  __m256d m = _mm256_castsi256_pd(_mm256_or_si256(
      _mm256_and_si256(bits, mant_mask), one_exp));
  // fold m into [sqrt(2)/2, sqrt(2)]
  const __m256d sqrt2 = _mm256_set1_pd(1.4142135623730951);
  const __m256d gt = _mm256_cmp_pd(m, sqrt2, _CMP_GT_OQ);
  m = _mm256_blendv_pd(m, _mm256_mul_pd(m, _mm256_set1_pd(0.5)), gt);
  e_i = _mm256_sub_epi64(
      e_i, _mm256_castpd_si256(gt));  // gt lanes are all-ones == -1

  // int64 -> double for 0 <= e < 2^51 (magic-number trick)
  const __m256i magic_i = _mm256_set1_epi64x(0x4330000000000000LL);
  const __m256d magic_d = _mm256_set1_pd(4503599627370496.0);  // 2^52
  const __m256d e_d = _mm256_sub_pd(
      _mm256_castsi256_pd(_mm256_add_epi64(e_i, magic_i)), magic_d);

  const __m256d f = _mm256_sub_pd(m, one);
  const __m256d s = _mm256_div_pd(f, _mm256_add_pd(_mm256_set1_pd(2.0), f));
  const __m256d s2 = _mm256_mul_pd(s, s);
  // t = 1/3 + s2*(1/5 + s2*(1/7 + s2*(1/9 + s2/11)))
  __m256d t = _mm256_set1_pd(1.0 / 11.0);
  t = _mm256_fmadd_pd(t, s2, _mm256_set1_pd(1.0 / 9.0));
  t = _mm256_fmadd_pd(t, s2, _mm256_set1_pd(1.0 / 7.0));
  t = _mm256_fmadd_pd(t, s2, _mm256_set1_pd(1.0 / 5.0));
  t = _mm256_fmadd_pd(t, s2, _mm256_set1_pd(1.0 / 3.0));
  // log(m) = 2s + 2s*s2*t
  const __m256d two_s = _mm256_add_pd(s, s);
  const __m256d log_m = _mm256_fmadd_pd(
      _mm256_mul_pd(two_s, s2), t, two_s);

  const __m256d ln2 = _mm256_set1_pd(0.6931471805599453);
  return _mm256_add_pd(_mm256_fmadd_pd(e_d, ln2, log_m), c);
}

// v[j] = (float)log1p((double)p[j]) for 8 lanes; caller guarantees the
// lanes passed the validity mask (p >= 0, finite).
__attribute__((target("avx2,fma"))) inline __m256 log1p8f_pos(__m256 p) {
  const __m256d lo = _mm256_cvtps_pd(_mm256_castps256_ps128(p));
  const __m256d hi = _mm256_cvtps_pd(_mm256_extractf128_ps(p, 1));
  const __m128 vlo = _mm256_cvtpd_ps(log1p4d_pos(lo));
  const __m128 vhi = _mm256_cvtpd_ps(log1p4d_pos(hi));
  return _mm256_set_m128(vhi, vlo);
}

inline bool log1p_avx2_available() {
  static const bool ok =
      __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
  return ok;
}

#else  // !__x86_64__

inline bool log1p_avx2_available() { return false; }

#endif  // __x86_64__

// Scalar definition shared by the vector path's tail/degenerate lanes and
// the no-AVX2 fallback: double-precision log1p rounded once to float32
// (same value the vector lanes produce on valid inputs).
inline float log1pf_via_double(float p) {
  return static_cast<float>(std::log1p(static_cast<double>(p)));
}

// Scalar REPLAY of log1p4d_pos: the identical IEEE operation sequence
// (add/sub/mul/div + std::fma mirror the intrinsic lanes one-for-one, and
// the exponent int->double conversion is exact), so it produces the SAME
// double as a vector lane for every x >= 0. This makes the f32 value
// kernels' log1p a PER-ELEMENT pure function: vector groups and scalar
// tails can be mixed freely (different kernels batch the same logical
// values over different spans) without the grouping becoming observable.
// The Python-side gate verifies both properties at load time (numpy match
// and shift-invariance of log1p_buffer_f32); kernels are disabled if
// either fails.
inline double log1p_poly_pos(double x) {
  const double u = 1.0 + x;
  const double c = (x - (u - 1.0)) / u;
  uint64_t bits;
  std::memcpy(&bits, &u, sizeof(bits));
  int64_t e = static_cast<int64_t>(bits >> 52) - 1023;
  const uint64_t mbits =
      (bits & 0x000FFFFFFFFFFFFFULL) | 0x3FF0000000000000ULL;
  double m;
  std::memcpy(&m, &mbits, sizeof(m));
  if (m > 1.4142135623730951) {
    m *= 0.5;
    e += 1;
  }
  const double f = m - 1.0;
  const double s = f / (2.0 + f);
  const double s2 = s * s;
  double t = 1.0 / 11.0;
  t = std::fma(t, s2, 1.0 / 9.0);
  t = std::fma(t, s2, 1.0 / 7.0);
  t = std::fma(t, s2, 1.0 / 5.0);
  t = std::fma(t, s2, 1.0 / 3.0);
  const double two_s = s + s;
  const double log_m = std::fma(two_s * s2, t, two_s);
  return std::fma(static_cast<double>(e), 0.6931471805599453, log_m) + c;
}

// The f32 value kernels' log1p: poly (double, rounded once) for valid
// inputs, libm-via-double for degenerate ones. The valid/degenerate choice
// is PER ELEMENT (a pure function of the value), so batched and scalar
// evaluation agree bitwise everywhere.
inline float log1p_f32_value(float p) {
  if (p >= 0.0f && p <= 3.4028235e38f)
    return static_cast<float>(log1p_poly_pos(static_cast<double>(p)));
  return log1pf_via_double(p);
}

#if defined(__x86_64__)

__attribute__((target("avx2,fma"))) inline void log1p_f32_batch_avx2(
    const float* p, float* out, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    const __m256 v = _mm256_loadu_ps(p + i);
    const __m256 ok = _mm256_and_ps(
        _mm256_cmp_ps(v, _mm256_setzero_ps(), _CMP_GE_OQ),
        _mm256_cmp_ps(v, _mm256_set1_ps(3.4028235e38f), _CMP_LE_OQ));
    const int mask = _mm256_movemask_ps(ok);
    if (mask == 0xFF) {
      _mm256_storeu_ps(out + i, log1p8f_pos(v));
    } else {
      // Degenerate lanes (negative / overflow / nan): fix up from the
      // ALREADY-LOADED register, never from p — the batch is documented
      // in-place safe (every production call site aliases out onto p),
      // so p[i+l] may already hold this group's poly result.
      alignas(32) float orig[8];
      _mm256_store_ps(orig, v);
      _mm256_storeu_ps(out + i, log1p8f_pos(v));
      for (int l = 0; l < 8; ++l)
        if (!((mask >> l) & 1)) out[i + l] = log1pf_via_double(orig[l]);
    }
  }
  for (; i < n; ++i) out[i] = log1p_f32_value(p[i]);
}

#endif  // __x86_64__

// out[i] = log1p(p[i]) rounded once to f32 — in-place safe (out may be p).
inline void log1p_f32_batch(const float* p, float* out, int64_t n) {
#if defined(__x86_64__)
  if (log1p_avx2_available()) {
    log1p_f32_batch_avx2(p, out, n);
    return;
  }
#endif
  for (int64_t i = 0; i < n; ++i) out[i] = log1p_f32_value(p[i]);
}

#if defined(__x86_64__)

// One row's worth of f32 moments accumulation with the vector log1p.
// Deterministic: lane grouping is a pure function of the row's nnz span,
// and degenerate (negative / non-finite) groups fall back to the SAME
// double-precision formula per lane.
#define DEFINE_ROW_F32_AVX2(IDX_T)                                           \
  __attribute__((target("avx2,fma"))) inline void accumulate_row_f32_avx2(  \
      const float* data, const IDX_T* idx, int64_t lo, int64_t hi, float s, \
      double* psum, double* psq) {                                          \
    const __m256 sv = _mm256_set1_ps(s);                                    \
    alignas(32) float vbuf[8], vvbuf[8];                                    \
    int64_t i = lo;                                                         \
    for (; i + 8 <= hi; i += 8) {                                           \
      const __m256 p = _mm256_mul_ps(_mm256_loadu_ps(data + i), sv);        \
      const __m256 ok = _mm256_and_ps(                                      \
          _mm256_cmp_ps(p, _mm256_setzero_ps(), _CMP_GE_OQ),                \
          _mm256_cmp_ps(p, _mm256_set1_ps(3.4028235e38f), _CMP_LE_OQ));     \
      if (_mm256_movemask_ps(ok) == 0xFF) {                                 \
        const __m256 v = log1p8f_pos(p);                                    \
        _mm256_store_ps(vbuf, v);                                           \
        _mm256_store_ps(vvbuf, _mm256_mul_ps(v, v));                        \
        for (int l = 0; l < 8; ++l) {                                       \
          psum[idx[i + l]] += static_cast<double>(vbuf[l]);                 \
          psq[idx[i + l]] += static_cast<double>(vvbuf[l]);                 \
        }                                                                   \
      } else {                                                              \
        for (int l = 0; l < 8; ++l) {                                       \
          const float v = log1pf_via_double(data[i + l] * s);               \
          psum[idx[i + l]] += static_cast<double>(v);                       \
          psq[idx[i + l]] += static_cast<double>(v * v);                    \
        }                                                                   \
      }                                                                     \
    }                                                                       \
    for (; i < hi; ++i) {                                                   \
      const float v = log1pf_via_double(data[i] * s);                       \
      psum[idx[i]] += static_cast<double>(v);                               \
      psq[idx[i]] += static_cast<double>(v * v);                            \
    }                                                                       \
  }

DEFINE_ROW_F32_AVX2(int32_t)
DEFINE_ROW_F32_AVX2(int64_t)
#undef DEFINE_ROW_F32_AVX2

#endif  // __x86_64__

// Rows per block: a pure function of the row count (so reductions are
// deterministic per shape), sized to expose ~64 blocks once the input is
// big enough to be worth threading. The old constant 65536 starved small
// inputs — a 38k-spot Stereo-seq section ran single-threaded.
inline int64_t block_rows(int64_t n_rows) {
  const int64_t b = (n_rows + 63) / 64;
  return std::min<int64_t>(65536, std::max<int64_t>(2048, b));
}

inline int64_t n_blocks(int64_t n_rows) {
  const int64_t br = block_rows(n_rows);
  return (n_rows + br - 1) / br;
}

// Launch `fn(block_index)` over all blocks on `n_threads` threads with a
// static contiguous partition (deterministic ownership, zero contention).
template <typename Fn>
void parallel_blocks(int64_t blocks, int n_threads, Fn fn) {
  if (n_threads <= 1 || blocks <= 1) {
    for (int64_t b = 0; b < blocks; ++b) fn(b);
    return;
  }
  int t_used = static_cast<int>(
      std::min<int64_t>(n_threads, blocks));
  std::vector<std::thread> threads;
  threads.reserve(t_used);
  for (int t = 0; t < t_used; ++t) {
    threads.emplace_back([=]() {
      // interleaved assignment balances skewed nnz distributions
      for (int64_t b = t; b < blocks; b += t_used) fn(b);
    });
  }
  for (auto& th : threads) th.join();
}

// CalcT is the intermediate precision: double mirrors numpy's float64 path
// (f64 data x f64 scale); float mirrors its float32 path (f32 CSR data, f32
// scale -> f32 product/log1p/square, accumulated in f64 by bincount).
// scale == nullptr fuses the library-size pass in: per-row
// scale = 1e4 / max(row_sum, 1) with the row sum accumulated in the data
// dtype in nnz order — bit-identical to csr_row_sums -> np.maximum(lib, 1)
// -> 1e4/lib done separately, one full sweep cheaper.
template <typename DataT, typename IdxT, typename CalcT = double>
void log1p_cpm_moments_impl(const int64_t* indptr, const IdxT* indices,
                            const DataT* data, const double* scale,
                            int64_t n_rows, int64_t n_genes, int n_threads,
                            double* out_sum, double* out_sumsq) {
  const int64_t blocks = n_blocks(n_rows);
  // Per-block partials, reduced in block order afterwards (determinism).
  std::vector<double> partial(static_cast<size_t>(blocks) * n_genes * 2, 0.0);

  parallel_blocks(blocks, n_threads, [&](int64_t b) {
    double* psum = partial.data() + static_cast<size_t>(b) * n_genes * 2;
    double* psq = psum + n_genes;
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    for (int64_t r = r0; r < r1; ++r) {
      CalcT s;
      if (scale) {
        s = static_cast<CalcT>(scale[r]);
      } else {
        DataT acc = 0;
        for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) acc += data[i];
        s = static_cast<CalcT>(DataT(1e4) / std::max(acc, DataT(1)));
      }
#if defined(__x86_64__)
      if constexpr (std::is_same_v<DataT, float> &&
                    std::is_same_v<CalcT, float>) {
        if (log1p_avx2_available()) {
          accumulate_row_f32_avx2(data, indices, indptr[r], indptr[r + 1],
                                  s, psum, psq);
          continue;
        }
      }
#endif
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        const CalcT v = std::log1p(static_cast<CalcT>(data[i]) * s);
        const IdxT g = indices[i];
        psum[g] += static_cast<double>(v);
        psq[g] += static_cast<double>(v * v);
      }
    }
  });

  std::memset(out_sum, 0, sizeof(double) * n_genes);
  std::memset(out_sumsq, 0, sizeof(double) * n_genes);
  for (int64_t b = 0; b < blocks; ++b) {
    const double* psum = partial.data() + static_cast<size_t>(b) * n_genes * 2;
    const double* psq = psum + n_genes;
    for (int64_t g = 0; g < n_genes; ++g) {
      out_sum[g] += psum[g];
      out_sumsq[g] += psq[g];
    }
  }
}

template <typename DataT, typename IdxT>
void countsketch_project_impl(const int64_t* indptr, const IdxT* indices,
                              const DataT* data, const int32_t* buckets,
                              const double* weights, int64_t n_rows,
                              int64_t sketch_dim, int n_threads,
                              double* out) {
  // Rows are independent outputs: parallelize over row blocks directly.
  // Each worker zeroes its own block region (not one big memset up front):
  // the output is a fresh allocation, and first-touch page faults serialize
  // brutally on ballooned/overcommitted VMs — faulting from all threads is
  // the difference between ~0.5 s and ~40 s at a 4 GB output.
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    std::memset(out + static_cast<size_t>(r0) * sketch_dim, 0,
                sizeof(double) * static_cast<size_t>(r1 - r0) * sketch_dim);
    for (int64_t r = r0; r < r1; ++r) {
      double* row = out + static_cast<size_t>(r) * sketch_dim;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        const IdxT g = indices[i];
        row[buckets[g]] += weights[g] * static_cast<double>(data[i]);
      }
    }
  });
}

// Column-subset of a CSR matrix via a gene lookup table (new_col[g] < 0
// drops gene g). Bit-identical to scipy's ``Y[:, gene_idx]`` for sorted
// unique gene_idx: kept entries stay in row order with unchanged values —
// the kernel only counts, remaps, and copies (no floating-point math, so
// no accumulation-order or libm concerns). Pass 1 counts kept entries per
// row; the caller exclusive-scans the counts into the output indptr;
// pass 2 writes remapped indices + values at final offsets.
template <typename DataT, typename IdxT>
void csr_subset_count_impl(const int64_t* indptr, const IdxT* indices,
                           const int32_t* new_col, int64_t n_rows,
                           int n_threads, int64_t* row_counts) {
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    for (int64_t r = r0; r < r1; ++r) {
      int64_t cnt = 0;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        cnt += new_col[indices[i]] >= 0;
      }
      row_counts[r] = cnt;
    }
  });
}

template <typename DataT, typename IdxT>
void csr_subset_fill_impl(const int64_t* indptr, const IdxT* indices,
                          const DataT* data, const int32_t* new_col,
                          const int64_t* out_indptr, int64_t n_rows,
                          int n_threads, int32_t* out_indices,
                          DataT* out_data) {
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    for (int64_t r = r0; r < r1; ++r) {
      int64_t o = out_indptr[r];
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        const int32_t c = new_col[indices[i]];
        if (c >= 0) {
          out_indices[o] = c;
          out_data[o] = data[i];
          ++o;
        }
      }
    }
  });
}

// Fixed-structure f64 dot products for the fused-Xty kernel: deterministic
// per machine (AVX2 4x4-lane accumulators where available, a 4-accumulator
// scalar pattern otherwise; dispatch is by CPU capability, not data).
#if defined(__x86_64__)
__attribute__((target("avx2,fma"))) inline double dot_f64_avx2(
    const double* a, const double* b, int64_t n) {
  __m256d s0 = _mm256_setzero_pd(), s1 = _mm256_setzero_pd();
  __m256d s2 = _mm256_setzero_pd(), s3 = _mm256_setzero_pd();
  int64_t i = 0;
  for (; i + 16 <= n; i += 16) {
    s0 = _mm256_fmadd_pd(_mm256_loadu_pd(a + i),
                         _mm256_loadu_pd(b + i), s0);
    s1 = _mm256_fmadd_pd(_mm256_loadu_pd(a + i + 4),
                         _mm256_loadu_pd(b + i + 4), s1);
    s2 = _mm256_fmadd_pd(_mm256_loadu_pd(a + i + 8),
                         _mm256_loadu_pd(b + i + 8), s2);
    s3 = _mm256_fmadd_pd(_mm256_loadu_pd(a + i + 12),
                         _mm256_loadu_pd(b + i + 12), s3);
  }
  alignas(32) double lanes[4];
  _mm256_store_pd(
      lanes,
      _mm256_add_pd(_mm256_add_pd(s0, s1), _mm256_add_pd(s2, s3)));
  double acc = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]));
  for (; i < n; ++i) acc += a[i] * b[i];
  return acc;
}
#endif

inline double dot_f64_scalar(const double* a, const double* b, int64_t n) {
  double s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 += a[i] * b[i];
    s1 += a[i + 1] * b[i + 1];
    s2 += a[i + 2] * b[i + 2];
    s3 += a[i + 3] * b[i + 3];
  }
  double acc = (s0 + s1) + (s2 + s3);
  for (; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

inline double dot_f64(const double* a, const double* b, int64_t n) {
#if defined(__x86_64__)
  if (log1p_avx2_available()) return dot_f64_avx2(a, b, n);
#endif
  return dot_f64_scalar(a, b, n);
}

// Vectorized subset scan: gather new_col for each raw index, keep entries
// with a non-negative remapped column, and left-pack (column, value) pairs
// IN ORDER via AVX-512 compress stores. Order preservation matters: the
// callers re-derive the library-size accumulator by summing the packed
// values sequentially, which is bit-identical to the scalar kernel's
// in-loop accumulation. The compress store may touch up to one full
// vector past the packed count, which stays in-bounds because the output
// buffers are sized to the raw row length (m + lanes <= i + lanes <= n).
#if defined(__x86_64__)
inline bool avx512_compress_available() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512vl") &&
                         __builtin_cpu_supports("avx512dq") &&
                         __builtin_cpu_supports("avx512bw");
  return ok;
}

__attribute__((target("avx512f,avx512vl,avx512dq,avx512bw")))
inline int64_t subset_compress(const int32_t* idx, const float* val,
                               int64_t n, const int32_t* new_col,
                               int32_t* out_cols, float* out_vals) {
  int64_t m = 0, i = 0;
  for (; i + 16 <= n; i += 16) {
    const __m512i ix =
        _mm512_loadu_si512(reinterpret_cast<const void*>(idx + i));
    const __m512i c = _mm512_i32gather_epi32(ix, new_col, 4);
    const __mmask16 k = _mm512_cmpge_epi32_mask(c, _mm512_setzero_si512());
    _mm512_mask_compressstoreu_epi32(out_cols + m, k, c);
    _mm512_mask_compressstoreu_ps(out_vals + m, k, _mm512_loadu_ps(val + i));
    m += _mm_popcnt_u32(k);
  }
  for (; i < n; ++i) {
    const int32_t c = new_col[idx[i]];
    if (c >= 0) {
      out_cols[m] = c;
      out_vals[m] = val[i];
      ++m;
    }
  }
  return m;
}

__attribute__((target("avx512f,avx512vl,avx512dq,avx512bw")))
inline int64_t subset_compress(const int32_t* idx, const double* val,
                               int64_t n, const int32_t* new_col,
                               int32_t* out_cols, double* out_vals) {
  int64_t m = 0, i = 0;
  for (; i + 8 <= n; i += 8) {
    const __m256i ix =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(idx + i));
    const __m256i c = _mm256_i32gather_epi32(new_col, ix, 4);
    const __mmask8 k = _mm256_cmpge_epi32_mask(c, _mm256_setzero_si256());
    _mm256_mask_compressstoreu_epi32(out_cols + m, k, c);
    _mm512_mask_compressstoreu_pd(out_vals + m, k, _mm512_loadu_pd(val + i));
    m += _mm_popcnt_u32(k);
  }
  for (; i < n; ++i) {
    const int32_t c = new_col[idx[i]];
    if (c >= 0) {
      out_cols[m] = c;
      out_vals[m] = val[i];
      ++m;
    }
  }
  return m;
}

__attribute__((target("avx512f,avx512vl,avx512dq,avx512bw")))
inline int64_t subset_compress(const int64_t* idx, const float* val,
                               int64_t n, const int32_t* new_col,
                               int32_t* out_cols, float* out_vals) {
  int64_t m = 0, i = 0;
  for (; i + 8 <= n; i += 8) {
    const __m512i ix =
        _mm512_loadu_si512(reinterpret_cast<const void*>(idx + i));
    const __m256i c = _mm512_i64gather_epi32(ix, new_col, 4);
    const __mmask8 k = _mm256_cmpge_epi32_mask(c, _mm256_setzero_si256());
    _mm256_mask_compressstoreu_epi32(out_cols + m, k, c);
    _mm256_mask_compressstoreu_ps(out_vals + m, k, _mm256_loadu_ps(val + i));
    m += _mm_popcnt_u32(k);
  }
  for (; i < n; ++i) {
    const int32_t c = new_col[idx[i]];
    if (c >= 0) {
      out_cols[m] = c;
      out_vals[m] = val[i];
      ++m;
    }
  }
  return m;
}

__attribute__((target("avx512f,avx512vl,avx512dq,avx512bw")))
inline int64_t subset_compress(const int64_t* idx, const double* val,
                               int64_t n, const int32_t* new_col,
                               int32_t* out_cols, double* out_vals) {
  int64_t m = 0, i = 0;
  for (; i + 8 <= n; i += 8) {
    const __m512i ix =
        _mm512_loadu_si512(reinterpret_cast<const void*>(idx + i));
    const __m256i c = _mm512_i64gather_epi32(ix, new_col, 4);
    const __mmask8 k = _mm256_cmpge_epi32_mask(c, _mm256_setzero_si256());
    _mm256_mask_compressstoreu_epi32(out_cols + m, k, c);
    _mm512_mask_compressstoreu_pd(out_vals + m, k, _mm512_loadu_pd(val + i));
    m += _mm_popcnt_u32(k);
  }
  for (; i < n; ++i) {
    const int32_t c = new_col[idx[i]];
    if (c >= 0) {
      out_cols[m] = c;
      out_vals[m] = val[i];
      ++m;
    }
  }
  return m;
}
#else
inline bool avx512_compress_available() { return false; }
template <typename IdxT, typename DataT>
inline int64_t subset_compress(const IdxT*, const DataT*, int64_t,
                               const int32_t*, int32_t*, DataT*) {
  return -1;  // unreachable: gated by avx512_compress_available()
}
#endif

// Per-row sketch contraction shared by the fused (Xty, YtY) kernels.
//
// A row's sketch touches at most m (= kept-entry count) of the d buckets,
// so when m < d the dense form — K length-d dots plus a d-length memset
// per row — wastes O(K*d) work on zeros. The sparse path instead
// accumulates Xty entry-wise against the TRANSPOSED signature sketch
// (xty_row[:] += wv * XskT[bucket, :], O(m*K) contiguous FMAs) and takes
// YtY from the touched buckets only, with lazy epoch-tagged zeroing in
// place of the per-row memset. Rows with m >= d keep the dense dots.
// Both paths compute the same sums with different f64 association
// (ULP-level; Xty is consumed as f32 on device, YtY only by the objective
// constant; the staged-vs-fused tests pin them at rtol 1e-10). The
// per-row path choice is deterministic in the row's own nnz, so chunked
// and full runs stay bit-identical.
struct SketchContract {
  std::vector<double> rowbuf;    // (d) bucket sums; valid where epoch==cur
  std::vector<int32_t> touched;  // unique buckets hit by the current row
  std::vector<uint32_t> epoch;   // (d) last row that touched each bucket
  std::vector<double> XskT;      // (d, K) transposed signature sketch
  uint32_t cur = 0;
  int64_t d = 0, K = 0;

  void init(const double* Xsk, int64_t sketch_dim, int64_t n_types) {
    d = sketch_dim;
    K = n_types;
    rowbuf.assign(static_cast<size_t>(d), 0.0);
    epoch.assign(static_cast<size_t>(d), 0);
    touched.clear();
    touched.reserve(static_cast<size_t>(d));
    XskT.resize(static_cast<size_t>(d) * K);
    for (int64_t k = 0; k < K; ++k)
      for (int64_t b = 0; b < d; ++b)
        XskT[static_cast<size_t>(b) * K + k] =
            Xsk[static_cast<size_t>(k) * d + b];
  }
  inline void begin_row() {
    ++cur;
    touched.clear();
  }
  inline void add(int32_t bucket, double wv, double* xty_row) {
    const size_t b = static_cast<size_t>(bucket);
    if (epoch[b] != cur) {
      epoch[b] = cur;
      rowbuf[b] = 0.0;
      touched.push_back(bucket);
    }
    rowbuf[b] += wv;
    const double* xt = XskT.data() + b * K;
    for (int64_t k = 0; k < K; ++k) xty_row[k] += wv * xt[k];
  }
  inline double finish_row() const {
    double s = 0.0;
    for (const int32_t b : touched) {
      const double v = rowbuf[static_cast<size_t>(b)];
      s += v * v;
    }
    return s;
  }
  // Dense fallback (m >= d): classic memset + scatter + K dense dots.
  // Leaves epochs stale on purpose — the sparse path re-zeroes lazily.
  inline void dense_begin() {
    std::memset(rowbuf.data(), 0, sizeof(double) * static_cast<size_t>(d));
  }
  inline double dense_finish(const double* Xsk, double* xty_row) const {
    for (int64_t k = 0; k < K; ++k)
      xty_row[k] =
          dot_f64(rowbuf.data(), Xsk + static_cast<size_t>(k) * d, d);
    return dot_f64(rowbuf.data(), rowbuf.data(), d);
  }
};

// Fused subset -> log_cpm -> sketch -> (Xty, YtY): like
// fused_log1pcpm_project_impl, but the (n_rows, d) sketch is never written
// to memory — each row's sketch lives in an L1-resident buffer and is
// immediately contracted against X_sketch (K, d) into Xty[r, :] and into
// the YtY sum-of-squares (see SketchContract for the sparse/dense per-row
// contraction). This removes the multi-GB sketch materialization plus the
// BLAS re-read at atlas scale. Per-row log1p/scatter semantics are
// bit-identical to fused_log1pcpm_project_impl.
template <typename DataT, typename IdxT>
void fused_log1pcpm_xty_impl(const int64_t* indptr, const IdxT* indices,
                             const DataT* data, const int32_t* new_col,
                             const int32_t* buckets, const double* weights,
                             const double* Xsk, int64_t n_rows,
                             int64_t sketch_dim, int64_t n_types,
                             int n_threads, double* out_xty,
                             double* out_yty) {
  const int64_t blocks = n_blocks(n_rows);
  std::vector<double> yty_partial(static_cast<size_t>(blocks), 0.0);
  parallel_blocks(blocks, n_threads, [&](int64_t b) {
    SketchContract ctr;
    ctr.init(Xsk, sketch_dim, n_types);
    // Per-row gather buffers: the subset entries are collected during the
    // library-size scan, so the 20x-larger raw row is read ONCE (the old
    // two-pass form re-scanned every nnz and re-gathered new_col per pass
    // — the dominant cost at atlas scale), and the log1p runs batched
    // over the compact buffer (vectorized on the f32 path).
    std::vector<DataT> vals;
    std::vector<int32_t> cols;
    std::vector<float> logs;
    std::vector<double> wv;
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    double yty = 0.0;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t lo = indptr[r], hi = indptr[r + 1];
      if (static_cast<int64_t>(vals.size()) < hi - lo) {
        vals.resize(static_cast<size_t>(hi - lo));
        cols.resize(static_cast<size_t>(hi - lo));
        wv.resize(static_cast<size_t>(hi - lo));
      }
      int64_t m;
      if (avx512_compress_available()) {
        m = subset_compress(indices + lo, data + lo, hi - lo, new_col,
                            cols.data(), vals.data());
      } else {
        m = 0;
        for (int64_t i = lo; i < hi; ++i) {
          const int32_t c = new_col[indices[i]];
          if (c >= 0) {
            vals[static_cast<size_t>(m)] = data[i];
            cols[static_cast<size_t>(m)] = c;
            ++m;
          }
        }
      }
      // Library size from the packed values, sequentially — bit-identical
      // to an in-scan accumulation (the compress preserves entry order).
      DataT acc = 0;
      for (int64_t j = 0; j < m; ++j) acc += vals[static_cast<size_t>(j)];
      const DataT lib = (acc == DataT(0)) ? DataT(1) : acc;
      const DataT s = DataT(1e4) / lib;
      if constexpr (std::is_same_v<DataT, float>) {
        if (static_cast<int64_t>(logs.size()) < m)
          logs.resize(static_cast<size_t>(m));
        for (int64_t j = 0; j < m; ++j)
          logs[static_cast<size_t>(j)] = vals[static_cast<size_t>(j)] * s;
        log1p_f32_batch(logs.data(), logs.data(), m);
        for (int64_t j = 0; j < m; ++j) {
          const int32_t c = cols[static_cast<size_t>(j)];
          wv[static_cast<size_t>(j)] =
              weights[c] * static_cast<double>(logs[static_cast<size_t>(j)]);
        }
      } else {
        for (int64_t j = 0; j < m; ++j) {
          const int32_t c = cols[static_cast<size_t>(j)];
          const DataT v = std::log1p(vals[static_cast<size_t>(j)] * s);
          wv[static_cast<size_t>(j)] = weights[c] * static_cast<double>(v);
        }
      }
      double* xty_row = out_xty + static_cast<size_t>(r) * n_types;
      if (m < sketch_dim) {
        ctr.begin_row();
        std::memset(xty_row, 0, sizeof(double) * n_types);
        for (int64_t j = 0; j < m; ++j)
          ctr.add(buckets[cols[static_cast<size_t>(j)]],
                  wv[static_cast<size_t>(j)], xty_row);
        yty += ctr.finish_row();
      } else {
        ctr.dense_begin();
        for (int64_t j = 0; j < m; ++j)
          ctr.rowbuf[buckets[cols[static_cast<size_t>(j)]]] +=
              wv[static_cast<size_t>(j)];
        yty += ctr.dense_finish(Xsk, xty_row);
      }
    }
    yty_partial[static_cast<size_t>(b)] = yty;
  });
  double total = 0.0;
  for (int64_t b = 0; b < blocks; ++b)
    total += yty_partial[static_cast<size_t>(b)];
  *out_yty = total;
}

// Column sums of the gene-subset matrix with a constant pre-scale,
// replicating scipy's ``(Y[:, gene_idx] * scale).sum(axis=0)`` BITWISE:
// scipy's mean(axis=0) multiplies every stored entry by 1/n in the data
// dtype first, then column-sums the products in row-major nnz order in the
// data dtype (csr sum(axis=0) is a sequential ones-vector matvec). This
// kernel replays exactly that on ONE thread — block partials would change
// the f32/f64 association — skipping dropped genes (new_col < 0). O(nnz)
// read-bound; feeds the fused pearson pipeline's per-gene means
// (reference flashdeconv/core/deconv.py:199-225 pearson branch).
template <typename DataT, typename IdxT>
void subset_scaled_col_sums_impl(const int64_t* indptr, const IdxT* indices,
                                 const DataT* data, const int32_t* new_col,
                                 double scale, int64_t n_rows, int64_t n_sub,
                                 DataT* out) {
  std::memset(out, 0, sizeof(DataT) * static_cast<size_t>(n_sub));
  const DataT s = static_cast<DataT>(scale);
  // Row boundaries are irrelevant to a column accumulation; walk the nnz
  // span directly (indptr may be a zero-copy row-range view with
  // indptr[0] != 0, like the fused-Xty kernels).
  for (int64_t i = indptr[0]; i < indptr[n_rows]; ++i) {
    const int32_t c = new_col[indices[i]];
    if (c >= 0) out[c] += data[i] * s;
  }
}

// Fused subset -> per-gene column scale -> CountSketch projection: the
// pearson / raw sparse pipelines' analog of fused_log1pcpm_project_impl.
// Per kept entry: v = data * colscale[c] in the data dtype — exactly the
// value scipy's ``Y_sub.multiply(colscale)`` stores (same dtype, same
// single multiply) — then out[r, bucket[c]] += weight[c] * (double)v, the
// projection kernel's contract. colscale == nullptr means v = data (the
// raw pipeline; its astype(float64) is exactly this widening). No libm
// involved, so unlike the log_cpm kernels this is bit-identical to the
// staged *scipy* pipeline, not just the staged native one.
template <typename DataT, typename IdxT>
void fused_colscale_project_impl(const int64_t* indptr, const IdxT* indices,
                                 const DataT* data, const int32_t* new_col,
                                 const DataT* colscale,
                                 const int32_t* buckets,
                                 const double* weights, int64_t n_rows,
                                 int64_t sketch_dim, int n_threads,
                                 double* out) {
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    std::memset(out + static_cast<size_t>(r0) * sketch_dim, 0,
                sizeof(double) * static_cast<size_t>(r1 - r0) * sketch_dim);
    for (int64_t r = r0; r < r1; ++r) {
      double* row = out + static_cast<size_t>(r) * sketch_dim;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        const int32_t c = new_col[indices[i]];
        if (c >= 0) {
          const DataT v =
              colscale ? static_cast<DataT>(data[i] * colscale[c]) : data[i];
          row[buckets[c]] += weights[c] * static_cast<double>(v);
        }
      }
    }
  });
}

// Fused subset -> column scale -> sketch -> (Xty, YtY): the pearson / raw
// analog of fused_log1pcpm_xty_impl. Per-row sketch values are bit-identical
// to fused_colscale_project_impl; the contraction shares SketchContract's
// sparse/dense per-row dispatch (ULP-level vs a BLAS gemm — consumed as f32
// Xty on device / by the objective constant).
template <typename DataT, typename IdxT>
void fused_colscale_xty_impl(const int64_t* indptr, const IdxT* indices,
                             const DataT* data, const int32_t* new_col,
                             const DataT* colscale, const int32_t* buckets,
                             const double* weights, const double* Xsk,
                             int64_t n_rows, int64_t sketch_dim,
                             int64_t n_types, int n_threads, double* out_xty,
                             double* out_yty) {
  const int64_t blocks = n_blocks(n_rows);
  std::vector<double> yty_partial(static_cast<size_t>(blocks), 0.0);
  parallel_blocks(blocks, n_threads, [&](int64_t b) {
    SketchContract ctr;
    ctr.init(Xsk, sketch_dim, n_types);
    std::vector<int32_t> cols;
    std::vector<DataT> vals;
    std::vector<double> wv;
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    double yty = 0.0;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t lo = indptr[r], hi = indptr[r + 1];
      if (static_cast<int64_t>(cols.size()) < hi - lo) {
        cols.resize(static_cast<size_t>(hi - lo));
        vals.resize(static_cast<size_t>(hi - lo));
        wv.resize(static_cast<size_t>(hi - lo));
      }
      int64_t m;
      if (avx512_compress_available()) {
        m = subset_compress(indices + lo, data + lo, hi - lo, new_col,
                            cols.data(), vals.data());
      } else {
        m = 0;
        for (int64_t i = lo; i < hi; ++i) {
          const int32_t c = new_col[indices[i]];
          if (c >= 0) {
            cols[static_cast<size_t>(m)] = c;
            vals[static_cast<size_t>(m)] = data[i];
            ++m;
          }
        }
      }
      for (int64_t j = 0; j < m; ++j) {
        const int32_t c = cols[static_cast<size_t>(j)];
        const DataT v = colscale
            ? static_cast<DataT>(vals[static_cast<size_t>(j)] * colscale[c])
            : vals[static_cast<size_t>(j)];
        wv[static_cast<size_t>(j)] = weights[c] * static_cast<double>(v);
      }
      double* xty_row = out_xty + static_cast<size_t>(r) * n_types;
      if (m < sketch_dim) {
        ctr.begin_row();
        std::memset(xty_row, 0, sizeof(double) * n_types);
        for (int64_t j = 0; j < m; ++j)
          ctr.add(buckets[cols[static_cast<size_t>(j)]],
                  wv[static_cast<size_t>(j)], xty_row);
        yty += ctr.finish_row();
      } else {
        ctr.dense_begin();
        for (int64_t j = 0; j < m; ++j)
          ctr.rowbuf[buckets[cols[static_cast<size_t>(j)]]] +=
              wv[static_cast<size_t>(j)];
        yty += ctr.dense_finish(Xsk, xty_row);
      }
    }
    yty_partial[static_cast<size_t>(b)] = yty;
  });
  double total = 0.0;
  for (int64_t b = 0; b < blocks; ++b)
    total += yty_partial[static_cast<size_t>(b)];
  *out_yty = total;
}

// Per-row sums in the data dtype: scipy ``.sum(axis=1)`` computes each row
// as a sequential nnz-order accumulation in the input dtype (csr_matvec
// against ones); rows are independent, so any thread partition is
// bit-identical to the scipy result.
template <typename DataT>
void csr_row_sums_impl(const int64_t* indptr, const DataT* data,
                       int64_t n_rows, int n_threads, DataT* out) {
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    for (int64_t r = r0; r < r1; ++r) {
      DataT acc = 0;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) acc += data[i];
      out[r] = acc;
    }
  });
}

// Fused gene-subset -> log_cpm -> CountSketch projection: one pass over the
// FULL count matrix that never materializes the subset CSR or the
// normalized copy. Per row: (1) library size = sum of KEPT entries in nnz
// order (the subset's row sum, preprocess clamp lib==0 -> 1); (2) scatter
// out[r, bucket[new_col[g]]] += weight[new_col[g]] * log1p(data * 1e4/lib).
// Bit-identical to the staged NATIVE pipeline (csr_subset ->
// log1p_cpm_transform -> countsketch_project), <= 1 ULP per log1p value vs
// pure numpy: the subset preserves nnz order, every float op
// (DataT-precision product/log1p, f64 widen, f64 scatter accumulation) is
// performed in the same order with the same precision as the staged
// kernels, and rows are independent so threading changes nothing.
template <typename DataT, typename IdxT>
void fused_log1pcpm_project_impl(const int64_t* indptr, const IdxT* indices,
                                 const DataT* data, const int32_t* new_col,
                                 const int32_t* buckets,
                                 const double* weights, int64_t n_rows,
                                 int64_t sketch_dim, int n_threads,
                                 double* out) {
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    // Same one-scan gather + batched log1p as fused_log1pcpm_xty_impl —
    // the per-value log1p is a per-element pure function (see
    // log1p_f32_value), so the two kernels' values stay mutually
    // bit-identical despite batching over different spans.
    std::vector<DataT> vals;
    std::vector<int32_t> cols;
    std::vector<float> logs;
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    std::memset(out + static_cast<size_t>(r0) * sketch_dim, 0,
                sizeof(double) * static_cast<size_t>(r1 - r0) * sketch_dim);
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t lo = indptr[r], hi = indptr[r + 1];
      if (static_cast<int64_t>(vals.size()) < hi - lo) {
        vals.resize(static_cast<size_t>(hi - lo));
        cols.resize(static_cast<size_t>(hi - lo));
      }
      int64_t m;
      if (avx512_compress_available()) {
        m = subset_compress(indices + lo, data + lo, hi - lo, new_col,
                            cols.data(), vals.data());
      } else {
        m = 0;
        for (int64_t i = lo; i < hi; ++i) {
          const int32_t c = new_col[indices[i]];
          if (c >= 0) {
            vals[static_cast<size_t>(m)] = data[i];
            cols[static_cast<size_t>(m)] = c;
            ++m;
          }
        }
      }
      DataT acc = 0;  // sequential over packed values == in-scan order
      for (int64_t j = 0; j < m; ++j) acc += vals[static_cast<size_t>(j)];
      const DataT lib = (acc == DataT(0)) ? DataT(1) : acc;
      const DataT s = DataT(1e4) / lib;
      double* row = out + static_cast<size_t>(r) * sketch_dim;
      if constexpr (std::is_same_v<DataT, float>) {
        if (static_cast<int64_t>(logs.size()) < m)
          logs.resize(static_cast<size_t>(m));
        for (int64_t j = 0; j < m; ++j)
          logs[static_cast<size_t>(j)] = vals[static_cast<size_t>(j)] * s;
        log1p_f32_batch(logs.data(), logs.data(), m);
        for (int64_t j = 0; j < m; ++j) {
          const int32_t c = cols[static_cast<size_t>(j)];
          row[buckets[c]] +=
              weights[c] * static_cast<double>(logs[static_cast<size_t>(j)]);
        }
      } else {
        for (int64_t j = 0; j < m; ++j) {
          const int32_t c = cols[static_cast<size_t>(j)];
          const DataT v = std::log1p(vals[static_cast<size_t>(j)] * s);
          row[buckets[c]] += weights[c] * static_cast<double>(v);
        }
      }
    }
  });
}

// out[i] = log1p(data[i] * scale[row]) in the data dtype — the sparse
// log_cpm preprocess. Element-wise (no accumulation): matches the numpy
// expression ``np.log1p(data * np.repeat(scale, counts))`` to <= 1 ULP
// (f64: bitwise where libm log1p == numpy's; f32: the vectorized
// double-precision log1p rounded once — see the Python-side self-tests)
// without materializing the per-nnz scale vector. The f32 values are the
// SAME per-element function the fused project/xty kernels apply, so
// staged and fused native paths stay mutually bit-identical.
template <typename DataT>
void log1p_cpm_transform_impl(const int64_t* indptr, const DataT* data,
                              const DataT* scale, int64_t n_rows,
                              int n_threads, DataT* out) {
  parallel_blocks(n_blocks(n_rows), n_threads, [&](int64_t b) {
    const int64_t r0 = b * block_rows(n_rows);
    const int64_t r1 = std::min(r0 + block_rows(n_rows), n_rows);
    for (int64_t r = r0; r < r1; ++r) {
      const DataT s = scale[r];
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        if constexpr (std::is_same_v<DataT, float>) {
          out[i] = data[i] * s;  // products first; one batched log1p below
        } else {
          out[i] = std::log1p(data[i] * s);
        }
      }
    }
    if constexpr (std::is_same_v<DataT, float>) {
      const int64_t lo = indptr[r0], hi = indptr[r1];
      log1p_f32_batch(out + lo, out + lo, hi - lo);
    }
  });
}

}  // namespace

extern "C" {

// ---- row sums / preprocess transform: data {f32, f64} ---------------------
#define DEFINE_ROWWISE(SUFFIX, DATA_T)                                       \
  void csr_row_sums_##SUFFIX(const int64_t* indptr, const DATA_T* data,      \
                             int64_t n_rows, int n_threads, DATA_T* out) {   \
    csr_row_sums_impl<DATA_T>(indptr, data, n_rows, n_threads, out);         \
  }                                                                          \
  void log1p_cpm_transform_##SUFFIX(                                         \
      const int64_t* indptr, const DATA_T* data, const DATA_T* scale,        \
      int64_t n_rows, int n_threads, DATA_T* out) {                          \
    log1p_cpm_transform_impl<DATA_T>(indptr, data, scale, n_rows, n_threads, \
                                     out);                                   \
  }

DEFINE_ROWWISE(f32, float)
DEFINE_ROWWISE(f64, double)
#undef DEFINE_ROWWISE

// float64 sum of squares of a dense buffer (the YtY objective constant).
// Fixed 4M-element chunks accumulated left-to-right per chunk, chunk
// partials reduced in chunk order — deterministic per length at any thread
// count. (Large-array fast path; small solves keep the numpy einsum.)
void sq_sum_f64(const double* x, int64_t n, int n_threads, double* out) {
  const int64_t chunk = 1 << 22;
  const int64_t chunks = (n + chunk - 1) / chunk;
  std::vector<double> partial(static_cast<size_t>(chunks), 0.0);
  parallel_blocks(chunks, n_threads, [&](int64_t c) {
    const int64_t lo = c * chunk;
    const int64_t hi = std::min(lo + chunk, n);
    double acc = 0.0;
    for (int64_t i = lo; i < hi; ++i) acc += x[i] * x[i];
    partial[static_cast<size_t>(c)] = acc;
  });
  double total = 0.0;
  for (int64_t c = 0; c < chunks; ++c) total += partial[static_cast<size_t>(c)];
  *out = total;
}

// ---- moments: data {f32, f64} x indices {i32, i64} ------------------------
#define DEFINE_MOMENTS(SUFFIX, DATA_T, IDX_T)                                \
  void log1p_cpm_moments_##SUFFIX(                                           \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const double* scale, int64_t n_rows, int64_t n_genes, int n_threads,   \
      double* out_sum, double* out_sumsq) {                                  \
    log1p_cpm_moments_impl<DATA_T, IDX_T>(indptr, indices, data, scale,      \
                                          n_rows, n_genes, n_threads,        \
                                          out_sum, out_sumsq);               \
  }

DEFINE_MOMENTS(f32_i32, float, int32_t)
DEFINE_MOMENTS(f32_i64, float, int64_t)
DEFINE_MOMENTS(f64_i32, double, int32_t)
DEFINE_MOMENTS(f64_i64, double, int64_t)
#undef DEFINE_MOMENTS

// f32-intermediates variants (numpy float32-path semantics, see CalcT note).
#define DEFINE_MOMENTS_F32M(SUFFIX, IDX_T)                                   \
  void log1p_cpm_moments_##SUFFIX(                                           \
      const int64_t* indptr, const IDX_T* indices, const float* data,        \
      const double* scale, int64_t n_rows, int64_t n_genes, int n_threads,   \
      double* out_sum, double* out_sumsq) {                                  \
    log1p_cpm_moments_impl<float, IDX_T, float>(indptr, indices, data,       \
                                                scale, n_rows, n_genes,      \
                                                n_threads, out_sum,          \
                                                out_sumsq);                  \
  }

DEFINE_MOMENTS_F32M(f32m_i32, int32_t)
DEFINE_MOMENTS_F32M(f32m_i64, int64_t)
#undef DEFINE_MOMENTS_F32M

// Self-scaled variants: scale == nullptr, per-row 1e4/max(row_sum, 1)
// computed in the fused pass (see log1p_cpm_moments_impl).
#define DEFINE_MOMENTS_AUTO(SUFFIX, DATA_T, IDX_T, CALC_T)                   \
  void log1p_cpm_moments_auto_##SUFFIX(                                      \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      int64_t n_rows, int64_t n_genes, int n_threads, double* out_sum,       \
      double* out_sumsq) {                                                   \
    log1p_cpm_moments_impl<DATA_T, IDX_T, CALC_T>(                           \
        indptr, indices, data, nullptr, n_rows, n_genes, n_threads,          \
        out_sum, out_sumsq);                                                 \
  }

DEFINE_MOMENTS_AUTO(f32m_i32, float, int32_t, float)
DEFINE_MOMENTS_AUTO(f32m_i64, float, int64_t, float)
DEFINE_MOMENTS_AUTO(f64_i32, double, int32_t, double)
DEFINE_MOMENTS_AUTO(f64_i64, double, int64_t, double)
#undef DEFINE_MOMENTS_AUTO

// ---- CountSketch projection: data {f32, f64} x indices {i32, i64} ---------
#define DEFINE_PROJECT(SUFFIX, DATA_T, IDX_T)                                \
  void countsketch_project_##SUFFIX(                                         \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const int32_t* buckets, const double* weights, int64_t n_rows,         \
      int64_t sketch_dim, int n_threads, double* out) {                      \
    countsketch_project_impl<DATA_T, IDX_T>(indptr, indices, data, buckets,  \
                                            weights, n_rows, sketch_dim,     \
                                            n_threads, out);                 \
  }

DEFINE_PROJECT(f32_i32, float, int32_t)
DEFINE_PROJECT(f32_i64, float, int64_t)
DEFINE_PROJECT(f64_i32, double, int32_t)
DEFINE_PROJECT(f64_i64, double, int64_t)
#undef DEFINE_PROJECT

// ---- fused subset -> log_cpm -> projection ---------------------------------
#define DEFINE_FUSED(SUFFIX, DATA_T, IDX_T)                                  \
  void fused_log1pcpm_project_##SUFFIX(                                      \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const int32_t* new_col, const int32_t* buckets,                        \
      const double* weights, int64_t n_rows, int64_t sketch_dim,             \
      int n_threads, double* out) {                                          \
    fused_log1pcpm_project_impl<DATA_T, IDX_T>(                              \
        indptr, indices, data, new_col, buckets, weights, n_rows,            \
        sketch_dim, n_threads, out);                                         \
  }

DEFINE_FUSED(f32_i32, float, int32_t)
DEFINE_FUSED(f32_i64, float, int64_t)
DEFINE_FUSED(f64_i32, double, int32_t)
DEFINE_FUSED(f64_i64, double, int64_t)
#undef DEFINE_FUSED

// ---- fused subset -> log_cpm -> sketch -> (Xty, YtY) -----------------------
#define DEFINE_FUSED_XTY(SUFFIX, DATA_T, IDX_T)                              \
  void fused_log1pcpm_xty_##SUFFIX(                                         \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,      \
      const int32_t* new_col, const int32_t* buckets,                       \
      const double* weights, const double* Xsk, int64_t n_rows,             \
      int64_t sketch_dim, int64_t n_types, int n_threads, double* out_xty,  \
      double* out_yty) {                                                    \
    fused_log1pcpm_xty_impl<DATA_T, IDX_T>(                                 \
        indptr, indices, data, new_col, buckets, weights, Xsk, n_rows,      \
        sketch_dim, n_types, n_threads, out_xty, out_yty);                  \
  }

DEFINE_FUSED_XTY(f32_i32, float, int32_t)
DEFINE_FUSED_XTY(f32_i64, float, int64_t)
DEFINE_FUSED_XTY(f64_i32, double, int32_t)
DEFINE_FUSED_XTY(f64_i64, double, int64_t)
#undef DEFINE_FUSED_XTY

// ---- fused subset -> column scale -> projection / (Xty, YtY) ---------------
#define DEFINE_COLSCALE(SUFFIX, DATA_T, IDX_T)                                \
  void subset_scaled_col_sums_##SUFFIX(                                      \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const int32_t* new_col, double scale, int64_t n_rows, int64_t n_sub,   \
      DATA_T* out) {                                                         \
    subset_scaled_col_sums_impl<DATA_T, IDX_T>(indptr, indices, data,        \
                                               new_col, scale, n_rows,       \
                                               n_sub, out);                  \
  }                                                                          \
  void fused_colscale_project_##SUFFIX(                                      \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const int32_t* new_col, const DATA_T* colscale,                        \
      const int32_t* buckets, const double* weights, int64_t n_rows,         \
      int64_t sketch_dim, int n_threads, double* out) {                      \
    fused_colscale_project_impl<DATA_T, IDX_T>(                              \
        indptr, indices, data, new_col, colscale, buckets, weights, n_rows,  \
        sketch_dim, n_threads, out);                                         \
  }                                                                          \
  void fused_colscale_xty_##SUFFIX(                                          \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const int32_t* new_col, const DATA_T* colscale,                        \
      const int32_t* buckets, const double* weights, const double* Xsk,      \
      int64_t n_rows, int64_t sketch_dim, int64_t n_types, int n_threads,    \
      double* out_xty, double* out_yty) {                                    \
    fused_colscale_xty_impl<DATA_T, IDX_T>(                                  \
        indptr, indices, data, new_col, colscale, buckets, weights, Xsk,     \
        n_rows, sketch_dim, n_types, n_threads, out_xty, out_yty);           \
  }

DEFINE_COLSCALE(f32_i32, float, int32_t)
DEFINE_COLSCALE(f32_i64, float, int64_t)
DEFINE_COLSCALE(f64_i32, double, int32_t)
DEFINE_COLSCALE(f64_i64, double, int64_t)
#undef DEFINE_COLSCALE

// ---- CSR column subset: data {f32, f64} x indices {i32, i64} --------------
#define DEFINE_SUBSET(SUFFIX, DATA_T, IDX_T)                                 \
  void csr_subset_count_##SUFFIX(                                            \
      const int64_t* indptr, const IDX_T* indices, const int32_t* new_col,   \
      int64_t n_rows, int n_threads, int64_t* row_counts) {                  \
    csr_subset_count_impl<DATA_T, IDX_T>(indptr, indices, new_col, n_rows,   \
                                         n_threads, row_counts);             \
  }                                                                          \
  void csr_subset_fill_##SUFFIX(                                             \
      const int64_t* indptr, const IDX_T* indices, const DATA_T* data,       \
      const int32_t* new_col, const int64_t* out_indptr, int64_t n_rows,     \
      int n_threads, int32_t* out_indices, DATA_T* out_data) {               \
    csr_subset_fill_impl<DATA_T, IDX_T>(indptr, indices, data, new_col,      \
                                        out_indptr, n_rows, n_threads,       \
                                        out_indices, out_data);              \
  }

DEFINE_SUBSET(f32_i32, float, int32_t)
DEFINE_SUBSET(f32_i64, float, int64_t)
DEFINE_SUBSET(f64_i32, double, int32_t)
DEFINE_SUBSET(f64_i64, double, int64_t)
#undef DEFINE_SUBSET

// Self-test hook: log1p over a buffer so the loader can verify bitwise
// agreement with numpy's float64 log1p before enabling the moments path.
void log1p_buffer(const double* in, double* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = std::log1p(in[i]);
}

// Self-test hook for the float32 kernels: the exact batched expression the
// f32 fused/transform instantiations apply (vectorized double-precision
// log1p rounded once to f32; scalar tail replays the identical operation
// sequence). The loader gates those kernels on (a) ULP agreement with
// numpy's float32 log1p and (b) shift-invariance of this buffer — which
// verifies the vector lanes and the scalar replay produce identical bits,
// the property that lets different kernels batch the same values over
// different spans and stay mutually bit-identical.
void log1p_buffer_f32(const float* in, float* out, int64_t n) {
  log1p_f32_batch(in, out, n);
}

// Zero a buffer from many threads. Functionally memset; exists because
// faulting fresh pages from one thread can run two orders of magnitude
// slower than from several on virtualized hosts (see
// utils/hostmem.reserve_host_arena, which uses this to pre-fault the heap).
void zero_fill(char* p, int64_t n, int n_threads) {
  const int64_t chunk = 64 * 1024 * 1024;
  parallel_blocks((n + chunk - 1) / chunk, n_threads, [&](int64_t b) {
    const int64_t lo = b * chunk;
    std::memset(p + lo, 0, std::min(chunk, n - lo));
  });
}

}  // extern "C"
