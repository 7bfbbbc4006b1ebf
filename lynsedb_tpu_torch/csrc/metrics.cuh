// The distance formulas of the metrics outside IP, L2 and cosine, one set for
// every kernel that scores them: K6a (flat_scores_f32.cu) and K6c
// (elementwise_scores.cu) over a corpus, and K17 (beam_search.cu), K19
// (topl_scan.cu) and K20 (robust_prune.cu) under the graph indexes' domain
// metrics. Each follows lynsedb_tpu/ops/distance.py term for term, with the
// reference's policies for constant, zero-mass, invalid and out-of-range rows.
//
// A metric's transform (ops/distance.py corpus_transform) gives each row its
// lead values (the centred row for correlation, the square roots for
// Hellinger, the cdf for Wasserstein, the probabilities for Jensen-Shannon,
// the row itself otherwise) and up to three per-row terms, RowTerm (a, b, inv):
//   correlation     a = the centred row's sum of squares, b = the row mean
//   Hellinger       a = the mass, inv = a negative or non-finite entry
//   Wasserstein     a = the mass, inv
//   Jensen-Shannon  a = the entropy sum p log p, b = the mass, inv
// A pair's distance is then a function of one accumulated value (a dot
// product, a sum or a max over the lead values) and the two rows' terms.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace lt {

// One row's per-row terms (zero for the metrics that have none).
struct RowTerm {
  float a = 0.f, b = 0.f;
  bool inv = false;
};

// Two running values a (query, row) pair: the sum or max, and Bray-Curtis's
// denominator.
struct Acc {
  float a = 0.f, b = 0.f;
};

// Adds the pair's term of one dimension (u the query's lead value, v the
// row's). Every operation is separately rounded, so a plain version that adds
// the same terms in the same order forms the same bits.
template <int M>
__device__ __forceinline__ void accumulate(Acc& acc, float u, float v) {
  const float diff = fabsf(u - v);
  if constexpr (M == kL1 || M == kWasserstein) {
    acc.a += diff;
  } else if constexpr (M == kChebyshev) {
    acc.a = (diff > acc.a || diff != diff) ? diff : acc.a;  // keeps a NaN
  } else if constexpr (M == kCanberra) {
    const float den = fabsf(u) + fabsf(v);
    acc.a += den == 0.f ? 0.f : __fdiv_rn(diff, max_keep_nan(den, 1e-45f));
  } else if constexpr (M == kBrayCurtis) {
    acc.a += diff;
    acc.b += fabsf(u + v);
  } else if constexpr (M == kJensenShannon) {
    const float m = u + v;
    acc.a += m > 0.f ? __fmul_rn(m, logf(m)) : 0.f;
  }
}

// Merges a warp's lanes' partial accumulators: lane l adds lane l ^ o, o = 16,
// 8, 4, 2, 1 (ops/graph.py _lane_sum's order).
template <int M>
__device__ __forceinline__ Acc warp_merge(Acc acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float a = __shfl_xor_sync(0xffffffffu, acc.a, o);
    const float b = __shfl_xor_sync(0xffffffffu, acc.b, o);
    if constexpr (M == kChebyshev) {
      acc.a = (a > acc.a || a != a) ? a : acc.a;
    } else {
      acc.a += a;
      acc.b += b;
    }
  }
  return acc;
}

// Correlation and Hellinger from the dot product of the transformed rows:
//   correlation  1 - clip(dot / max(sqrt(a_q a_x), 1e-30), -1, 1); a row with
//                a <= 1e-12 is constant: 0 against an equal constant row, else 1
//   Hellinger    sqrt(1 - clip(dot / max(sqrt(a_q a_x), 1e-30), 0, 1)); the
//                zero-mass policy (0 or 1); +inf if either row is invalid
__device__ __forceinline__ float gemm_distance(int metric, float dot, RowTerm q, RowTerm x) {
  const float ratio = __fdiv_rn(dot, max_keep_nan(__fsqrt_rn(__fmul_rn(q.a, x.a)), 1e-30f));
  if (metric == kCorrelation) {
    const bool cq = q.a <= 1e-12f, cx = x.a <= 1e-12f;
    if (cq || cx) return (cq && cx && q.b == x.b) ? 0.f : 1.f;
    return __fsub_rn(1.f, clip_keep_nan(ratio, -1.f, 1.f));
  }
  if (q.inv || x.inv) return INFINITY;  // Hellinger
  const float bc = clip_keep_nan(ratio, 0.f, 1.f);
  return mass_policy(q.a, x.a, 1.f, __fsqrt_rn(__fsub_rn(1.f, bc)));
}

// The elementwise family from the accumulated value:
//   L1, Chebyshev, Canberra  the sum or max
//   Bray-Curtis   den == 0 ? (num == 0 ? 0 : inf) : num / max(den, 1e-45)
//   Wasserstein   the sum over the cdf, then the zero-mass policy (0 / inf)
//   Jensen-Shannon  sqrt(max(ln 2 + (ent_q + ent_x - mix) / 2, 0)), mix the sum
//                 of m log m, then the zero-mass policy (0 / sqrt(ln 2))
// and +inf where either probability row is invalid.
template <int M>
__device__ __forceinline__ float elem_distance(Acc acc, RowTerm q, RowTerm x) {
  if constexpr (M == kBrayCurtis) {
    return acc.b == 0.f ? (acc.a == 0.f ? 0.f : INFINITY)
                        : __fdiv_rn(acc.a, max_keep_nan(acc.b, 1e-45f));
  } else if constexpr (M == kWasserstein) {
    const float d = mass_policy(q.a, x.a, INFINITY, acc.a);
    return (q.inv || x.inv) ? INFINITY : d;
  } else if constexpr (M == kJensenShannon) {
    const float ent = __fsub_rn(__fadd_rn(q.a, x.a), acc.a);
    const float div = __fadd_rn(0.69314718f, __fmul_rn(0.5f, ent));
    const float d = mass_policy(q.b, x.b, 0.83255461f, sqrtf(max_keep_nan(div, 0.f)));
    return (q.inv || x.inv) ? INFINITY : d;
  } else {
    return acc.a;
  }
}

// Haversine over (lon, lat) rows in degrees, in the JAX package's order of f32
// operations, IUGG mean radius; +inf where either row is non-finite or
// |lat| > 90. A row's own part (radians, cos(lat), validity) is GeoRow, so a
// kernel that meets a row many times (K20's pair table) forms it once: the
// same operations on the same inputs, the same bits.
struct GeoRow {
  float lon, lat, cos_lat;
  bool ok;
};

__device__ __forceinline__ GeoRow geo_row(float lon, float lat) {
  const float deg2rad = 0.017453292519943295f;
  const float lat_r = __fmul_rn(lat, deg2rad);
  return GeoRow{__fmul_rn(lon, deg2rad), lat_r, cosf(lat_r),
                isfinite(lon) && isfinite(lat) && !(fabsf(lat) > 90.f)};
}

__device__ __forceinline__ float haversine(GeoRow q, GeoRow x) {
  if (!q.ok || !x.ok) return INFINITY;
  const float r = 6371008.8f;
  const float sin_lat = sinf(__fmul_rn(__fsub_rn(x.lat, q.lat), 0.5f));
  const float sin_lon = sinf(__fmul_rn(__fsub_rn(x.lon, q.lon), 0.5f));
  const float cc = __fmul_rn(__fmul_rn(__fmul_rn(q.cos_lat, x.cos_lat), sin_lon), sin_lon);
  const float h = clip_keep_nan(__fadd_rn(__fmul_rn(sin_lat, sin_lat), cc), 0.f, 1.f);
  return __fmul_rn(__fmul_rn(2.f, r), asinf(sqrtf(h)));
}

__device__ __forceinline__ float haversine(float qlon, float qlat, float xlon, float xlat) {
  return haversine(geo_row(qlon, qlat), geo_row(xlon, xlat));
}

// The terms of row i from a (3, stride) array [a; b; inv] (null: no terms).
__device__ __forceinline__ RowTerm row_term(const float* terms, int64_t stride, int64_t i) {
  if (terms == nullptr) return RowTerm{};
  return RowTerm{__ldg(terms + i), __ldg(terms + stride + i), __ldg(terms + 2 * stride + i) != 0.f};
}

template <typename T>
__device__ __forceinline__ float load_row(const T* x, int64_t i, const float* mean, int d) {
  if constexpr (std::is_same<T, float>::value) {
    return __ldg(x + i);
  } else {
    return __bfloat162float(x[i]) + mean[d];  // the centred copy, mean added back in f32
  }
}

// K6c's 64-row tile (the bf16 corpus's, K9, and the f32 rows' under
// Canberra and Jensen-Shannon above B = 8): acc[i][j] gathers accumulate<M> of query q0 + ty *
// RQ + i against row n0 + tx * 4 + j (tx = thread % 16, ty = thread / 16, RQ
// = TQ / 16) over all D dimensions in order, staged kTileK at a time through
// qs and xs; queries >= B and rows >= n_end read as 0. T is float or the
// centred __nv_bfloat16 copy with ``mean`` (D,) added back. All kTileThreads
// threads of the block call it.
template <int M, int TQ, typename T>
__device__ __forceinline__ void elem_tile_accumulate(const float* __restrict__ q,
                                                     const T* __restrict__ x,
                                                     const float* __restrict__ mean, int B,
                                                     int64_t n_end, int D, int q0, int64_t n0,
                                                     float (&qs)[kTileK][TQ + 4],
                                                     float (&xs)[kTileK][kTile + 4],
                                                     Acc (&acc)[TQ / 16][4]) {
  constexpr int RQ = TQ / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < D; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kTileThreads) {
      const int r = e / kTileK, c = e % kTileK, d = k0 + c;
      if (r < TQ) {
        const int qi = q0 + r;
        qs[c][r] = (qi < B && d < D) ? __ldg(q + (int64_t)qi * D + d) : 0.f;
      }
      const int64_t ni = n0 + r;
      xs[c][r] = (ni < n_end && d < D) ? load_row(x, ni * D + d, mean, d) : 0.f;
    }
    __syncthreads();
    const int kk_end = min(kTileK, D - k0);  // padded dimensions add nothing
    for (int kk = 0; kk < kk_end; ++kk) {
      float a[RQ], v[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[kk][ty * RQ + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = xs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accumulate<M>(acc[i][j], a[i], v[j]);
    }
    __syncthreads();
  }
}

}  // namespace lt
