// K6c: the elementwise family — L1, Chebyshev, Canberra, Bray-Curtis,
// Wasserstein (L1 over the rows' cdf transform), Jensen-Shannon (over the
// probability transform) and Haversine — as one tiled kernel with the metric
// a template parameter. Two further template switches serve the other jobs of
// the family: the corpus type (f32 rows, or the mean-centred bf16 copy with
// the mean added back in f32, K9's approximate first pass) and an explicit
// (B, C) row list (the gather mode: K10's rescore of shortlists).
//
// Replaces lynsedb_tpu/ops/distance.py _pw_l1 (:199) to _pw_jensen_shannon
// (:254) inside scan.py flat_topk (:190) and flat_scores (:243); scan.py
// bf16_flat_topk (:681, the bf16 mode); scan.py rescore_rows (:744, the gather
// mode). Per element, with the JAX package's policies:
//   L1           sum |a - b|               Chebyshev  max |a - b|
//   Canberra     sum (|a| + |b| == 0 ? 0 : |a - b| / max(|a| + |b|, 1e-45))
//   Bray-Curtis  num = sum |a - b|, den = sum |a + b|;
//                den == 0 ? (num == 0 ? 0 : inf) : num / max(den, 1e-45)
//   Wasserstein  sum |cdf_a - cdf_b|, then the zero-mass policy (0 / inf)
//   Jensen-Shannon  mix = sum (m > 0 ? m log m : 0), m = p_a + p_b;
//                sqrt(max(ln 2 + (ent_a + ent_b - mix) / 2, 0)), then the
//                zero-mass policy (0 / sqrt(ln 2))
//   Haversine    (lon, lat) degrees, IUGG radius; +inf for an invalid row
// and +inf where either probability row is invalid. IEEE division, logf,
// sinf, cosf, asinf and sqrtf, and no flush to zero: Canberra's 1e-45 floor is
// a denormal, which flushed to 0 would turn a finite term into 0/0.
//
// Bound: operations at B >= 16 (2-3 f32 operations an element for the L1
// family and Wasserstein, with a division for Canberra and a logarithm for
// Jensen-Shannon), the read of the rows at B = 1; Haversine reads 8 bytes a
// row and is bound by its trigonometry at large B.
// Design: common.cuh's tile shape (TQ queries x 64 rows a block, RQ x 4
// outputs a thread, 16-deep shared-memory stages of the query and row tiles)
// with a per-metric accumulator in place of the FMA; the epilogue applies the
// metric's policy, orients and masks. The gather mode gives each (query, slot)
// a warp whose lanes split the dimensions and reduce by shuffles.
#include <type_traits>

#include "common.cuh"

namespace {

enum ElemMetric : int {
  kL1 = 0, kChebyshev = 1, kCanberra = 2, kBrayCurtis = 3, kWasserstein = 4, kJensenShannon = 5,
  kHaversine = 6
};

// Two running values a (query, row) pair: the sum or max, and Bray-Curtis's
// denominator.
struct Acc {
  float a = 0.f, b = 0.f;
};

template <int M>
__device__ __forceinline__ void accumulate(Acc& acc, float u, float v) {
  const float diff = fabsf(u - v);
  if constexpr (M == kL1 || M == kWasserstein) {
    acc.a += diff;
  } else if constexpr (M == kChebyshev) {
    acc.a = (diff > acc.a || diff != diff) ? diff : acc.a;  // keeps a NaN
  } else if constexpr (M == kCanberra) {
    const float den = fabsf(u) + fabsf(v);
    acc.a += den == 0.f ? 0.f : __fdiv_rn(diff, lt::max_keep_nan(den, 1e-45f));
  } else if constexpr (M == kBrayCurtis) {
    acc.a += diff;
    acc.b += fabsf(u + v);
  } else if constexpr (M == kJensenShannon) {
    const float m = u + v;
    acc.a += m > 0.f ? __fmul_rn(m, logf(m)) : 0.f;
  }
}

// Merges a warp's lanes' partial accumulators (the gather mode).
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

// Per-row terms of the probability metrics (null for the others).
struct RowTerms {
  const float* q_mass;
  const float* q_ent;
  const uint8_t* q_inv;
  const float* x_mass;
  const float* x_ent;
  const uint8_t* x_inv;

  template <int M>
  __device__ __forceinline__ float distance(int b, int64_t n, Acc acc) const {
    if constexpr (M == kBrayCurtis) {
      return acc.b == 0.f ? (acc.a == 0.f ? 0.f : INFINITY)
                          : __fdiv_rn(acc.a, lt::max_keep_nan(acc.b, 1e-45f));
    } else if constexpr (M == kWasserstein || M == kJensenShannon) {
      float d = acc.a;
      if constexpr (M == kJensenShannon) {
        const float ent = __fsub_rn(__fadd_rn(q_ent[b], x_ent[n]), acc.a);
        const float div = __fadd_rn(0.69314718f, __fmul_rn(0.5f, ent));
        d = sqrtf(lt::max_keep_nan(div, 0.f));
      }
      d = lt::mass_policy(q_mass[b], x_mass[n], M == kWasserstein ? INFINITY : 0.83255461f, d);
      return (q_inv[b] || x_inv[n]) ? INFINITY : d;
    } else {
      return acc.a;
    }
  }
};

template <typename T>
__device__ __forceinline__ float load_row(const T* x, int64_t i, const float* mean, int d) {
  if constexpr (std::is_same<T, float>::value) {
    return __ldg(x + i);
  } else {
    return __bfloat162float(x[i]) + mean[d];  // the centred copy, mean added back in f32
  }
}

template <int M, typename T, int TQ>
__global__ void __launch_bounds__(lt::kTileThreads)
    elem_tile_kernel(const float* __restrict__ q, const T* __restrict__ x,
                     const float* __restrict__ mean, int B, int N, int D, RowTerms terms,
                     const uint8_t* __restrict__ valid, float* __restrict__ keys) {
  constexpr int RQ = TQ / 16;
  __shared__ float qs[lt::kTileK][TQ + 4];
  __shared__ float xs[lt::kTileK][lt::kTile + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * TQ;
  const int64_t n0 = (int64_t)blockIdx.x * lt::kTile;
  Acc acc[RQ][4];
  for (int k0 = 0; k0 < D; k0 += lt::kTileK) {
    for (int e = threadIdx.x; e < lt::kTile * lt::kTileK; e += lt::kTileThreads) {
      const int r = e / lt::kTileK, c = e % lt::kTileK, d = k0 + c;
      if (r < TQ) {
        const int qi = q0 + r;
        qs[c][r] = (qi < B && d < D) ? __ldg(q + (int64_t)qi * D + d) : 0.f;
      }
      const int64_t ni = n0 + r;
      xs[c][r] = (ni < N && d < D) ? load_row(x, ni * D + d, mean, d) : 0.f;
    }
    __syncthreads();
    const int kk_end = min(lt::kTileK, D - k0);  // padded dimensions add nothing
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
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int b = q0 + ty * RQ + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx * 4 + j;
      if (n < N) keys[(int64_t)b * N + n] = lt::to_key(terms.distance<M>(b, n, acc[i][j]), true,
                                                       valid[n] != 0);
    }
  }
}

constexpr int kGatherThreads = 256;
constexpr int kGatherSlots = 64;

template <int M>
__global__ void __launch_bounds__(kGatherThreads)
    elem_gather_kernel(const float* __restrict__ q, const float* __restrict__ x,
                       const int* __restrict__ ids, int C, int D, RowTerms terms,
                       float* __restrict__ keys) {
  extern __shared__ __align__(16) float qrow[];
  const int b = blockIdx.y;
  for (int d = threadIdx.x; d < D; d += kGatherThreads) qrow[d] = q[(int64_t)b * D + d];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_end = min(C, ((int)blockIdx.x + 1) * kGatherSlots);
  for (int c = (int)blockIdx.x * kGatherSlots + warp; c < c_end; c += kGatherThreads / 32) {
    const int n = ids[(int64_t)b * C + c];
    float key = -INFINITY;
    if (n >= 0) {  // the same for the whole warp
      const float* xr = x + (int64_t)n * D;
      Acc acc;
      for (int d = lane; d < D; d += 32) accumulate<M>(acc, qrow[d], __ldg(xr + d));
      key = lt::to_key(terms.distance<M>(b, n, warp_merge<M>(acc)), true, true);
    }
    if (lane == 0) keys[(int64_t)b * C + c] = key;
  }
}

// Haversine over (lon, lat) rows in degrees, in the JAX package's order of
// f32 operations; +inf where either row is non-finite or |lat| > 90.
__device__ __forceinline__ float haversine(float qlon, float qlat, float xlon, float xlat) {
  const bool bad = !isfinite(qlon) || !isfinite(qlat) || !isfinite(xlon) || !isfinite(xlat) ||
                   fabsf(qlat) > 90.f || fabsf(xlat) > 90.f;
  if (bad) return INFINITY;
  const float deg2rad = 0.017453292519943295f, r = 6371008.8f;
  const float lon1 = __fmul_rn(qlon, deg2rad), lat1 = __fmul_rn(qlat, deg2rad);
  const float lon2 = __fmul_rn(xlon, deg2rad), lat2 = __fmul_rn(xlat, deg2rad);
  const float sin_lat = sinf(__fmul_rn(__fsub_rn(lat2, lat1), 0.5f));
  const float sin_lon = sinf(__fmul_rn(__fsub_rn(lon2, lon1), 0.5f));
  const float cc = __fmul_rn(__fmul_rn(__fmul_rn(cosf(lat1), cosf(lat2)), sin_lon), sin_lon);
  const float h = lt::clip_keep_nan(__fadd_rn(__fmul_rn(sin_lat, sin_lat), cc), 0.f, 1.f);
  return __fmul_rn(__fmul_rn(2.f, r), asinf(sqrtf(h)));
}

// A thread a (query, row) in tile mode (the row's validity masks it) or a
// (query, slot) in gather mode.
__global__ void __launch_bounds__(256)
    haversine_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const uint8_t* __restrict__ valid, const int* __restrict__ ids, int N, int C,
                     float* __restrict__ keys) {
  const int b = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t width = ids ? C : N;
  if (j >= width) return;
  const int64_t n = ids ? ids[(int64_t)b * C + j] : j;
  float key = -INFINITY;
  if (n >= 0) {
    const float2 xr = __ldg(reinterpret_cast<const float2*>(x) + n);
    const float2 qr = reinterpret_cast<const float2*>(q)[b];
    key = lt::to_key(haversine(qr.x, qr.y, xr.x, xr.y), true, ids ? true : valid[n] != 0);
  }
  keys[(int64_t)b * width + j] = key;
}

template <int M, typename T>
int launch_tile(const float* q, const T* x, const float* mean, int B, int N, int D,
                RowTerms terms, const uint8_t* valid, float* keys, cudaStream_t stream) {
  const unsigned row_blocks = (unsigned)((N + lt::kTile - 1) / lt::kTile);
  if (B <= 16) {
    elem_tile_kernel<M, T, 16><<<dim3(row_blocks, 1), lt::kTileThreads, 0, stream>>>(
        q, x, mean, B, N, D, terms, valid, keys);
  } else {
    const unsigned query_blocks = (unsigned)((B + lt::kTile - 1) / lt::kTile);
    elem_tile_kernel<M, T, 64><<<dim3(row_blocks, query_blocks), lt::kTileThreads, 0, stream>>>(
        q, x, mean, B, N, D, terms, valid, keys);
  }
  return (int)cudaGetLastError();
}

template <int M>
int launch(const float* q, const void* x, bool x_bf16, const float* mean, int B, int N, int D,
           int C, RowTerms terms, const uint8_t* valid, const int* ids, float* keys,
           cudaStream_t stream) {
  if (ids != nullptr) {
    if (x_bf16 || (size_t)D * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((C + kGatherSlots - 1) / kGatherSlots), (unsigned)B);
    elem_gather_kernel<M><<<grid, kGatherThreads, D * sizeof(float), stream>>>(
        q, static_cast<const float*>(x), ids, C, D, terms, keys);
    return (int)cudaGetLastError();
  }
  if (x_bf16) {
    return launch_tile<M>(q, static_cast<const __nv_bfloat16*>(x), mean, B, N, D, terms, valid,
                          keys, stream);
  }
  return launch_tile<M>(q, static_cast<const float*>(x), mean, B, N, D, terms, valid, keys, stream);
}

}  // namespace

// q (B, D) f32 query rows (the transform's: cdf for Wasserstein, p for
// Jensen-Shannon); x (N, D) the corpus rows, f32, or with x_bf16 the centred
// bf16 copy and mean (D,) f32 (L1, Chebyshev, Canberra, Bray-Curtis only);
// mass / ent / inv the probability metrics' per-row terms (null otherwise).
// Tile mode (ids null): keys (B, N) over every row, masked by valid. Gather
// mode: keys (B, C) over the rows ids (B, C) int32 (f32 rows only). D may be
// 0 (Wasserstein of a one-column row).
extern "C" int lt_elementwise_scores(const float* q, const void* x, int x_bf16, const float* mean,
                                     const float* q_mass, const float* q_ent,
                                     const uint8_t* q_inv, const float* x_mass,
                                     const float* x_ent, const uint8_t* x_inv,
                                     const uint8_t* valid, const int* ids, int B, int N, int D,
                                     int C, int metric, float* keys, cudaStream_t stream) {
  if (B < 1 || D < 0 || (ids == nullptr ? N < 1 : C < 1) || B > 65535 ||
      (x_bf16 && metric > kBrayCurtis))
    return (int)cudaErrorInvalidValue;
  const RowTerms terms{q_mass, q_ent, q_inv, x_mass, x_ent, x_inv};
  const bool bf = x_bf16 != 0;
  switch (metric) {
    case kL1: return launch<kL1>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case kChebyshev:
      return launch<kChebyshev>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case kCanberra:
      return launch<kCanberra>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case kBrayCurtis:
      return launch<kBrayCurtis>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case kWasserstein:
      return launch<kWasserstein>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case kJensenShannon:
      return launch<kJensenShannon>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case kHaversine: {
      if (D != 2) return (int)cudaErrorInvalidValue;
      const int64_t width = ids ? C : N;
      const dim3 grid((unsigned)((width + 255) / 256), (unsigned)B);
      haversine_kernel<<<grid, 256, 0, stream>>>(q, static_cast<const float*>(x), valid, ids, N,
                                                  C, keys);
      return (int)cudaGetLastError();
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
