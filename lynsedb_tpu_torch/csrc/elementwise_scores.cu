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
// mode). The formulas, with the JAX package's policies (zero-mass, invalid
// and out-of-range rows; IEEE division, logf, sinf, cosf, asinf and sqrtf, no
// flush to zero: Canberra's 1e-45 floor is a denormal), are metrics.cuh's,
// shared with the graph kernels.
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
#include "metrics.cuh"

namespace {

using lt::Acc;

// Per-row terms of the probability metrics (null for the others): a row's
// lt::RowTerm is (mass, 0, inv) for Wasserstein, (ent, mass, inv) for
// Jensen-Shannon.
struct RowTerms {
  const float* q_mass;
  const float* q_ent;
  const uint8_t* q_inv;
  const float* x_mass;
  const float* x_ent;
  const uint8_t* x_inv;

  template <int M>
  __device__ __forceinline__ static lt::RowTerm row(const float* mass, const float* ent,
                                                    const uint8_t* inv, int64_t i) {
    if constexpr (M == lt::kWasserstein) return lt::RowTerm{mass[i], 0.f, inv[i] != 0};
    if constexpr (M == lt::kJensenShannon) return lt::RowTerm{ent[i], mass[i], inv[i] != 0};
    return lt::RowTerm{};
  }

  template <int M>
  __device__ __forceinline__ float distance(int b, int64_t n, Acc acc) const {
    return lt::elem_distance<M>(acc, row<M>(q_mass, q_ent, q_inv, b),
                                row<M>(x_mass, x_ent, x_inv, n));
  }
};

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
  lt::elem_tile_accumulate<M, TQ>(q, x, mean, B, N, D, q0, n0, qs, xs, acc);
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
      for (int d = lane; d < D; d += 32) lt::accumulate<M>(acc, qrow[d], __ldg(xr + d));
      key = lt::to_key(terms.distance<M>(b, n, lt::warp_merge<M>(acc)), true, true);
    }
    if (lane == 0) keys[(int64_t)b * C + c] = key;
  }
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
    key = lt::to_key(lt::haversine(qr.x, qr.y, xr.x, xr.y), true, ids ? true : valid[n] != 0);
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
  if (B < 1 || D < 0 || (ids == nullptr ? N < 1 : C < 1) || B > 65535 || metric < lt::kL1 ||
      (x_bf16 && metric > lt::kBrayCurtis))
    return (int)cudaErrorInvalidValue;
  const RowTerms terms{q_mass, q_ent, q_inv, x_mass, x_ent, x_inv};
  const bool bf = x_bf16 != 0;
  switch (metric) {
    case lt::kL1:
      return launch<lt::kL1>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kChebyshev:
      return launch<lt::kChebyshev>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kCanberra:
      return launch<lt::kCanberra>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kBrayCurtis:
      return launch<lt::kBrayCurtis>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kWasserstein:
      return launch<lt::kWasserstein>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys,
                                      stream);
    case lt::kJensenShannon:
      return launch<lt::kJensenShannon>(q, x, bf, mean, B, N, D, C, terms, valid, ids, keys,
                                        stream);
    case lt::kHaversine: {
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
