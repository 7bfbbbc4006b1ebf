// K1: exact f32 scores of a query block against the f32 corpus copy, with the
// IP / L2 / cosine epilogue, orientation and masking fused; K5 then selects.
// K6a: the same tile product over a metric's transformed rows with the
// correlation and Hellinger epilogues, and a gather mode over explicit rows.
//
// Replaces lynsedb_tpu/ops/scan.py flat_topk / flat_search_step through
// ops/distance.py pairwise (_pw_ip, _pw_l2, _pw_cosine; K6a: _pw_correlation
// :149 over the centred rows, _pw_hellinger :163 over the square-rooted rows;
// the gather mode replaces scan.py rescore_rows :744 for these metrics), which
// run at Precision.HIGHEST: the path must stay true f32, so no TF32 and no
// tensor cores.
//
// Bound: f32 FMA throughput outside the tensor cores (2 * B * N * D flops;
// about 67 TFLOP/s on an H100 SXM at 700 W) once B reaches a few dozen; below
// that, the read of the (N, D) corpus and the (B, N) key write. The gather
// mode reads C rows a query at random: bytes.
// Design: the shared tile product of common.cuh (64 x 64 outputs a block,
// 4 x 4 a thread, 16-deep shared-memory stages) with an epilogue that forms
// the metric from the dot product and the per-row terms and writes the
// oriented key, -inf for masked rows and NaN, so K5 can select without another
// pass. The gather mode gives each (query, slot) a warp, as K11 does.
#include "metrics.cuh"

namespace {

// The five GEMM-family distances from the dot product of the transformed rows
// and two per-row terms a side (a, b) plus an invalid flag, in the JAX
// package's operation order:
//   IP           dot                     (a, b unused)
//   L2           max(a_q + a_x - 2 dot, 0)            a = |x|^2
//   cosine       1 - dot / sqrt(a_q a_x), 1.0 below 1e-30
//   correlation, Hellinger: lt::gemm_distance (metrics.cuh), a and b the
//                transform's per-row terms, inv Hellinger's invalid rows
struct MetricTerms {
  const float* qa;
  const float* qb;
  const uint8_t* qinv;
  const float* xa;
  const float* xb;
  const uint8_t* xinv;
  int metric;

  __device__ __forceinline__ static lt::RowTerm row(const float* a, const float* b,
                                                    const uint8_t* inv, int64_t i) {
    return lt::RowTerm{a[i], b ? b[i] : 0.f, inv ? inv[i] != 0 : false};
  }

  __device__ __forceinline__ float score(int b, int64_t n, float dot) const {
    if (metric == lt::kIP) return dot;
    if (metric == lt::kL2) return lt::clamp_nonneg(qa[b] + xa[n] - 2.f * dot);
    if (metric == lt::kCosine) return lt::cosine_distance(dot, sqrtf(qa[b] * xa[n]));
    return lt::gemm_distance(metric, dot, row(qa, qb, qinv, b), row(xa, xb, xinv, n));
  }
};

struct MetricEpilogue {
  MetricTerms terms;
  const uint8_t* valid;  // (N,) 1 = live row
  bool ascending;

  __device__ __forceinline__ float operator()(int b, int64_t n, float dot) const {
    return lt::to_key(terms.score(b, n, dot), ascending, valid[n] != 0);
  }
};

constexpr int kGatherThreads = 256;
constexpr int kGatherSlots = 64;  // slots a block

// keys[b, c] for the row ids[b, c] (a negative id: an empty slot, -inf): one
// block per (query, 64 slots), a warp per slot, the query in shared memory.
__global__ void __launch_bounds__(kGatherThreads)
    metric_gather_kernel(const float* __restrict__ q, const float* __restrict__ x,
                         const int* __restrict__ ids, int C, int D, MetricTerms terms,
                         bool ascending, float* __restrict__ keys) {
  extern __shared__ __align__(16) float qs[];
  const int b = blockIdx.y;
  for (int d = threadIdx.x; d < D; d += kGatherThreads) qs[d] = q[(int64_t)b * D + d];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_end = min(C, ((int)blockIdx.x + 1) * kGatherSlots);
  for (int c = (int)blockIdx.x * kGatherSlots + warp; c < c_end; c += kGatherThreads / 32) {
    const int n = ids[(int64_t)b * C + c];
    float key = -INFINITY;
    if (n >= 0) {  // the same for the whole warp
      const float* xr = x + (int64_t)n * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc = fmaf(__ldg(xr + d), qs[d], acc);
      acc = lt::warp_sum(acc);
      key = lt::to_key(terms.score(b, n, acc), ascending, true);
    }
    if (lane == 0) keys[(int64_t)b * C + c] = key;
  }
}

}  // namespace

// K1 (IP, L2, cosine) and K6a (correlation, Hellinger). q (B, D) and x (N, D)
// the transformed rows (the rows; xc for correlation, their square roots for
// Hellinger), the per-row terms as MetricTerms. Tile mode (ids null): keys
// (B, N) over every row, masked by valid. Gather mode: keys (B, C) over the
// rows ids (B, C) int32.
extern "C" int lt_gemm_metric_scores(const float* q, const float* x, const float* qa,
                                     const float* qb, const uint8_t* qinv, const float* xa,
                                     const float* xb, const uint8_t* xinv, const uint8_t* valid,
                                     const int* ids, int B, int N, int D, int C, int metric,
                                     int ascending, float* keys, cudaStream_t stream) {
  if (B < 1 || D < 1 || metric < lt::kIP || metric > lt::kHellinger)
    return (int)cudaErrorInvalidValue;
  const MetricTerms terms{qa, qb, qinv, xa, xb, xinv, metric};
  if (ids == nullptr) {
    if (N < 1 || B > 65535 * lt::kTile) return (int)cudaErrorInvalidValue;
    const MetricEpilogue epi{terms, valid, ascending != 0};
    return lt::launch_tile_scores(q, x, B, N, D, epi, keys, stream);
  }
  if (C < 1 || B > 65535 || (size_t)D * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kGatherSlots - 1) / kGatherSlots), (unsigned)B);
  metric_gather_kernel<<<grid, kGatherThreads, D * sizeof(float), stream>>>(
      q, x, ids, C, D, terms, ascending != 0, keys);
  return (int)cudaGetLastError();
}
