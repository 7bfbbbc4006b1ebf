// K19: the exact top L rows of the corpus for a chunk of queries, each query's
// own row and rows >= n_real masked.
//
// Replaces lynsedb_tpu/ops/graph.py _topl_scan (the Vamana build's exact
// candidates, knn_candidates) and _knn_block (exact_knn_graph, the HNSW upper
// layers): a fori_loop of (B, block) matmuls, each followed by a top_k and a
// carried merge.
//
// Under a domain metric (mode 4) it replaces _topl_generic (:815) and
// _knn_block under HNSW-L1, -CHEBYSHEV, -CORRELATION, -HELLINGER,
// -WASSERSTEIN, -JENSEN-SHANNON and -HAVERSINE: the same scan over the
// metric's transform (ops/distance.py), keys -distance with metrics.cuh's
// formulas. Correlation and Hellinger take the FMA tile below over the
// centred or square-rooted rows; the elementwise metrics take K6c's
// accumulation tile (lt::elem_tile_accumulate); Haversine (D = 2) computes each
// pair from the rows.
//
// Bound: the f32 product, 2 * B * N * D flops (true f32 FMA outside the tensor
// cores, as Precision.HIGHEST asks): about 2.6e14 flops for every row of a
// 1M x 128 corpus, some 4 s at 67 TFLOP/s. Under L1 the same pairs cost two
// f32 instructions an element (a subtraction, an add of its absolute value):
// 2.6e14 instructions, some 8 s at 33.5e12 a second; Jensen-Shannon adds a
// logarithm an element (the special-function units); Haversine two sines, two
// cosines, an arcsine and a square root a pair.
//
// Design: a block owns 64 queries and one stripe of corpus rows. It computes
// 64 x 64 key tiles with the tiled FMA of common.cuh and keeps each query's
// running top L (key desc, row id asc) in shared memory: after a tile, one
// warp a query admits only keys above its current L-th best, inserting them in
// row order, so the (chunk, N) key matrix never reaches device memory. Each
// block writes its L best per query; K5 then merges the stripes' lists with
// the row id as the tie-break.
#include "metrics.cuh"

namespace {

constexpr int kTQ = lt::kTile;  // queries a block
constexpr int kTN = lt::kTile;  // rows a tile
constexpr int kThreads = lt::kTileThreads;
constexpr unsigned kFull = 0xffffffffu;

// modes: 0 -(|q|^2 + |x|^2 - 2 q.x); 1 q.x; 2 -max(|q|^2 + |x|^2 - 2 q.x, 0);
// 3 -(cosine distance)
__device__ __forceinline__ float topl_key(float ip, const float* qsq, const float* xsq, int b,
                                          int64_t n, int mode) {
  if (mode == 1) return ip;
  if (mode == 3) return -lt::cosine_distance(ip, sqrtf(qsq[b] * xsq[n]));
  const float d = (qsq[b] + xsq[n]) - 2.f * ip;
  return mode == 0 ? -d : -lt::clamp_nonneg(d);
}

constexpr int kMetricMode = 4;  // -(the distance of `metric`), metrics.cuh

// MET is how a tile's keys are formed: lt::kIP the FMA tile (modes 0-3, and
// mode 4 under correlation and Hellinger), an elementwise metric K6c's
// accumulation tile, lt::kHaversine each pair from its two (lon, lat) rows.
template <int MET>
__global__ void __launch_bounds__(kThreads)
    topl_kernel(const float* __restrict__ q, const int* __restrict__ q_ids,
                const float* __restrict__ x, const float* __restrict__ qsq,
                const float* __restrict__ xsq, const float* __restrict__ qterms,
                const float* __restrict__ xterms, int B, int N, int D, int n_real, int L,
                int stripe, int mode, int metric, float* __restrict__ out_keys,
                int* __restrict__ out_ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lk = reinterpret_cast<float*>(smem);   // [kTQ][L] running best keys
  int* li = reinterpret_cast<int*>(lk + kTQ * L);  // [kTQ][L] their row ids
  float* kt = reinterpret_cast<float*>(li + kTQ * L);  // [kTQ][kTN + 1] the key tile
  __shared__ float qs[lt::kTileK][kTQ + 4];
  __shared__ float xs[lt::kTileK][kTN + 4];
  __shared__ int lcnt[kTQ];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kTQ;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * stripe;
  const int64_t s1 = min(static_cast<int64_t>(N), s0 + stripe);
  if (tid < kTQ) lcnt[tid] = 0;

  for (int64_t n0 = s0; n0 < s1; n0 += kTN) {
    float acc[4][4] = {};
    lt::Acc eacc[4][4];
    if constexpr (MET == lt::kIP) {
      lt::tile_accumulate<kTQ>(q, x, B, s1, D, q0, n0, qs, xs, acc);
    } else if constexpr (MET != lt::kHaversine) {
      lt::elem_tile_accumulate<MET, kTQ>(q, x, static_cast<const float*>(nullptr), B, s1, D, q0,
                                         n0, qs, xs, eacc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i, b = q0 + qi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nj = tx * 4 + j;
        const int64_t n = n0 + nj;
        float key = -INFINITY;
        if (b < B && n < s1) {
          if constexpr (MET == lt::kHaversine) {
            key = -lt::haversine(__ldg(q + 2 * b), __ldg(q + 2 * b + 1), __ldg(x + 2 * n),
                                 __ldg(x + 2 * n + 1));
          } else if constexpr (MET == lt::kIP) {
            key = mode < kMetricMode
                      ? topl_key(acc[i][j], qsq, xsq, b, n, mode)
                      : -lt::gemm_distance(metric, acc[i][j], lt::row_term(qterms, B, b),
                                           lt::row_term(xterms, N, n));
          } else {
            key = -lt::elem_distance<MET>(eacc[i][j], lt::row_term(qterms, B, b),
                                          lt::row_term(xterms, N, n));
          }
          if (isnan(key) || n == q_ids[b] || n >= n_real) key = -INFINITY;
        }
        kt[qi * (kTN + 1) + nj] = key;
      }
    }
    __syncthreads();

    // one warp a query: admit the tile's keys above the L-th best, in row order
    for (int qi = warp; qi < kTQ; qi += kThreads / 32) {
      if (q0 + qi >= B) continue;
      float* K = lk + qi * L;
      int* I = li + qi * L;
      int cnt = lcnt[qi];
      for (int half = 0; half < kTN / 32; ++half) {
        const int nj = half * 32 + lane;
        const float key = kt[qi * (kTN + 1) + nj];
        unsigned m = __ballot_sync(kFull, n0 + nj < s1 && (cnt < L || key > K[L - 1]));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(kFull, key, src);
          if (cnt == L && !(v > K[L - 1])) continue;
          int pos = 0;  // entries with a key >= v stay ahead (they have lower ids)
          for (int p0 = 0; p0 < cnt; p0 += 32) {
            const int p = p0 + lane;
            pos += __popc(__ballot_sync(kFull, p < cnt && K[p] >= v));
          }
          const int end = min(cnt, L - 1);  // [pos, end) moves one down
          for (int top = end; top > pos; top -= 32) {
            const int p = top - 1 - lane;
            const bool mv = p >= pos;
            float kv = 0.f;
            int iv = 0;
            if (mv) {
              kv = K[p];
              iv = I[p];
            }
            __syncwarp();
            if (mv) {
              K[p + 1] = kv;
              I[p + 1] = iv;
            }
            __syncwarp();
          }
          if (lane == 0) {
            K[pos] = v;
            I[pos] = static_cast<int>(n0 + half * 32 + src);
          }
          __syncwarp();
          cnt = min(cnt + 1, L);
        }
      }
      if (lane == 0) lcnt[qi] = cnt;
    }
    __syncthreads();
  }

  const int64_t width = static_cast<int64_t>(gridDim.x) * L;
  for (int e = tid; e < kTQ * L; e += kThreads) {
    const int qi = e / L, p = e % L, b = q0 + qi;
    if (b >= B) continue;
    const bool has = p < lcnt[qi];
    const int64_t at = b * width + static_cast<int64_t>(blockIdx.x) * L + p;
    out_keys[at] = has ? lk[e] : -INFINITY;
    out_ids[at] = has ? li[e] : -1;
  }
}

template <int MET>
int launch(const float* q, const int* q_ids, const float* x, const float* qsq, const float* xsq,
           const float* qterms, const float* xterms, int B, int N, int D, int n_real, int L,
           int stripe, int mode, int metric, float* out_keys, int* out_ids,
           cudaStream_t stream) {
  const unsigned stripes = (unsigned)((N + (int64_t)stripe - 1) / stripe);
  const unsigned qblocks = (unsigned)((B + kTQ - 1) / kTQ);
  if (qblocks > 65535) return (int)cudaErrorInvalidValue;
  const int smem = kTQ * L * 8 + kTQ * (kTN + 1) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(topl_kernel<MET>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  topl_kernel<MET><<<dim3(stripes, qblocks), kThreads, smem, stream>>>(
      q, q_ids, x, qsq, xsq, qterms, xterms, B, N, D, n_real, L, stripe, mode, metric, out_keys,
      out_ids);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, D) and x (N, D) f32 rows (mode 4: the lead rows of the metric's
// transform), q_ids (B,) each query's own row, rows >= n_real masked. Modes
// 0-3 read qsq (B,) and xsq (N,) (not mode 1); mode 4 reads `metric`'s
// per-row terms qterms (3, B) and xterms (3, N), [a; b; inv] (null for L1,
// Chebyshev and Haversine). Writes each stripe's best L (key, id) a query into
// out_keys / out_ids (B, stripes * L), -inf and -1 where a stripe has fewer.
extern "C" int lt_topl_scan(const float* q, const int* q_ids, const float* x, const float* qsq,
                            const float* xsq, const float* qterms, const float* xterms, int B,
                            int N, int D, int n_real, int L, int stripe, int mode, int metric,
                            float* out_keys, int* out_ids, cudaStream_t stream) {
  if (B < 1 || N < 1 || D < 1 || L < 1 || stripe < kTN || stripe % kTN || mode < 0 ||
      mode > kMetricMode)
    return (int)cudaErrorInvalidValue;
#define LT_TOPL(MET)                                                                          \
  launch<MET>(q, q_ids, x, qsq, xsq, qterms, xterms, B, N, D, n_real, L, stripe, mode, metric, \
              out_keys, out_ids, stream)
  if (mode < kMetricMode) return LT_TOPL(lt::kIP);
  switch (metric) {
    case lt::kCorrelation:
    case lt::kHellinger: return LT_TOPL(lt::kIP);
    case lt::kL1: return LT_TOPL(lt::kL1);
    case lt::kChebyshev: return LT_TOPL(lt::kChebyshev);
    case lt::kWasserstein: return LT_TOPL(lt::kWasserstein);
    case lt::kJensenShannon: return LT_TOPL(lt::kJensenShannon);
    case lt::kHaversine: return D == 2 ? LT_TOPL(lt::kHaversine) : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LT_TOPL
}
