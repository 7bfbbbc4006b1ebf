// K20: the alpha robust prune of a node chunk, one block a node; or, in its
// keys mode, only the keys the host prune reads.
//
// Replaces lynsedb_tpu/ops/graph.py _prune_chunk_kernel (the gather, the point
// and pair keys in f32 and _robust_prune_dev's fori_loop over ranks) and
// candidate_pair_keys (the (BS, L, L) keys of _link_points_batch,
// _reprune_nodes and repair_deleted_edges), under IP, L2 and cosine and, over
// the lead rows and per-row terms of a metric's transform, under the graph
// indexes' domain metrics (_keyed_pairwise, :99; metrics.cuh's formulas).
//
// Bound: the gathers, (L + 1) rows of D f32 a node (53 KB at L = 104, D = 128),
// some 106 GB for the two passes of a 1M-row build, about 32 ms at 3.35 TB/s;
// the table's (L + 1)^2 * D multiply-adds (or elementwise terms) read shared
// memory twice each, a few tenths of a second a pass. Both are small beside
// K19's scan.
//
// Design: the block stages its rows 32 dimensions at a time and accumulates the
// (L + 1) x (L + 1) pair table (the node's row last) in shared memory, every
// entry a sequential chain of separately rounded operations over the
// dimensions, so the plain version in ops/graph.py forms bit-identical keys:
// the Gram of dot products for IP, L2, cosine, correlation and Hellinger (the
// norm terms from its diagonal), the elementwise sum or max of L1, Chebyshev,
// Wasserstein and Jensen-Shannon, Haversine's distance itself (D = 2). The
// keys follow from the table and the rows' terms. The ranks are a stable
// descending sort of the point keys (the lower index first between equal
// keys, as JAX's argsort gives them); then one warp walks them: a candidate is kept while it is not pruned and fewer than r
// are kept, and each kept one prunes every candidate it dominates
// (point < alpha * pair for ascending metrics, point < pair - ln(alpha) for
// inner product).
#include "metrics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDC = 32;  // dimensions staged a pass

using lt::pairwise_key;

// MET is how the table is filled: lt::kIP the Gram (IP, L2, cosine,
// correlation, Hellinger), an elementwise metric its accumulation,
// lt::kHaversine each pair's distance. terms (3, N) [a; b; inv] are the
// domain metrics' per-row terms (null for L1, Chebyshev and Haversine).
template <int MET>
__global__ void __launch_bounds__(kThreads)
    prune_kernel(const float* __restrict__ x, int N, int D, const float* __restrict__ terms,
                 const int* __restrict__ node_ids, const int* __restrict__ cand_ids, int L,
                 int metric, int r, float alpha, float ln_alpha, int descending, int keys_only,
                 int* __restrict__ out, float* __restrict__ point_out,
                 float* __restrict__ pair_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = L + (node_ids ? 1 : 0);  // table rows: the candidates, then the node
  float* g = reinterpret_cast<float*>(smem);  // [M][M]
  float* rows = g + M * M;                    // [M][kDC + 1]
  int* ids = reinterpret_cast<int*>(rows + M * (kDC + 1));  // [M]
  float* ta = reinterpret_cast<float*>(ids + M);            // [3][M] the rows' terms
  float* pk = ta + 3 * M;                                   // [L] point keys
  int* order = reinterpret_cast<int*>(pk + L);              // [L]
  uint8_t* pruned = reinterpret_cast<uint8_t*>(order + L);  // [L]
  const int64_t bs = blockIdx.x;
  const int tid = threadIdx.x;
  const int* cand = cand_ids + bs * L;
  const int node = node_ids ? node_ids[bs] : -1;
  for (int i = tid; i < M; i += kThreads) {
    const int id = min(max(i < L ? cand[i] : node, 0), N - 1);
    ids[i] = id;
    const lt::RowTerm t = lt::row_term(terms, N, id);
    ta[i] = t.a;
    ta[M + i] = t.b;
    ta[2 * M + i] = t.inv ? 1.f : 0.f;
  }
  for (int p = tid; p < M * M; p += kThreads) g[p] = 0.f;
  __syncthreads();
  for (int d0 = 0; d0 < D; d0 += kDC) {
    const int dn = min(kDC, D - d0);
    for (int e = tid; e < M * kDC; e += kThreads) {
      const int i = e / kDC, c = e % kDC;
      rows[i * (kDC + 1) + c] = c < dn ? __ldg(x + static_cast<int64_t>(ids[i]) * D + d0 + c) : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < M * M; p += kThreads) {
      const float* a = rows + (p / M) * (kDC + 1);
      const float* b = rows + (p % M) * (kDC + 1);
      if constexpr (MET == lt::kIP) {
        float acc = g[p];
        for (int c = 0; c < dn; ++c) acc = __fadd_rn(acc, __fmul_rn(a[c], b[c]));
        g[p] = acc;
      } else if constexpr (MET == lt::kHaversine) {
        g[p] = lt::haversine(a[0], a[1], b[0], b[1]);  // D = 2: one pass
      } else {
        lt::Acc acc{g[p], 0.f};
        for (int c = 0; c < dn; ++c) lt::accumulate<MET>(acc, a[c], b[c]);
        g[p] = acc.a;
      }
    }
    __syncthreads();
  }
  // key(i, j) of row i (the query side) against row j, from the table
  auto key = [&](int i, int j) -> float {
    const float v = g[i * M + j];
    if constexpr (MET == lt::kHaversine) {
      return -v;
    } else {
      const lt::RowTerm qi{ta[i], ta[M + i], ta[2 * M + i] != 0.f};
      const lt::RowTerm xj{ta[j], ta[M + j], ta[2 * M + j] != 0.f};
      if constexpr (MET == lt::kIP) {
        return metric <= lt::kCosine ? pairwise_key(v, g[i * M + i], g[j * M + j], metric)
                                     : -lt::gemm_distance(metric, v, qi, xj);
      } else {
        return -lt::elem_distance<MET>(lt::Acc{v, 0.f}, qi, xj);
      }
    }
  };

  if (keys_only) {
    for (int p = tid; p < L * L; p += kThreads) {
      const int i = p / L, j = p % L;
      pair_out[bs * L * L + p] = key(i, j);
    }
    if (node_ids)
      for (int j = tid; j < L; j += kThreads)
        point_out[bs * L + j] = key(L, j);
    return;
  }

  for (int j = tid; j < L; j += kThreads) {
    const bool bad = cand[j] < 0 || cand[j] == node;
    float v = bad ? -INFINITY : key(L, j);
    pruned[j] = bad || !isfinite(v);
    pk[j] = isnan(v) ? -INFINITY : v;
  }
  __syncthreads();
  for (int j = tid; j < L; j += kThreads) {  // a stable descending sort: ranks
    const float v = pk[j];
    int rank = 0;
    for (int u = 0; u < L; ++u) rank += pk[u] > v || (pk[u] == v && u < j);
    order[rank] = j;
  }
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    int* o = out + bs * r;
    int kept = 0;
    for (int rank = 0; rank < L; ++rank) {
      const int idx = order[rank];
      if (pruned[idx] || kept >= r) continue;
      if (lane == 0) o[kept] = cand[idx];
      ++kept;
      for (int j = lane; j < L; j += 32) {
        const float pair = key(idx, j);
        const bool dom = descending ? pk[j] < __fsub_rn(pair, ln_alpha)
                                    : pk[j] < __fmul_rn(alpha, pair);
        if (dom || j == idx) pruned[j] = 1;
      }
      __syncwarp();
    }
    for (int s = kept + lane; s < r; s += 32) o[s] = -1;
  }
}

template <int MET>
int launch(const float* x, int N, int D, const float* terms, const int* node_ids,
           const int* cand_ids, int BS, int L, int metric, int r, float alpha, float ln_alpha,
           int descending, int keys_only, int* out, float* point_out, float* pair_out, int smem,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(prune_kernel<MET>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  prune_kernel<MET><<<BS, kThreads, smem, stream>>>(x, N, D, terms, node_ids, cand_ids, L,
                                                    metric, r, alpha, ln_alpha, descending,
                                                    keys_only, out, point_out, pair_out);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, D) f32 rows (under a domain metric the lead rows of its transform),
// terms (3, N) its per-row terms or null; node_ids (BS,) and cand_ids (BS, L)
// int32; metric IP / L2 / cosine (0-2) or a domain metric's lt code. Prune
// mode: out (BS, r) int32. Keys mode: pair_out (BS, L, L) and, with node ids,
// point_out (BS, L).
extern "C" int lt_robust_prune(const float* x, int N, int D, const float* terms,
                               const int* node_ids, const int* cand_ids, int BS, int L,
                               int metric, int r, float alpha, float ln_alpha, int descending,
                               int keys_only, int* out, float* point_out, float* pair_out,
                               cudaStream_t stream) {
  if (N < 1 || D < 1 || BS < 1 || L < 1 || (!keys_only && (r < 1 || !node_ids || !out)) ||
      (keys_only && !pair_out) || (keys_only && node_ids && !point_out))
    return (int)cudaErrorInvalidValue;
  const int M = L + (node_ids ? 1 : 0);
  const int smem = M * M * 4 + M * (kDC + 1) * 4 + M * 4 + 3 * M * 4 + L * 9;
#define LT_PRUNE(MET)                                                                        \
  launch<MET>(x, N, D, terms, node_ids, cand_ids, BS, L, metric, r, alpha, ln_alpha,         \
              descending, keys_only, out, point_out, pair_out, smem, stream)
  switch (metric) {
    case lt::kIP:
    case lt::kL2:
    case lt::kCosine:
    case lt::kCorrelation:
    case lt::kHellinger: return LT_PRUNE(lt::kIP);
    case lt::kL1: return LT_PRUNE(lt::kL1);
    case lt::kChebyshev: return LT_PRUNE(lt::kChebyshev);
    case lt::kWasserstein: return LT_PRUNE(lt::kWasserstein);
    case lt::kJensenShannon: return LT_PRUNE(lt::kJensenShannon);
    case lt::kHaversine: return D == 2 ? LT_PRUNE(lt::kHaversine) : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LT_PRUNE
}
