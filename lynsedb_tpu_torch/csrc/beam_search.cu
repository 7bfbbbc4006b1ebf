// K17: the batched best-first graph walk, one block a query, the whole walk
// in one launch.
//
// Replaces lynsedb_tpu/ops/graph.py _beam_core and its four guidance tiers
// (_beam_search_jit: exact f32; _beam_search_bf16_jit: the centred bf16 copy
// with K2's rank-1 terms; _beam_search_sq8_jit: SQ8 codes; _beam_search_pq_jit:
// a per-query PQ table). A fifth tier, the metric tier, is _beam_search_jit
// under a domain metric (_keyed_pairwise, :99): it walks the lead rows of the
// metric's transform (ops/distance.py; the transform is row-wise, so a row's
// key is JAX's per-gathered-row key) and forms the exact distance with
// metrics.cuh's formulas. On the TPU every step was a lockstep dispatch over the
// batch with a (B, N) bool visited array; here each block runs its query's
// while_loop to the end, so the host never waits on a step.
//
// Bound: the bytes the walk gathers, steps x R x (row bytes + adjacency and
// aux bytes) a query, are a few MB a batch; the walk is bounded by latency:
// each step is a chain of dependent gathers (the pool entry, its adjacency
// row, the visited words, the neighbours' rows), and only a batch of queries
// in flight hides it.
//
// Design:
//   * the pool (keys, ids, expanded flags) lives in shared memory, sorted best
//     first, in two buffers: a merge writes the other one;
//   * a step takes the first `expand` unexpanded entries (warp 0 scans from a
//     cursor: every entry before it is expanded), gathers their R neighbours,
//     drops those already visited (a (B, ceil(N/32)) bitmap in device memory,
//     read through L2 because atomics set it), marks the rest visited, scores
//     the valid ones (one warp a node) and sorts them by rank;
//   * the merge keeps lax.top_k's tie order over concat(pool, fresh): a pool
//     entry before a fresh one, and fresh ones by neighbour slot; an invalid
//     fresh node keeps -inf and never enters, which is how a filter prunes the
//     walk;
//   * the starts enter as chunks merged the same way, -inf ones included, so
//     the pool begins as the best min(S, beam) starts;
//   * every dot product (and every sum or max of the metric tier) is a chain
//     of separately rounded operations, lane l of a warp taking elements l,
//     l + 32, ... then a butterfly, so the plain version in ops/graph.py
//     computes bit-identical keys.
#include "metrics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  // (B, qw) per-query operand: q, bf16(q - mean), q * scale or the PQ table;
  // the metric tier's: the query's lead row (rw values), then its a, b, inv
  const float* q;
  int qw;
  const float* qconst;  // (B,): |q|^2 (f32), q . mean (bf16), q . (lo + 128 scale) (SQ8)
  const void* rows;     // (N, rw): f32 / bf16 / int8 / uint8 PQ codes
  int rw;
  const float* aux0;  // bf16: xm; SQ8: row_sq; PQ: alpha; metric: a (or null)
  const float* aux1;  // bf16: xc_sq; SQ8: rsqrt(row_sq); PQ: row_sq; metric: b
  const float* aux2;  // bf16: rsqrt(xsq_true); PQ: rsqrt(row_sq); metric: inv (1 or 0)
  const int* graph;   // (N, R), -1 padded
  int n, r;
  const int* starts;  // (S,) shared or (B, S)
  int s, starts_stride;
  const uint8_t* valid;  // (>= N,)
  int beam, max_steps, expand, fresh;
  int metric;  // IP / L2 / cosine (0-2) in tiers 0-3, a domain metric's lt code in tier 4
  uint32_t* visited;  // (B, words), zeroed
  int words;
  float* out_keys;  // (B, beam)
  int* out_ids;     // (B, beam)
  int* scanned;     // (B,)
};

__device__ __forceinline__ float lane_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int TIER>
__device__ __forceinline__ float row_value(const void* rows, int64_t i) {
  if constexpr (TIER == 0) return __ldg(static_cast<const float*>(rows) + i);
  if constexpr (TIER == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(rows)[i]);
  return static_cast<float>(static_cast<const int8_t*>(rows)[i]);
}

// The metric tier's key of node `id`: -distance under the domain metric M,
// from the query's lead row qv[0, rw) and terms qv[rw, rw + 3) and the node's
// lead row and terms. Called by a whole warp, the result on every lane.
template <int M>
__device__ float metric_key(const Args& a, const float* qv, int64_t id, int lane) {
  const float* xr = static_cast<const float*>(a.rows) + id * a.rw;
  if constexpr (M == lt::kHaversine) {
    return -lt::haversine(qv[0], qv[1], __ldg(xr), __ldg(xr + 1));
  } else {
    const lt::RowTerm qt{qv[a.rw], qv[a.rw + 1], qv[a.rw + 2] != 0.f};
    const lt::RowTerm xt = a.aux0 == nullptr ? lt::RowTerm{}
                                             : lt::RowTerm{__ldg(a.aux0 + id), __ldg(a.aux1 + id),
                                                           __ldg(a.aux2 + id) != 0.f};
    if constexpr (M == lt::kCorrelation || M == lt::kHellinger) {
      float ip = 0.f;
      for (int d = lane; d < a.rw; d += 32) ip = __fadd_rn(ip, __fmul_rn(qv[d], __ldg(xr + d)));
      return -lt::gemm_distance(M, lane_reduce(ip), qt, xt);
    } else {
      lt::Acc acc;
      for (int d = lane; d < a.rw; d += 32) lt::accumulate<M>(acc, qv[d], __ldg(xr + d));
      return -lt::elem_distance<M>(lt::warp_merge<M>(acc), qt, xt);
    }
  }
}

// The oriented key of node `id` for this block's query; called by a whole warp,
// the result on every lane. NaN becomes -inf.
template <int TIER>
__device__ float node_key(const Args& a, const float* qv, float qc, int64_t id, int lane) {
  float key;
  if constexpr (TIER == 4) {
    switch (a.metric) {
      case lt::kCorrelation: key = metric_key<lt::kCorrelation>(a, qv, id, lane); break;
      case lt::kHellinger: key = metric_key<lt::kHellinger>(a, qv, id, lane); break;
      case lt::kL1: key = metric_key<lt::kL1>(a, qv, id, lane); break;
      case lt::kChebyshev: key = metric_key<lt::kChebyshev>(a, qv, id, lane); break;
      case lt::kWasserstein: key = metric_key<lt::kWasserstein>(a, qv, id, lane); break;
      case lt::kJensenShannon: key = metric_key<lt::kJensenShannon>(a, qv, id, lane); break;
      default: key = metric_key<lt::kHaversine>(a, qv, id, lane); break;
    }
  } else if constexpr (TIER == 3) {
    const uint8_t* code = static_cast<const uint8_t*>(a.rows) + id * a.rw;
    float acc = 0.f;
    for (int m = lane; m < a.rw; m += 32) acc = __fadd_rn(acc, qv[m * 256 + code[m]]);
    const float ip = __fmul_rn(__ldg(a.aux0 + id), lane_reduce(acc));
    key = a.metric == 0 ? ip
          : a.metric == 1 ? __fsub_rn(__fmul_rn(2.f, ip), __ldg(a.aux1 + id))
                          : __fmul_rn(ip, __ldg(a.aux2 + id));
  } else {
    const int64_t base = id * a.rw;
    float ip = 0.f, xs = 0.f;
    for (int d = lane; d < a.rw; d += 32) {
      const float v = row_value<TIER>(a.rows, base + d);
      ip = __fadd_rn(ip, __fmul_rn(qv[d], v));
      if constexpr (TIER == 0) xs = __fadd_rn(xs, __fmul_rn(v, v));
    }
    ip = lane_reduce(ip);
    if constexpr (TIER == 0) {
      key = lt::pairwise_key(ip, qc, lane_reduce(xs), a.metric);
    } else if constexpr (TIER == 1) {
      key = a.metric == 0 ? __fadd_rn(ip, __ldg(a.aux0 + id))
            : a.metric == 1
                ? __fsub_rn(__fmul_rn(2.f, ip), __ldg(a.aux1 + id))
                : __fmul_rn(__fadd_rn(__fadd_rn(ip, __ldg(a.aux0 + id)), qc), __ldg(a.aux2 + id));
    } else {
      key = a.metric == 0   ? ip
            : a.metric == 1 ? __fsub_rn(__fmul_rn(2.f, ip), __ldg(a.aux0 + id))
                            : __fmul_rn(__fadd_rn(ip, qc), __ldg(a.aux1 + id));
    }
  }
  return isnan(key) ? -INFINITY : key;
}

// Sorts the m slots (fk, fi) whose key passes `use` (all of them when
// finite_only is false, else the finite ones) into (sk, si), best first, the
// lower slot first between equal keys. Returns how many were sorted.
__device__ int rank_sort(const float* fk, const int* fi, int m, bool finite_only, float* sk,
                         int* si) {
  int f = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int t = base + threadIdx.x;
    f += __syncthreads_count(t < m && (!finite_only || fk[t] > -INFINITY));
  }
  for (int t = threadIdx.x; t < m; t += kThreads) {
    const float kt = fk[t];
    if (finite_only && !(kt > -INFINITY)) continue;
    int rank = 0;
    for (int u = 0; u < m; ++u) {
      const float ku = fk[u];
      rank += (!finite_only || ku > -INFINITY) && (ku > kt || (ku == kt && u < t));
    }
    sk[rank] = kt;
    si[rank] = fi[t];
  }
  return f;
}

// Merges the sorted pool (pk, pi, pe; cnt entries) with the f sorted new
// entries (sk, si) into the other buffer, keeping the best `beam`: a pool
// entry goes before a new one with an equal key. *cursor receives the lowest
// new position of the pool entry at `cur` and of every new entry.
__device__ void merge(const float* pk, const int* pi, const uint8_t* pe, int cnt, const float* sk,
                      const int* si, int f, int beam, float* ok, int* oi, uint8_t* oe, int cur,
                      int* cursor) {
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const float v = pk[i];
    int lo = 0, hi = f;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sk[mid] > v) lo = mid + 1; else hi = mid;
    }
    const int np = i + lo;
    if (np < beam) {
      ok[np] = v;
      oi[np] = pi[i];
      oe[np] = pe[i];
      if (i == cur) atomicMin(cursor, np);
    }
  }
  for (int j = threadIdx.x; j < f; j += kThreads) {
    const float v = sk[j];
    int lo = 0, hi = cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pk[mid] >= v) lo = mid + 1; else hi = mid;
    }
    const int np = j + lo;
    if (np < beam) {
      ok[np] = v;
      oi[np] = si[j];
      oe[np] = 0;
      atomicMin(cursor, np);
    }
  }
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

template <int TIER>
__global__ void __launch_bounds__(kThreads) beam_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int beam = a.beam, F = a.fresh;
  float* pk[2];
  int* pi[2];
  uint8_t* pe[2];
  pk[0] = reinterpret_cast<float*>(smem);
  pk[1] = pk[0] + beam;
  pi[0] = reinterpret_cast<int*>(pk[1] + beam);
  pi[1] = pi[0] + beam;
  pe[0] = reinterpret_cast<uint8_t*>(pi[1] + beam);
  pe[1] = pe[0] + beam;
  float* fk = reinterpret_cast<float*>(smem + round16(18 * beam));
  int* fi = reinterpret_cast<int*>(fk + F);
  float* sk = reinterpret_cast<float*>(fi + F);
  int* si = reinterpret_cast<int*>(sk + F);
  uint8_t* ff = reinterpret_cast<uint8_t*>(si + F);
  uint8_t* fd = ff + F;
  float* qv = reinterpret_cast<float*>(smem + round16(18 * beam) + round16(19 * F));
  int* ctl = reinterpret_cast<int*>(qv + a.qw);  // [0] found, [1] cursor, [4] merge cursor,
  int* chosen = ctl + 16;                        // [8..15] warp sums; then the chosen slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bq = blockIdx.x;
  for (int i = tid; i < a.qw; i += kThreads) qv[i] = a.q[bq * a.qw + i];
  const float qc = a.qconst ? a.qconst[bq] : 0.f;
  uint32_t* vis = a.visited + bq * a.words;
  const int* st = a.starts + bq * a.starts_stride;
  int cb = 0, cnt = 0, cur = 0;
  __syncthreads();

  // the pool starts as the best min(S, beam) starts, -inf ones included
  for (int c0 = 0; c0 < a.s; c0 += F) {
    const int m = min(F, a.s - c0);
    for (int j = warp; j < m; j += kWarps) {
      const int id = st[c0 + j];
      const bool in = id >= 0 && id < a.n;
      float key = -INFINITY;
      if (in && a.valid[id]) key = node_key<TIER>(a, qv, qc, id, lane);
      if (lane == 0) {
        fk[j] = key;
        fi[j] = in ? id : -1;
      }
    }
    __syncthreads();
    rank_sort(fk, fi, m, false, sk, si);
    if (tid == 0) ctl[4] = beam;
    __syncthreads();
    merge(pk[cb], pi[cb], pe[cb], cnt, sk, si, m, beam, pk[1 - cb], pi[1 - cb], pe[1 - cb], -1,
          &ctl[4]);
    __syncthreads();
    cb = 1 - cb;
    cnt = min(beam, cnt + m);
  }
  for (int i = tid; i < cnt; i += kThreads) {
    const int id = pi[cb][i];
    if (id >= 0) atomicOr(&vis[id >> 5], 1u << (id & 31));
  }

  const int E = a.expand, R = a.r, ER = E * R;
  for (int step = 0; step < a.max_steps; ++step) {
    // the first E unexpanded entries with a finite key, from the cursor on
    if (warp == 0) {
      int found = 0, first = -1;
      for (int base = cur; base < cnt; base += 32) {
        const int p = base + lane;
        const bool in = p < cnt;
        const float kp = in ? pk[cb][p] : -INFINITY;
        const bool unexp = in && !pe[cb][p];
        const unsigned mu = __ballot_sync(kFull, unexp);
        unsigned mw = __ballot_sync(kFull, unexp && kp > -INFINITY);
        const unsigned mend = __ballot_sync(kFull, in && !(kp > -INFINITY));
        if (first < 0 && mu) first = base + __ffs(mu) - 1;
        while (mw && found < E) {
          const int bit = __ffs(mw) - 1;
          mw &= mw - 1;
          if (lane == 0) chosen[found] = base + bit;
          ++found;
        }
        if (found >= E || mend) break;
      }
      if (lane == 0) {
        ctl[0] = found;
        ctl[1] = first < 0 ? cnt : first;
      }
    }
    __syncthreads();
    const int found = ctl[0];
    cur = ctl[1];
    if (found == 0) break;
    if (tid < found) pe[cb][chosen[tid]] = 1;

    // the chosen nodes' neighbours; fresh = in range and not yet visited
    for (int t = tid; t < ER; t += kThreads) {
      const int e = t / R;
      int nb = -1;
      bool fr = false;
      if (e < found) {
        nb = a.graph[static_cast<int64_t>(pi[cb][chosen[e]]) * R + (t - e * R)];
        if (nb >= 0 && nb < a.n) fr = !((__ldcg(&vis[nb >> 5]) >> (nb & 31)) & 1u);
      }
      fi[t] = nb;
      ff[t] = fr;
    }
    __syncthreads();
    if (E > 1) {  // two parents may share a neighbour: keep its first slot
      for (int t = tid; t < ER; t += kThreads) {
        bool dup = false;
        if (ff[t])
          for (int u = 0; u < t && !dup; ++u) dup = ff[u] && fi[u] == fi[t];
        fd[t] = dup;
      }
      __syncthreads();
      for (int t = tid; t < ER; t += kThreads)
        if (fd[t]) ff[t] = 0;
      __syncthreads();
    }
    for (int t = tid; t < ER; t += kThreads)
      if (ff[t]) atomicOr(&vis[fi[t] >> 5], 1u << (fi[t] & 31));
    for (int t = warp; t < ER; t += kWarps) {
      float key = -INFINITY;
      if (ff[t] && a.valid[fi[t]]) key = node_key<TIER>(a, qv, qc, fi[t], lane);
      if (lane == 0) fk[t] = key;
    }
    __syncthreads();
    const int f = rank_sort(fk, fi, ER, true, sk, si);
    if (tid == 0) ctl[4] = beam;
    __syncthreads();
    if (f) {
      merge(pk[cb], pi[cb], pe[cb], cnt, sk, si, f, beam, pk[1 - cb], pi[1 - cb], pe[1 - cb], cur,
            &ctl[4]);
      __syncthreads();
      cb = 1 - cb;
      cnt = min(beam, cnt + f);
      cur = min(ctl[4], cnt);
    }
    __syncthreads();
  }

  for (int i = tid; i < beam; i += kThreads) {
    const float key = i < cnt ? pk[cb][i] : -INFINITY;
    a.out_keys[bq * beam + i] = key;
    a.out_ids[bq * beam + i] = key > -INFINITY ? pi[cb][i] : -1;
  }
  __syncthreads();  // the bitmap's atomics are visible to the whole block
  int seen = 0;
  for (int w = tid; w < a.words; w += kThreads) seen += __popc(__ldcg(&vis[w]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) seen += __shfl_xor_sync(kFull, seen, o);
  if (lane == 0) ctl[8 + warp] = seen;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += ctl[8 + w];
    a.scanned[bq] = total;
  }
}

template <int TIER>
int launch(const Args& a, int b, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(beam_kernel<TIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<TIER><<<b, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lt_beam_search(int tier, const float* q, int qw, const float* qconst,
                              const void* rows, int rw, const float* aux0, const float* aux1,
                              const float* aux2, const int* graph, int n, int r,
                              const int* starts, int s, int starts_stride, const uint8_t* valid,
                              int b, int beam, int max_steps, int expand, int metric, int fresh,
                              uint32_t* visited, int words, float* out_keys, int* out_ids,
                              int* scanned, int smem, cudaStream_t stream) {
  // the metric tier serves the graph indexes' domain metrics (not Canberra or
  // Bray-Curtis: the reference keeps those exact-only)
  const bool domain = metric == lt::kCorrelation || metric == lt::kHellinger ||
                      metric == lt::kL1 || metric == lt::kChebyshev ||
                      metric == lt::kWasserstein || metric == lt::kJensenShannon ||
                      (metric == lt::kHaversine && rw == 2);
  if (b < 1 || n < 1 || r < 1 || s < 1 || beam < 1 || expand < 1 || fresh < expand * r ||
      qw < 1 || rw < 1 || words < (n + 31) / 32 || (tier == 4 && (qw != rw + 3 || !domain)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.qw = qw;
  a.qconst = qconst;
  a.rows = rows;
  a.rw = rw;
  a.aux0 = aux0;
  a.aux1 = aux1;
  a.aux2 = aux2;
  a.graph = graph;
  a.n = n;
  a.r = r;
  a.starts = starts;
  a.s = s;
  a.starts_stride = starts_stride;
  a.valid = valid;
  a.beam = beam;
  a.max_steps = max_steps;
  a.expand = expand;
  a.metric = metric;
  a.fresh = fresh;
  a.visited = visited;
  a.words = words;
  a.out_keys = out_keys;
  a.out_ids = out_ids;
  a.scanned = scanned;
  switch (tier) {
    case 0: return launch<0>(a, b, smem, stream);
    case 1: return launch<1>(a, b, smem, stream);
    case 2: return launch<2>(a, b, smem, stream);
    case 3: return launch<3>(a, b, smem, stream);
    case 4: return launch<4>(a, b, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
