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
// Bound: latency, not bytes (a few MB a batch). A step waits for two
// dependent global reads, the expanded node's adjacency row and then its
// fresh neighbours' rows, so a walk takes at least its steps x two load
// latencies (tools/roofline.py walk_bound); only a batch of queries in flight
// hides it. On an H100 the on-chip work of a step (one warp's dependent
// instructions, the barriers) costs as much as those reads, so the design
// takes it off the critical path.
//
// Design (each point measured with tools/beam_phases.py's step clocks):
//   * the pool (keys, ids, expanded flags) lives in shared memory, sorted best
//     first, in two buffers reached by offsets: a merge writes the other one;
//   * the visited set is an exact open-addressing hash set of node ids in
//     shared memory (linear probing, -1 empty), a power of two of slots above
//     the walk's bound (the pool's starts + max_steps x expand x R inserts), so
//     it never fills; `scanned` is its number of inserts. Where that table
//     does not fit (a large beam or start set) the wrapper passes a zeroed
//     (B, ceil(N/32)) bitmap in device memory instead, set by atomicOr (a
//     route by shape); `scanned` is then the number of inserts that set a bit;
//   * a node's neighbours are all looked up before any is inserted, so two
//     slots of one node in one adjacency row are both fresh, as in the
//     reference;
//   * scoring: a warp takes one, two or four nodes and issues every load they
//     need (the lane slices of their rows at clamped addresses, their aux terms
//     and valid bytes) before it tests or reduces any; past the row a term is
//     a select, not a branch, so the loads form one run;
//   * expand 1 and R <= 32 (every index's search and insert): warp 0 expands
//     one node a step and warps 1-7 score and merge. While they score, warp 0
//     finds the pool's first open entry, reads its adjacency row and looks up
//     its neighbours (the visited set is whole for the step). After the
//     scoring barrier warp 0 chooses the node the merged pool expands next
//     (that entry, or the best fresh one where it lands and beats it: a warp
//     max, an O(1) landing test, a two-round warp search for its place) and
//     inserts and compacts its fresh neighbours, prefetching their rows into
//     L2 where more blocks than SMs run; meanwhile warps 1-7 merge the fresh
//     entries, unsorted, into the other buffer, each entry's place by counts.
//     One barrier closes both: two a step. (Lost on the way: one warp's
//     bitonic sort and merge, ~4,400 cycles a step; an all-thread merge after
//     the expansion, ~1,500; an L2 prefetch of the fresh nodes' adjacency
//     rows, no gain; the rows' prefetch at B = 16, 4% slower.)
//   * expand > 1 or R > 32: the block-wide step, with duplicate masks across
//     the expanded nodes, a rank sort and a merge by all threads;
//   * every merge keeps lax.top_k's tie order over concat(pool, fresh): a pool
//     entry before a fresh one, and fresh ones by neighbour slot; an invalid
//     fresh node keeps -inf and never enters, which is how a filter prunes the
//     walk;
//   * the starts enter as chunks merged the same way, -inf ones included, so
//     the pool begins as the best min(S, beam) starts;
//   * every dot product (and every sum or max of the metric tier) is a chain
//     of separately rounded operations, lane l of a warp taking elements l,
//     l + 32, ... then a butterfly, so the plain version in ops/graph.py
//     computes bit-identical keys; only the order in which loads are issued
//     differs from a node-at-a-time loop.
#include "metrics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 4;  // nodes a warp scores with all their loads in flight
constexpr int kPer = 4;    // a lane's elements of a row a load round (128 wide in one)

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
  int metric;     // IP / L2 / cosine (0-2) in tiers 0-3, a domain metric's lt code in tier 4
  int table_cap;  // slots of the shared-memory visited set (a power of two), or 0: the bitmap
  bool prefetch;  // prefetch the fresh rows into L2 (blocks beyond one an SM: see below)
  uint32_t* visited;  // (B, words), zeroed (the bitmap route)
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

// The query's visited set: the shared-memory hash set, or its row of the
// device bitmap. insert() returns whether the id was new.
struct Visited {
  int* table;  // null: the bitmap
  unsigned mask;
  int shift;
  uint32_t* bits;

  __device__ __forceinline__ unsigned slot(int id) const {
    return ((unsigned)id * 2654435761u) >> shift;
  }
  __device__ __forceinline__ bool contains(int id) const {
    if (table == nullptr) return (__ldcg(&bits[id >> 5]) >> (id & 31)) & 1u;
    for (unsigned h = slot(id);; h = (h + 1) & mask) {
      const int v = table[h];
      if (v == id) return true;
      if (v < 0) return false;
    }
  }
  __device__ __forceinline__ bool insert(int id) const {
    if (table == nullptr) {
      const uint32_t bit = 1u << (id & 31);
      return !(atomicOr(&bits[id >> 5], bit) & bit);
    }
    for (unsigned h = slot(id);; h = (h + 1) & mask) {
      const int prev = atomicCAS(&table[h], -1, id);
      if (prev < 0) return true;
      if (prev == id) return false;
    }
  }
};

// Which of aux0..2 (bits 0-2) a tier's keys read (node_key of the parent
// kernel: only those, as the wrapper checks only those).
template <int TIER>
__device__ __forceinline__ unsigned aux_use(const Args& a) {
  if constexpr (TIER == 1) return a.metric == 0 ? 1u : a.metric == 1 ? 2u : 5u;
  if constexpr (TIER == 2) return a.metric == 0 ? 0u : a.metric == 1 ? 1u : 2u;
  if constexpr (TIER == 3) return a.metric == 0 ? 1u : a.metric == 1 ? 3u : 5u;
  if constexpr (TIER == 4) return a.aux0 == nullptr ? 0u : 7u;
  return 0u;
}

// A lane's slice of row `id` from column c0 (elements c0 + lane + 32 k) as
// floats; PQ's are its codes. Every load is issued, at a clamped address
// (row 0 for id < 0, the last column past the row), so the group's loads
// form one straight run the compiler issues before any use; the callers mask
// what lies past the row.
template <int TIER>
__device__ __forceinline__ void load_slice(const Args& a, int id, int c0, int lane,
                                           float (&v)[kPer]) {
  const int64_t base = (int64_t)max(id, 0) * a.rw;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = base + min(c0 + lane + 32 * k, a.rw - 1);
    if constexpr (TIER == 0 || TIER == 4) {
      v[k] = __ldg(static_cast<const float*>(a.rows) + i);
    } else if constexpr (TIER == 1) {
      v[k] = __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(a.rows) + i));
    } else if constexpr (TIER == 2) {
      v[k] = static_cast<float>(__ldg(static_cast<const signed char*>(a.rows) + i));
    } else {
      v[k] = static_cast<float>(__ldg(static_cast<const uint8_t*>(a.rows) + i));
    }
  }
}

// The oriented keys of up to kGroup nodes ids[g] (-1: none) for this
// block's query; called by a whole warp, the keys on every lane. A node that
// is not valid (or none) gets -inf; NaN becomes -inf. M is the domain metric
// of tier 4.
template <int TIER, int M, int G>
__device__ __forceinline__ void group_keys(const Args& a, const float* qv, float qc,
                                           const int (&ids)[G], int lane, float (&keys)[G]) {
  const unsigned use = aux_use<TIER>(a);
  const float* aux[3] = {a.aux0, a.aux1, a.aux2};
  // valid bytes and aux terms first, tested only once the keys are formed:
  // a test before the rows' loads would wait for them
  unsigned vb[G];
  float t[G][3];
#pragma unroll
  for (int g = 0; g < G; ++g) {  // unconditional loads, tested at the end
    const int id = max(ids[g], 0);
    vb[g] = __ldg(a.valid + id);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[g][i] = ((use >> i) & 1u) ? __ldg(aux[i] + id) : 0.f;
  }
  float ip[G], xs[G];
  lt::Acc acc[G];
  float hx[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) ip[g] = xs[g] = hx[g][0] = hx[g][1] = 0.f;
  for (int c0 = 0; c0 < a.rw; c0 += 32 * kPer) {
    float v[G][kPer];
#pragma unroll
    for (int g = 0; g < G; ++g) load_slice<TIER>(a, ids[g], c0, lane, v[g]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (TIER == 4 && M == lt::kHaversine) {  // rw == 2: lanes 0 and 1
        hx[g][0] = __shfl_sync(kFull, v[g][0], 0);
        hx[g][1] = __shfl_sync(kFull, v[g][0], 1);
        continue;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        // past the row: no term (a select, not a branch; +0 leaves every
        // sum's bits as they are, as no sum here is ever -0)
        const int d = c0 + lane + 32 * k;
        const bool in = d < a.rw;
        const int dq = min(d, a.rw - 1);
        if constexpr (TIER == 3) {
          const float term = qv[dq * 256 + static_cast<int>(v[g][k])];
          acc[g].a = __fadd_rn(acc[g].a, in ? term : 0.f);
        } else if constexpr (TIER == 4 && M != lt::kCorrelation && M != lt::kHellinger) {
          lt::Acc next = acc[g];
          lt::accumulate<M>(next, qv[dq], v[g][k]);
          if (in) acc[g] = next;
        } else {
          ip[g] = __fadd_rn(ip[g], in ? __fmul_rn(qv[dq], v[g][k]) : 0.f);
          if constexpr (TIER == 0) xs[g] = __fadd_rn(xs[g], in ? __fmul_rn(v[g][k], v[g][k]) : 0.f);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float t0 = t[g][0], t1 = t[g][1], t2 = t[g][2];
    float key;
    if constexpr (TIER == 0) {
      key = lt::pairwise_key(lane_reduce(ip[g]), qc, lane_reduce(xs[g]), a.metric);
    } else if constexpr (TIER == 1) {
      const float s = lane_reduce(ip[g]);
      key = a.metric == 0   ? __fadd_rn(s, t0)
            : a.metric == 1 ? __fsub_rn(__fmul_rn(2.f, s), t1)
                            : __fmul_rn(__fadd_rn(__fadd_rn(s, t0), qc), t2);
    } else if constexpr (TIER == 2) {
      const float s = lane_reduce(ip[g]);
      key = a.metric == 0   ? s
            : a.metric == 1 ? __fsub_rn(__fmul_rn(2.f, s), t0)
                            : __fmul_rn(__fadd_rn(s, qc), t1);
    } else if constexpr (TIER == 3) {
      const float s = __fmul_rn(t0, lane_reduce(acc[g].a));
      key = a.metric == 0 ? s : a.metric == 1 ? __fsub_rn(__fmul_rn(2.f, s), t1) : __fmul_rn(s, t2);
    } else if constexpr (M == lt::kHaversine) {
      key = -lt::haversine(qv[0], qv[1], hx[g][0], hx[g][1]);
    } else {
      const lt::RowTerm qt{qv[a.rw], qv[a.rw + 1], qv[a.rw + 2] != 0.f};
      const lt::RowTerm xt = a.aux0 == nullptr ? lt::RowTerm{} : lt::RowTerm{t0, t1, t2 != 0.f};
      if constexpr (M == lt::kCorrelation || M == lt::kHellinger) {
        key = -lt::gemm_distance(M, lane_reduce(ip[g]), qt, xt);
      } else {
        key = -lt::elem_distance<M>(lt::warp_merge<M>(acc[g]), qt, xt);
      }
    }
    keys[g] = ids[g] >= 0 && vb[g] != 0u && !isnan(key) ? key : -INFINITY;
  }
}

// keys[j] of the m nodes list[j] (-1: none, -inf), every warp of the block:
// warp w scores j = w, w + 8, w + 16, w + 24 with their loads in flight,
// then the next 32; a warp with fewer nodes in a round runs a smaller group.
template <int TIER, int M, int G, int W>
__device__ __forceinline__ void score_group(const Args& a, const float* qv, float qc,
                                            const int* list, int m, float* keys, int r0,
                                            int lane) {
  int ids[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = r0 + W * g;
    ids[g] = j < m ? list[j] : -1;
  }
  float k[G];
  group_keys<TIER, M, G>(a, qv, qc, ids, lane, k);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (r0 + W * g < m) keys[r0 + W * g] = k[g];
}

template <int TIER, int M, int W = kWarps>
__device__ __forceinline__ void score_list(const Args& a, const float* qv, float qc,
                                           const int* list, int m, float* keys, int warp,
                                           int lane) {
  // W warps score (the last W of the block): warp w takes j = w', w' + W, ...
  // (w' = w - (kWarps - W)), kGroup at a time
  for (int r0 = warp - (kWarps - W); r0 < m; r0 += W * kGroup) {
    const int nodes = (m - r0 + W - 1) / W;  // this warp's in this round
    if (nodes == 1) score_group<TIER, M, 1, W>(a, qv, qc, list, m, keys, r0, lane);
    else if (nodes == 2) score_group<TIER, M, 2, W>(a, qv, qc, list, m, keys, r0, lane);
    else score_group<TIER, M, kGroup, W>(a, qv, qc, list, m, keys, r0, lane);
  }
}

// Sorts the m slots (fk, fi) whose key passes `use` (all of them when
// finite_only is false, else the finite ones) into (sk, si), best first, the
// lower slot first between equal keys. Returns how many were sorted.
__device__ __forceinline__ int rank_sort(const float* fk, const int* fi, int m, bool finite_only, float* sk,
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
__device__ __forceinline__ void merge(const float* pk, const int* pi, const uint8_t* pe, int cnt, const float* sk,
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

// Merges the sorted pool (pk, pi, pe; cnt entries) with the m fresh entries
// (fk, fi) in slot order, unsorted, into the other buffer, keeping the best
// `beam`: pool entry i lands at i + (finite fresh keys above it), fresh entry
// j at (pool keys at or above it) + (fresh keys above it, or equal in an
// earlier slot) — the stable order of concat(pool, fresh), with -inf fresh
// entries left out. Run by the block's threads from t0 on: the pool entries
// take the first of them, the fresh ones the last, so both run at once.
__device__ __forceinline__ void merge_fresh(const float* pk, const int* pi, const uint8_t* pe,
                                            int cnt, const float* fk, const int* fi, int m,
                                            int beam, float* ok, int* oi, uint8_t* oe, int t0) {
  const int t = threadIdx.x - t0, nt = kThreads - t0;
  for (int i = t; i < cnt; i += nt) {
    const float v = pk[i];
    int c = 0;
#pragma unroll 8
    for (int u = 0; u < m; ++u) c += fk[u] > v;
    if (i + c < beam) {
      ok[i + c] = v;
      oi[i + c] = pi[i];
      oe[i + c] = pe[i];
    }
  }
  for (int j = nt - 1 - t; j < m; j += nt) {
    const float v = fk[j];
    if (!(v > -INFINITY)) continue;
    int lo = 0, hi = cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pk[mid] >= v) lo = mid + 1; else hi = mid;
    }
#pragma unroll 8
    for (int u = 0; u < m; ++u) {
      const float w = fk[u];
      lo += w > v || (w == v && u < j);
    }
    if (lo < beam) {
      ok[lo] = v;
      oi[lo] = fi[j];
      oe[lo] = 0;
    }
  }
}

// How many of the n keys (sorted best first) are at or above v: a warp's
// search, 32 evenly spaced probes a round. Called by a whole warp.
__device__ __forceinline__ int count_at_least(const float* keys, int n, float v, int lane) {
  int base = 0;
  while (n - base > 32) {
    const int step = (n - base + 31) / 32;
    const int p = base + (lane + 1) * step - 1;
    base += step * __popc(__ballot_sync(kFull, p < n && keys[p] >= v));
    if (base >= n) return n;
    n = min(n, base + step);  // the first probe below v closes the range
  }
  return base + __popc(__ballot_sync(kFull, base + lane < n && keys[base + lane] >= v));
}

// A key as an int in the same order (keys are never NaN; -0 counts as +0).
__device__ __forceinline__ int ordered(float key) {
  const int i = __float_as_int(key + 0.f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Prefetches into L2 what scoring node `id` reads: its row, valid byte and
// aux terms (speculative: it cannot change a result).
template <int TIER>
__device__ __forceinline__ void prefetch_node(const Args& a, int id) {
  const int bytes = a.rw * (TIER == 0 || TIER == 4 ? 4 : TIER == 1 ? 2 : 1);
  const char* row = static_cast<const char*>(a.rows) + (int64_t)id * bytes;
  for (int off = 0; off < bytes; off += 128) prefetch_l2(row + off);
  prefetch_l2(row + bytes - 1);
  prefetch_l2(a.valid + id);
  const unsigned use = aux_use<TIER>(a);
  if (use & 1u) prefetch_l2(a.aux0 + id);
  if (use & 2u) prefetch_l2(a.aux1 + id);
  if (use & 4u) prefetch_l2(a.aux2 + id);
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Dynamic shared memory of a block (ops/graph.py _beam_smem): two pools, the
// fresh slots, the query operand and control words, the visited table.
__host__ __device__ inline int beam_smem(int beam, int fresh, int qw, int expand, int cap) {
  return round16(18 * beam) + round16(19 * fresh) + round16(4 * qw + 4 * (16 + expand)) + 4 * cap;
}

template <int TIER, int M>
__global__ void __launch_bounds__(kThreads) beam_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int beam = a.beam, F = a.fresh;
  // the two pool buffers, reached by offsets from the shared base (an array
  // of pointers indexed by the buffer would compile to generic loads)
  float* const pk0 = reinterpret_cast<float*>(smem);
  int* const pi0 = reinterpret_cast<int*>(pk0 + 2 * beam);
  uint8_t* const pe0 = reinterpret_cast<uint8_t*>(pi0 + 2 * beam);
  const auto pk = [&](int c) { return pk0 + c * beam; };
  const auto pi = [&](int c) { return pi0 + c * beam; };
  const auto pe = [&](int c) { return pe0 + c * beam; };
  float* fk = reinterpret_cast<float*>(smem + round16(18 * beam));
  int* fi = reinterpret_cast<int*>(fk + F);
  float* sk = reinterpret_cast<float*>(fi + F);
  int* si = reinterpret_cast<int*>(sk + F);
  uint8_t* ff = reinterpret_cast<uint8_t*>(si + F);
  uint8_t* fd = ff + F;
  float* qv = reinterpret_cast<float*>(smem + round16(18 * beam) + round16(19 * F));
  // [0] found / fresh count, [1] cursor, [2] the next node's place, [4]
  // merge cursor, [5] inserts (scanned); then the chosen slots (expand > 1)
  int* ctl = reinterpret_cast<int*>(qv + a.qw);
  int* chosen = ctl + 16;
  int* table = reinterpret_cast<int*>(smem + round16(18 * beam) + round16(19 * F) +
                                      round16(4 * a.qw + 4 * (16 + a.expand)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bq = blockIdx.x;
  for (int i = tid; i < a.qw; i += kThreads) qv[i] = a.q[bq * a.qw + i];
  if (a.table_cap > 0)
    for (int i = tid; i < a.table_cap / 4; i += kThreads)
      reinterpret_cast<int4*>(table)[i] = make_int4(-1, -1, -1, -1);
  if (tid == 0) ctl[5] = 0;
  const Visited vis{a.table_cap > 0 ? table : nullptr, (unsigned)a.table_cap - 1u,
                    a.table_cap > 0 ? 32 - __ffs(a.table_cap) + 1 : 0,
                    a.visited + (a.table_cap > 0 ? 0 : bq * a.words)};
  const float qc = a.qconst ? a.qconst[bq] : 0.f;
  const int* st = a.starts + bq * a.starts_stride;
  int cb = 0, cnt = 0, cur = 0;
  __syncthreads();

  // the pool starts as the best min(S, beam) starts, -inf ones included
  for (int c0 = 0; c0 < a.s; c0 += F) {
    const int m = min(F, a.s - c0);
    for (int j = tid; j < m; j += kThreads) {
      const int id = st[c0 + j];
      fi[j] = id >= 0 && id < a.n ? id : -1;
    }
    __syncthreads();
    score_list<TIER, M>(a, qv, qc, fi, m, fk, warp, lane);
    __syncthreads();
    rank_sort(fk, fi, m, false, sk, si);
    if (tid == 0) ctl[4] = beam;
    __syncthreads();
    merge(pk(cb), pi(cb), pe(cb), cnt, sk, si, m, beam, pk(1 - cb), pi(1 - cb), pe(1 - cb), -1,
          &ctl[4]);
    __syncthreads();
    cb = 1 - cb;
    cnt = min(beam, cnt + m);
  }
  for (int i = tid; i < cnt; i += kThreads) {
    const int id = pi(cb)[i];
    if (id >= 0 && vis.insert(id)) atomicAdd(&ctl[5], 1);
  }
  __syncthreads();

  const int E = a.expand, R = a.r, ER = E * R;
  if (E == 1 && R <= 32) {
    // Warp 0 expands one node a step; warps 1.. score its fresh neighbours,
    // then merge them while warp 0 expands the next node (the header's
    // design). Every expansion, lookup and insert comes in the reference's
    // order; the fresh lists alternate between (fk, fi) and (sk, si).
    float* keys = fk;
    int* list = fi;
    float* nkeys = sk;
    int* nlist = si;
    // the first unexpanded finite entry of the pool (keys pkb, flags peb;
    // cnt entries) from the cursor, or -1; warp 0
    const auto first_open = [=](const float* pkb, const uint8_t* peb, int cnt, int cur) {
      for (int base = cur; base < cnt; base += 32) {
        const int p = base + lane;
        const bool in = p < cnt;
        const float kp = in ? pkb[p] : -INFINITY;
        const unsigned mw = __ballot_sync(kFull, in && !peb[p] && kp > -INFINITY);
        const unsigned mend = __ballot_sync(kFull, in && !(kp > -INFINITY));
        if (mw) return base + __ffs(mw) - 1;
        if (mend) break;
      }
      return -1;
    };
    // the node the pool (pkb; cnt entries) expands after merging the m fresh
    // entries (fkeys, flist): the best fresh entry where it lands within the
    // beam and beats the first open pool entry ppos, else that entry; its id
    // (or -1), and `pos` its place in the merged pool; warp 0
    const auto choose = [=](const float* pkb, int cnt, int ppos, int pid, int m,
                            const float* fkeys, const int* flist, int& pos) {
      const float fkey = lane < m ? fkeys[lane] : -INFINITY;
      // the best fresh entry: the larger key (as an ordered int: a key is
      // never NaN, and -0 becomes +0), the lower slot
      const int ord = ordered(fkey);
      const int best = __reduce_max_sync(kFull, ord);
      const int bl = __ffs(__ballot_sync(kFull, ord == best)) - 1;
      const float bk = __shfl_sync(kFull, fkey, bl);
      const float pkey = ppos >= 0 ? pkb[ppos] : -INFINITY;
      // it lands within the beam where the pool has room or its last key is below
      const bool lands = bk > -INFINITY && (cnt < beam || pkb[beam - 1] < bk);
      if (lands && (ppos < 0 || bk > pkey)) {
        pos = count_at_least(pkb, ppos < 0 ? cnt : ppos, bk, lane);
        return flist[bl];
      }
      pos = ppos + __popc(__ballot_sync(kFull, fkey > pkey));
      return ppos >= 0 ? pid : -1;
    };
    // whether neighbour nb (a slot a lane) is fresh: in range and not visited
    const auto fresh = [&](int nb) { return nb >= 0 && nb < a.n && !vis.contains(nb); };
    // expands the node whose adjacency row is nb, its fresh slots fr (every
    // lookup made before any insert): inserts them, compacts them into `out`
    // in slot order and, where many blocks share the card, prefetches them;
    // returns their count; warp 0
    const auto expand = [&](int nb, bool fr, int* out) {
      __syncwarp();
      const unsigned added = __ballot_sync(kFull, fr && vis.insert(nb));
      const unsigned fm = __ballot_sync(kFull, fr);
      if (fr) {
        out[__popc(fm & ((1u << lane) - 1u))] = nb;
        if (a.prefetch) prefetch_node<TIER>(a, nb);
      }
      if (lane == 0) ctl[5] += __popc(added);
      return __popc(fm);
    };
    const auto adjacency = [&](int node) {
      return lane < R ? __ldg(a.graph + (int64_t)node * R + lane) : -1;
    };
    // the cursor is the place of the node last expanded: every entry before
    // the first unexpanded finite one is expanded
    if (warp == 0) {
      int mm = -1;
      const int ppos = a.max_steps > 0 ? first_open(pk(cb), pe(cb), cnt, 0) : -1;
      if (ppos >= 0) {
        if (lane == 0) pe(cb)[ppos] = 1;
        const int nb = adjacency(pi(cb)[ppos]);
        mm = expand(nb, fresh(nb), list);
      }
      if (lane == 0) {
        ctl[0] = mm;
        ctl[2] = ppos;
      }
    }
    __syncthreads();
    int m = ctl[0];
    cur = ctl[2];
    for (int step = 0; m >= 0; ++step) {
      // warp 0 finds the first open pool entry, reads its adjacency row and
      // looks its neighbours up (the visited set is whole for this step), in
      // case it is expanded next, while warps 1.. score
      const bool more = step + 1 < a.max_steps;
      int ppos = -1, pid = -1, nb = -1;
      bool fr = false;
      if (warp == 0) {
        ppos = more ? first_open(pk(cb), pe(cb), cnt, cur) : -1;
        if (ppos >= 0) {
          pid = pi(cb)[ppos];
          nb = adjacency(pid);
          fr = fresh(nb);
        }
      } else {
        score_list<TIER, M, kWarps - 1>(a, qv, qc, list, m, keys, warp, lane);
      }
      __syncthreads();
      if (warp == 0) {
        int pos = 0, mm = -1;
        const int node = more ? choose(pk(cb), cnt, ppos, pid, m, keys, list, pos) : -1;
        if (node >= 0 && node != pid) {  // a fresh node: its row and lookups now
          nb = adjacency(node);
          fr = fresh(nb);
        }
        if (node >= 0) mm = expand(nb, fr, nlist);
        if (lane == 0) {
          ctl[0] = mm;
          ctl[2] = pos;
        }
      } else if (m > 0) {
        merge_fresh(pk(cb), pi(cb), pe(cb), cnt, keys, list, m, beam, pk(1 - cb), pi(1 - cb),
                    pe(1 - cb), 32);
      }
      const int f = __syncthreads_count(tid < m && keys[tid] > -INFINITY);
      if (m > 0) {
        cb = 1 - cb;  // every pool entry was copied, whether or not a fresh one came in
        cnt = min(beam, cnt + f);
      }
      m = ctl[0];
      cur = ctl[2];
      if (tid == 0 && m >= 0) pe(cb)[cur] = 1;  // the node expanded next, in its new place
      float* tk = keys;
      keys = nkeys;
      nkeys = tk;
      int* tl = list;
      list = nlist;
      nlist = tl;
    }
  } else {
    for (int step = 0; step < a.max_steps; ++step) {
      // the first E unexpanded entries with a finite key, from the cursor on
      if (warp == 0) {
        int found = 0, first = -1;
        for (int base = cur; base < cnt; base += 32) {
          const int p = base + lane;
          const bool in = p < cnt;
          const float kp = in ? pk(cb)[p] : -INFINITY;
          const bool unexp = in && !pe(cb)[p];
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
      if (tid < found) pe(cb)[chosen[tid]] = 1;

      // the chosen nodes' neighbours; fresh = in range and not yet visited
      for (int t = tid; t < ER; t += kThreads) {
        const int e = t / R;
        int nb = -1;
        bool fr = false;
        if (e < found) {
          nb = a.graph[static_cast<int64_t>(pi(cb)[chosen[e]]) * R + (t - e * R)];
          fr = nb >= 0 && nb < a.n && !vis.contains(nb);
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
      int added = 0;
      for (int t = tid; t < ER; t += kThreads) {
        if (ff[t]) added += vis.insert(fi[t]);
        else fi[t] = -1;
      }
      if (added) atomicAdd(&ctl[5], added);
      __syncthreads();
      score_list<TIER, M>(a, qv, qc, fi, ER, fk, warp, lane);
      __syncthreads();
      const int f = rank_sort(fk, fi, ER, true, sk, si);
      if (tid == 0) ctl[4] = beam;
      __syncthreads();
      if (f) {
        merge(pk(cb), pi(cb), pe(cb), cnt, sk, si, f, beam, pk(1 - cb), pi(1 - cb), pe(1 - cb),
              cur, &ctl[4]);
        __syncthreads();
        cb = 1 - cb;
        cnt = min(beam, cnt + f);
        cur = min(ctl[4], cnt);
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < beam; i += kThreads) {
    const float key = i < cnt ? pk(cb)[i] : -INFINITY;
    a.out_keys[bq * beam + i] = key;
    a.out_ids[bq * beam + i] = key > -INFINITY ? pi(cb)[i] : -1;
  }
  if (tid == 0) a.scanned[bq] = ctl[5];
}

template <int TIER, int M>
int launch(const Args& a, int b, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(beam_kernel<TIER, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<TIER, M><<<b, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lt_beam_search(int tier, const float* q, int qw, const float* qconst,
                              const void* rows, int rw, const float* aux0, const float* aux1,
                              const float* aux2, const int* graph, int n, int r,
                              const int* starts, int s, int starts_stride, const uint8_t* valid,
                              int b, int beam, int max_steps, int expand, int metric, int fresh,
                              int table_cap, uint32_t* visited, int words, float* out_keys,
                              int* out_ids, int* scanned, int smem, cudaStream_t stream) {
  // the metric tier serves the graph indexes' domain metrics (not Canberra or
  // Bray-Curtis: the reference keeps those exact-only)
  const bool domain = metric == lt::kCorrelation || metric == lt::kHellinger ||
                      metric == lt::kL1 || metric == lt::kChebyshev ||
                      metric == lt::kWasserstein || metric == lt::kJensenShannon ||
                      (metric == lt::kHaversine && rw == 2);
  // the table must hold every insert the walk can make and keep a slot empty
  const int64_t bound = (int64_t)min(s, beam) + (int64_t)max_steps * expand * r;
  const bool table_ok = table_cap == 0 ? (visited != nullptr && words >= (n + 31) / 32)
                                       : (table_cap >= 64 && (table_cap & (table_cap - 1)) == 0 &&
                                          table_cap > bound);
  if (b < 1 || n < 1 || r < 1 || s < 1 || beam < 1 || expand < 1 || fresh < expand * r ||
      fresh < 32 || qw < 1 || rw < 1 || max_steps < 0 || !table_ok ||
      smem != beam_smem(beam, fresh, qw, expand, table_cap) ||
      (tier == 4 && (qw != rw + 3 || !domain)))
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
  a.table_cap = table_cap;
  // the fresh rows' L2 prefetch paid off only where more blocks than SMs
  // share the memory system (tools/beam_phases.py on an H100: 595 against
  // 649 kilocycles a walk at B = 256, 532 against 511 at B = 16)
  a.prefetch = b > lt::sm_count();
  a.visited = visited;
  a.words = words;
  a.out_keys = out_keys;
  a.out_ids = out_ids;
  a.scanned = scanned;
  switch (tier) {
    case 0: return launch<0, 0>(a, b, smem, stream);
    case 1: return launch<1, 0>(a, b, smem, stream);
    case 2: return launch<2, 0>(a, b, smem, stream);
    case 3: return launch<3, 0>(a, b, smem, stream);
    case 4:
      switch (metric) {
        case lt::kCorrelation: return launch<4, lt::kCorrelation>(a, b, smem, stream);
        case lt::kHellinger: return launch<4, lt::kHellinger>(a, b, smem, stream);
        case lt::kL1: return launch<4, lt::kL1>(a, b, smem, stream);
        case lt::kChebyshev: return launch<4, lt::kChebyshev>(a, b, smem, stream);
        case lt::kWasserstein: return launch<4, lt::kWasserstein>(a, b, smem, stream);
        case lt::kJensenShannon: return launch<4, lt::kJensenShannon>(a, b, smem, stream);
        default: return launch<4, lt::kHaversine>(a, b, smem, stream);
      }
    default: return (int)cudaErrorInvalidValue;
  }
}
