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
// formulas.
//
// Bound (tools/roofline.py topl_bound): the f32 product, 2 * B * N * D flops
// (true f32 FMA outside the tensor cores, as Precision.HIGHEST asks): about
// 1.07e15 flops for 4,096 queries over a 1M x 128 corpus, some 16 ms at 67
// TFLOP/s. Under L1 the same pairs cost two f32 instructions an element (a
// subtraction, an add of its absolute value); Jensen-Shannon adds a logarithm
// an element (the special-function units); Haversine two sines, two cosines,
// an arcsine and a square root a pair.
//
// Design: a block owns 64 queries and one span of rows (the query group the
// fastest grid index, so the groups of a span read it from L2 together;
// spans are sized so the grid is one wave of the blocks the card holds). It
// walks the span with the FMA route of f32_tile.cuh (128-row tiles,
// register-staged k-major stages of 16 dimensions, an 8 x 4 register tile a
// thread, the values leaving through a shared score tile): the inner step is
// the FMA in dimension order (modes 0-3; mode 4 under correlation and
// Hellinger over the centred or square-rooted rows), metrics.cuh's
// accumulate<M> under L1, Chebyshev, Wasserstein and Jensen-Shannon, and
// nothing under Haversine (D = 2), whose keys come from the rows. After each
// tile every thread forms the keys of its own 8 rows x 4 queries and tests
// each against its query's threshold, the L-th best (key, id) kept so far
// (from a start of (-inf, INT_MAX), so -inf entries are kept in id order);
// the few that beat it join the query's pending entries (a shared counter
// gives the slot). After a barrier, the warp that owns a query merges its
// pending entries into the kept ones (common.cuh WarpTopk: a register sort
// and a bitonic merge) when another tile could overflow them, and raises the
// threshold. The lists live in a device buffer (L2), so shared memory holds
// only the tile, and L does not limit the query group. Each block writes its
// span's L best a query, (-inf, INT_MAX) where the span has fewer rows; K5
// then merges the spans' lists with the row id as the tie-break. The keys
// are the parent design's to the bit: the same operations in the same order,
// only tiled differently; packed (key, id) entries compare exactly, so the
// order in which a tile's entries join does not change the result.
// (Measured on an H100 against the shapes tried: a warp a query offering the
// score tile's keys 32 at a time, lists in shared memory, 32- or 128-query
// tiles, 8-dimension stages and keys formed in the loop's registers were
// each 4-87% slower at 4,096 queries x 1M rows.)
#include <algorithm>
#include <type_traits>

#include "f32_tile.cuh"

namespace {

constexpr int kPend = 192;  // pending entries a list: a tile's 128 keys on top of 64 held
using List = lt::WarpTopkT<kPend>;
constexpr int kMetricMode = 4;  // -(the distance of `metric`), metrics.cuh
using Tile = lt::FmaTile<64, 4, 16>;  // 64 queries x 128 rows a tile, 8 x 4 a thread

// modes: 0 -(|q|^2 + |x|^2 - 2 q.x); 1 q.x; 2 -max(|q|^2 + |x|^2 - 2 q.x, 0);
// 3 -(cosine distance)
__device__ __forceinline__ float topl_key(float ip, float qs, float xs, int mode) {
  if (mode == 1) return ip;
  if (mode == 3) return -lt::cosine_distance(ip, sqrtf(qs * xs));
  const float d = (qs + xs) - 2.f * ip;
  return mode == 0 ? -d : -lt::clamp_nonneg(d);
}

struct Args {
  const float* q;      // (B, D)
  const int* q_ids;    // (B,) each query's own row
  const float* x;      // (N, D)
  const float* qsq;    // (B,) modes 0, 2, 3
  const float* xsq;    // (N,)
  const float* qterms;  // (3, B) mode 4: [a; b; inv], null for L1, Chebyshev, Haversine
  const float* xterms;  // (3, N)
  int B, N, D, n_real, L, kp, mode, metric;
  bool vec;  // 16-byte loads of q and x
  int groups;
  int64_t span_rows;
  uint64_t* lists;  // (blocks, TN, kp + kPend) the lists' entries
  float* out_keys;  // (B, spans * L)
  int* out_ids;
};

// MET is how a pair's key is formed: lt::kIP from the dot product (modes 0-3,
// and mode 4 under correlation and Hellinger), an elementwise metric from
// its accumulated value, lt::kHaversine from the two (lon, lat) rows.
template <int MET>
using StepOf = std::conditional_t<MET == lt::kIP, lt::FmaStep,
                                  std::conditional_t<MET == lt::kHaversine, lt::NoStep,
                                                     lt::ElemStep<MET>>>;

// What the epilogue reads and keeps of each query of the group, in shared
// memory: its own row, its squared norm (modes 0, 2, 3), its terms (mode 4;
// Haversine: lon, lat), and its list's state: the threshold (an entry joins
// only if it is larger), the kept and the pending counts.
struct Queries {
  uint64_t thr[Tile::TN];
  int pend[Tile::TN], kept[Tile::TN], self[Tile::TN];
  float sq[Tile::TN];
  lt::RowTerm term[Tile::TN];
};

// The epilogue of a tile. Each thread reads back the values it stored to the
// score tile (its 8 rows x 4 queries of the FMA route: the accumulators are
// cleared by then, so the keys' registers do not add to the loop's), forms
// their keys and appends any that beats its query's threshold to the
// query's pending entries (a shared counter gives the slot). After a
// barrier, each warp merges the pending entries of its queries (j = warp + 8
// m) that could not take another tile.
template <int MET>
struct TopLKeys {
  Args a;
  Queries* qs;
  uint64_t* lists;  // the block's lists, kp + kPend entries a query
  int nq;
  int64_t row_end;

  __device__ __forceinline__ uint64_t* list(int j) const {
    return lists + (int64_t)j * (a.kp + kPend);
  }

  // The key of row n for query qj, masked, then the threshold test (tk, ti:
  // the query's threshold): an entry that beats it joins the pending ones.
  __device__ __forceinline__ void append(int qj, int64_t n, float key, float tk, int ti) const {
    if (isnan(key) || n == qs->self[qj] || n >= a.n_real) key = -INFINITY;
    if (key > tk || (key == tk && (int)n < ti)) {
      const int slot = atomicAdd(&qs->pend[qj], 1);
      list(qj)[a.kp + slot] = lt::pack_entry(key, (int)n);
    }
  }

  // Query qj's threshold: (key, id) beats it iff key > tk, or key == tk and
  // id < ti; nothing beats a query past the group's.
  __device__ __forceinline__ void threshold(int qj, float& tk, int& ti) const {
    tk = qj < nq ? lt::entry_key(qs->thr[qj]) : INFINITY;
    ti = qj < nq ? lt::entry_id(qs->thr[qj]) : INT_MIN;
  }

  __device__ __forceinline__ void operator()(int64_t tile_row, const float* sc) const {
    const int tr = Tile::tr(), tq = Tile::tq();
    if constexpr (MET == lt::kHaversine) {
      // the keys from the (lon, lat) rows alone; rolled loops keep the sines,
      // cosines and arcsine to one copy, within the instruction cache
#pragma unroll 1
      for (int i = 0; i < Tile::RM; ++i) {
        const int64_t n = tile_row + Tile::row(tr, i);
        if (n >= row_end) continue;
        const float lon = __ldg(a.x + 2 * n), lat = __ldg(a.x + 2 * n + 1);
#pragma unroll 1
        for (int j = 0; j < Tile::RN; ++j) {
          const int qj = Tile::query(tq, j);
          float tk;
          int ti;
          threshold(qj, tk, ti);
          append(qj, n, -lt::haversine(qs->term[qj].a, qs->term[qj].b, lon, lat), tk, ti);
        }
      }
    } else {
      float tk[Tile::RN];
      int ti[Tile::RN];
#pragma unroll
      for (int j = 0; j < Tile::RN; ++j) threshold(Tile::query(tq, j), tk[j], ti[j]);
#pragma unroll
      for (int g = 0; g < Tile::RM / 4; ++g) {
        float v[Tile::RN][4];
#pragma unroll
        for (int j = 0; j < Tile::RN; ++j) {
          const float4 f = *reinterpret_cast<const float4*>(
              sc + Tile::query(tq, j) * Tile::kScoreStride + Tile::row(tr, 4 * g));
          v[j][0] = f.x;
          v[j][1] = f.y;
          v[j][2] = f.z;
          v[j][3] = f.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t n = tile_row + Tile::row(tr, 4 * g + e);
          if (n >= row_end) continue;
          float xs = 0.f;
          lt::RowTerm xt{};
          if constexpr (MET == lt::kIP) {
            if (a.mode < kMetricMode && a.xsq != nullptr) xs = __ldg(a.xsq + n);
            if (a.mode == kMetricMode) xt = lt::row_term(a.xterms, a.N, n);
          } else {
            xt = lt::row_term(a.xterms, a.N, n);
          }
#pragma unroll
          for (int j = 0; j < Tile::RN; ++j) {
            const int qj = Tile::query(tq, j);
            float key;
            if constexpr (MET == lt::kIP) {
              key = a.mode < kMetricMode
                        ? topl_key(v[j][e], qs->sq[qj], xs, a.mode)
                        : -lt::gemm_distance(a.metric, v[j][e], qs->term[qj], xt);
            } else {
              key = -lt::elem_distance<MET>(lt::Acc{v[j][e], 0.f}, qs->term[qj], xt);
            }
            append(qj, n, key, tk[j], ti[j]);
          }
        }
      }
    }
    __syncthreads();  // every entry appended
    for (int j = threadIdx.x >> 5; j < nq; j += Tile::kThreads / 32)
      if (qs->pend[j] > kPend - Tile::TM) merge(j);
  }

  // One warp: query j's pending entries merged into its kept ones.
  __device__ __forceinline__ void merge(int j) const {
    List t;
    t.list = list(j);
    t.kept = qs->kept[j];
    t.pend = qs->pend[j];
    t.thr = qs->thr[j];
    t.flush(a.kp, a.L);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      qs->kept[j] = t.kept;
      qs->pend[j] = 0;
      qs->thr[j] = t.thr;
    }
    __syncwarp();
  }
};

// A block: query group blockIdx.x % groups over row span blockIdx.x / groups.
template <int MET>
__global__ void __launch_bounds__(Tile::kThreads, 2) topl_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];  // the tile's two stages and score tile
  __shared__ Queries qs;
  const int group = blockIdx.x % a.groups, span = blockIdx.x / a.groups;
  const int q0 = group * Tile::TN, nq = min(Tile::TN, a.B - q0);
  const int64_t row0 = (int64_t)span * a.span_rows;
  const int64_t row_end = min((int64_t)a.N, row0 + a.span_rows);
  uint64_t* lists = a.lists + (int64_t)blockIdx.x * Tile::TN * (a.kp + kPend);
  for (int j = threadIdx.x; j < nq; j += Tile::kThreads) {
    const int b = q0 + j;
    qs.thr[j] = lt::kPadEntry;  // (-inf, INT_MAX): -inf entries join, in id order
    qs.pend[j] = qs.kept[j] = 0;
    qs.self[j] = a.q_ids[b];
    qs.sq[j] = a.qsq != nullptr ? a.qsq[b] : 0.f;
    if constexpr (MET == lt::kHaversine) {
      qs.term[j] = lt::RowTerm{a.q[2 * b], a.q[2 * b + 1], false};
    } else {
      qs.term[j] = lt::row_term(a.qterms, a.B, b);
    }
  }
  for (int e = threadIdx.x; e < nq * a.kp; e += Tile::kThreads)
    lists[(int64_t)(e / a.kp) * (a.kp + kPend) + e % a.kp] = lt::kPadEntry;
  // the loop's first barrier orders these stores before the first tile
  const lt::F32Span sp{a.q, a.x, a.D, a.vec, q0, nq, row0, row_end};
  const TopLKeys<MET> epi{a, &qs, lists, nq, row_end};
  lt::fma_span_scores<Tile, StepOf<MET>>(sp, smem, epi);
  // the last pending entries, then the span's best L a query
  const int64_t ld = (int64_t)(gridDim.x / a.groups) * a.L;
  for (int j = threadIdx.x >> 5; j < nq; j += Tile::kThreads / 32) {
    epi.merge(j);
    const uint64_t* l = epi.list(j);
    const int64_t o = (int64_t)(q0 + j) * ld + (int64_t)span * a.L;
    for (int p = threadIdx.x & 31; p < a.L; p += 32) {
      a.out_keys[o + p] = lt::entry_key(l[p]);
      a.out_ids[o + p] = lt::entry_id(l[p]);
    }
  }
}

struct Plan {
  int groups, spans;
  int64_t span_rows;
  long long scratch;  // list entries (uint64) in device memory
};

// The grid: one wave of the blocks the card holds at once (a partial second
// wave would cost a whole one, and longer spans restart fewer lists), spans
// a whole number of tiles; every list in device memory, so the shared
// memory holds only the tile's stages and score tile, and L does not limit
// the query group.
template <int MET>
int plan_for(const Args& a, Plan& p) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        topl_kernel<MET>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, topl_kernel<MET>, Tile::kThreads, Tile::kSmem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  p.groups = (a.B + Tile::TN - 1) / Tile::TN;
  const int64_t tiles = ((int64_t)a.N + Tile::TM - 1) / Tile::TM;
  const int64_t spans =
      std::max<int64_t>(1, std::min<int64_t>(tiles, (int64_t)per_sm * lt::sm_count() / p.groups));
  p.span_rows = (tiles + spans - 1) / spans * Tile::TM;
  p.spans = (int)((a.N + p.span_rows - 1) / p.span_rows);
  if ((int64_t)p.groups * p.spans > INT_MAX) return (int)cudaErrorInvalidValue;
  p.scratch = (long long)p.groups * p.spans * Tile::TN * (a.kp + kPend);
  return 0;
}

// Plans (plan set: writes the plan and launches nothing) or launches.
template <int MET>
int run(Args a, int spans, Plan* plan, cudaStream_t stream) {
  Plan p{};
  const int err = plan_for<MET>(a, p);
  if (err != 0) return err;
  if (plan != nullptr) {
    *plan = p;
    return 0;
  }
  if (spans != p.spans || a.lists == nullptr) return (int)cudaErrorInvalidValue;
  a.groups = p.groups;
  a.span_rows = p.span_rows;
  topl_kernel<MET><<<(unsigned)(p.groups * p.spans), Tile::kThreads, Tile::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int spans, Plan* plan, cudaStream_t stream) {
  if (a.B < 1 || a.N < 1 || a.D < 1 || a.L < 1 || a.L > 256 || a.L > a.N || a.mode < 0 ||
      a.mode > kMetricMode)
    return (int)cudaErrorInvalidValue;
  if (a.mode < kMetricMode) return run<lt::kIP>(a, spans, plan, stream);
  switch (a.metric) {
    case lt::kCorrelation:
    case lt::kHellinger: return run<lt::kIP>(a, spans, plan, stream);
    case lt::kL1: return run<lt::kL1>(a, spans, plan, stream);
    case lt::kChebyshev: return run<lt::kChebyshev>(a, spans, plan, stream);
    case lt::kWasserstein: return run<lt::kWasserstein>(a, spans, plan, stream);
    case lt::kJensenShannon: return run<lt::kJensenShannon>(a, spans, plan, stream);
    case lt::kHaversine:
      return a.D == 2 ? run<lt::kHaversine>(a, spans, plan, stream) : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const float* q, const int* q_ids, const float* x, const float* qsq,
               const float* xsq, const float* qterms, const float* xterms, int B, int N, int D,
               int n_real, int L, int mode, int metric, uint64_t* lists, float* out_keys,
               int* out_ids) {
  const bool vec = D % 4 == 0 && lt::aligned16(q) && lt::aligned16(x);
  return Args{q, q_ids, x, qsq, xsq, qterms, xterms, B, N, D, n_real, L, lt::list_kp(L), mode,
              metric, vec, 0, 0, lists, out_keys, out_ids};
}

long long plan_of(int B, int N, int D, int L, int mode, int metric, bool scratch) {
  Plan p{};
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, N,
                           D, 0, L, mode, metric, nullptr, nullptr, nullptr);
  if (dispatch(a, 0, &p, nullptr) != 0) return -1;
  return scratch ? p.scratch : p.spans;
}

}  // namespace

extern "C" {

// The span count of lt_topl_scan's output for these shapes (-1: refused).
// The plan reads only the shapes, L and the kernel's occupancy.
long long lt_topl_spans(int B, int N, int D, int L, int mode, int metric) {
  return plan_of(B, N, D, L, mode, metric, false);
}

// The uint64 entries of the device list buffer lt_topl_scan needs (-1:
// refused).
long long lt_topl_scratch(int B, int N, int D, int L, int mode, int metric) {
  return plan_of(B, N, D, L, mode, metric, true);
}

// q (B, D) and x (N, D) f32 rows (mode 4: the lead rows of the metric's
// transform), q_ids (B,) each query's own row, rows >= n_real masked. Modes
// 0-3 read qsq (B,) and xsq (N,) (not mode 1); mode 4 reads `metric`'s
// per-row terms qterms (3, B) and xterms (3, N), [a; b; inv] (null for L1,
// Chebyshev and Haversine). Writes each span's best L (key, id) a query into
// out_keys / out_ids (B, spans * L), best first, (-inf, INT_MAX) where a span
// has fewer rows; `spans` must be lt_topl_spans of the same shapes, `lists`
// a buffer of lt_topl_scratch entries.
int lt_topl_scan(const float* q, const int* q_ids, const float* x, const float* qsq,
                 const float* xsq, const float* qterms, const float* xterms, int B, int N, int D,
                 int n_real, int L, int spans, int mode, int metric, uint64_t* lists,
                 float* out_keys, int* out_ids, cudaStream_t stream) {
  const Args a = make_args(q, q_ids, x, qsq, xsq, qterms, xterms, B, N, D, n_real, L, mode,
                           metric, lists, out_keys, out_ids);
  return dispatch(a, spans, nullptr, stream);
}

}  // extern "C"
