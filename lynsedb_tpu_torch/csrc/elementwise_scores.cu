// K6c: the elementwise family — L1, Chebyshev, Canberra, Bray-Curtis,
// Wasserstein (L1 over the rows' cdf transform), Jensen-Shannon (over the
// probability transform) and Haversine — with the metric a template
// parameter, in the modes of the family's jobs: a tile over every f32 row
// (exact search), the pass over the mean-centred bf16 copy with the mean
// added back in f32, fused with its top C (K9, the approximate first pass:
// lt_elementwise_topc) and an explicit (B, C) row list (the gather mode:
// K10's rescore of shortlists).
//
// Replaces lynsedb_tpu/ops/distance.py _pw_l1 (:199) to _pw_jensen_shannon
// (:254) inside scan.py flat_topk (:190) and flat_scores (:243); scan.py
// bf16_flat_topk (:681, K9: the chunked scores and each chunk's top C, then
// the merge); scan.py rescore_rows (:744, the gather mode). The formulas,
// with the JAX package's policies (zero-mass, invalid and out-of-range rows;
// IEEE division, logf, sinf, cosf, asinf and sqrtf, no flush to zero:
// Canberra's 1e-45 floor is a denormal), are metrics.cuh's, shared with the
// graph kernels.
//
// Bound (tools/roofline.py elem_tile_bound): at small B the read of the f32
// rows (512 MB at 1M x 128: 0.153 ms at 3.35 TB/s) and the (B, N) key write;
// above, each (pair, dimension)'s f32 instructions (two for the L1 family's
// difference and add, four for Canberra and Bray-Curtis) over the f32
// instruction rate, and Canberra's division and Jensen-Shannon's logarithm
// over the special-function units. Haversine (D = 2) reads 8 bytes a row and
// is bound by its two sines, square root and arcsine a pair at large B. K9
// (roofline.elem_topc_bound): the bf16 rows (256 MB at 1M x 128: 0.076 ms)
// and the (B, C) lists, no (B, N) keys; the same operations above.
// Design, by mode:
//   f32 tile   csrc/f32_tile.cuh's pipelined tile with the inner step
//              ElemStep<M> (metrics.cuh's accumulate<M>, one rounded operation
//              at a time in dimension order), routed by B as K1 routes: B <= 16
//              the bytes route (128-row, 32-dimension stages through a 3-deep
//              cp.async ring, a row a thread, the batch's real queries), above
//              the FMA route (128-row x 32/64/128-query tiles staged k-major,
//              an 8 x 4 or 8 x 8 register tile a thread, the values leaving
//              through a shared score tile; Bray-Curtis, two running values a
//              pair, stays on 8 x 4 and leaves as its finished distance); an
//              unaligned base or D % 4 != 0 takes the route's scalar loads.
//              Canberra and Jensen-Shannon (a division or a logarithm a
//              dimension: a long dependent chain) take the bytes route to
//              B = 8 and the 64-row tile (below) above it. The epilogue
//              applies the metric's policy with the probability metrics'
//              per-row terms (the group's in shared memory), orients, masks
//              and writes coalesced keys. Any tile that adds a pair's terms in
//              dimension order gives these keys to the bit.
//   bf16 top C (K9) the same routes over the centred bf16 copy (f32_tile.cuh
//              Bf16Span: the bytes route's ring holds the rows as bf16, 16-byte
//              copies of 8 values, each converted and its mean added once for
//              all queries; the FMA route converts as it stages); the selection
//              in the tile's epilogue: each block keeps each query's top C of
//              its span, a key joining only if it beats the span's C-th (K19's
//              lists in device memory, WarpTopk merges; one shared atomic for
//              the lanes that offer to a query), spans sized so the grid is
//              one wave and spans x C <= N / span_c (scan.ELEM_TOPC_SPAN_C);
//              K5 merges the spans' sorted runs. A pilot launch over the first
//              rows gives the main one its start (ops/scan.py). Fused on the
//              bytes route to B = 16 (Canberra 8), Chebyshev on both; past
//              that, L1, Canberra and Bray-Curtis take the 64-row tile's keys
//              and K5 (lt_elementwise_bf16_keys), as measured. The keys are
//              the parent's 64-row tile's to the bit, so the (keys, ids) are
//              its tile -> K5 chain's.
//   Haversine  a row a thread, its GeoRow (radians, cos(lat)) formed once, the
//              block's 64 queries' GeoRows in shared memory, coalesced keys.
//   64-row     common.cuh's tile (TQ queries x 64 rows a block, 16-deep
//              shared stages): the f32 rows under Canberra and Jensen-Shannon at
//              B > 8, and K9's keys past its fused routes (the bf16 rows, the
//              mean added back in f32).
//   gather     (K10) a warp a (query, slot), lanes splitting the dimensions
//              and merging by shuffles.
#include <climits>

#include "f32_tile.cuh"

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

// Haversine's gather mode: a thread a (query, slot).
__global__ void __launch_bounds__(256)
    haversine_gather_kernel(const float* __restrict__ q, const float* __restrict__ x,
                            const int* __restrict__ ids, int C, float* __restrict__ keys) {
  const int b = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= C) return;
  const int n = ids[(int64_t)b * C + j];
  float key = -INFINITY;
  if (n >= 0) {
    const float2 xr = __ldg(reinterpret_cast<const float2*>(x) + n);
    const float2 qr = reinterpret_cast<const float2*>(q)[b];
    key = lt::to_key(lt::haversine(qr.x, qr.y, xr.x, xr.y), true, true);
  }
  keys[(int64_t)b * C + j] = key;
}

constexpr int kGeoThreads = 256, kGeoQueries = 64;

// Haversine's tile mode: a row a thread (its GeoRow formed once) against the
// block's kGeoQueries queries (their GeoRows in shared memory).
__global__ void __launch_bounds__(kGeoThreads)
    haversine_tile_kernel(const float* __restrict__ q, const float* __restrict__ x,
                          const uint8_t* __restrict__ valid, int B, int N,
                          float* __restrict__ keys) {
  __shared__ float q_lon[kGeoQueries], q_lat[kGeoQueries], q_cos[kGeoQueries];
  __shared__ bool q_ok[kGeoQueries];
  const int q0 = blockIdx.y * kGeoQueries, nq = min(kGeoQueries, B - q0);
  for (int j = threadIdx.x; j < nq; j += kGeoThreads) {
    const lt::GeoRow g = lt::geo_row(q[2 * (q0 + j)], q[2 * (q0 + j) + 1]);
    q_lon[j] = g.lon;
    q_lat[j] = g.lat;
    q_cos[j] = g.cos_lat;
    q_ok[j] = g.ok;
  }
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * kGeoThreads + threadIdx.x;
  if (n >= N) return;
  const lt::GeoRow xg = lt::geo_row(__ldg(x + 2 * n), __ldg(x + 2 * n + 1));
  const bool live = valid[n] != 0;
#pragma unroll 1
  for (int j = 0; j < nq; ++j) {
    const lt::GeoRow qg{q_lon[j], q_lat[j], q_cos[j], q_ok[j]};
    keys[(int64_t)(q0 + j) * N + n] = lt::to_key(lt::haversine(qg, xg), true, live);
  }
}

// ── the f32 tile mode: f32_tile.cuh's two routes ─────────────────────────

struct ElemArgs {
  const float* q;
  const float* x;
  int B, N, D;
  bool vec;  // 16-byte loads of q and x
  int groups;
  int64_t span_rows;
  RowTerms terms;
  const uint8_t* valid;
  float* keys;  // (B, N)
};

// The group's query terms (the probability metrics'), in shared memory.
template <int TN>
struct QueryTerms {
  float a[TN], b[TN];
  bool inv[TN];

  __device__ __forceinline__ lt::RowTerm operator[](int j) const { return {a[j], b[j], inv[j]}; }
};

// A pair's distance from its score (ElemStep<M>::score: the running value,
// or Bray-Curtis's finished distance) and the two rows' terms.
template <int M>
__device__ __forceinline__ float finish(float score, lt::RowTerm q, lt::RowTerm x) {
  if constexpr (M == lt::kBrayCurtis) return score;
  else return lt::elem_distance<M>(Acc{score, 0.f}, q, x);
}

// The epilogue of a tile, on either route: each key oriented (ascending) and
// masked by its row's validity, the stores of a query coalesced.
template <int M, class Tile>
struct ElemKeys {
  using Step = lt::ElemStep<M>;
  RowTerms terms;
  const uint8_t* valid;
  float* keys;
  int N;
  const QueryTerms<Tile::TN>* qt;
  int q0, nq;
  int64_t row_end;

  __device__ __forceinline__ float key(float score, int j, lt::RowTerm xt, bool live) const {
    return lt::to_key(finish<M>(score, (*qt)[j], xt), true, live);
  }

  // the bytes route: thread t's row, every query of the group
  __device__ __forceinline__ void operator()(int64_t tile_row,
                                             const typename Step::Value (&acc)[Tile::TN]) const {
    const int64_t n = tile_row + threadIdx.x;
    if (n >= row_end) return;
    const lt::RowTerm xt = RowTerms::row<M>(terms.x_mass, terms.x_ent, terms.x_inv, n);
    const bool live = valid[n] != 0;
#pragma unroll
    for (int j = 0; j < Tile::TN; ++j)
      if (j < nq) keys[(int64_t)(q0 + j) * N + n] = key(Step::score(acc[j]), j, xt, live);
  }

  // the FMA route: the tile's scores from the shared score tile, a thread a row
  __device__ __forceinline__ void operator()(int64_t tile_row, const float* sc) const {
    static_assert(Tile::kThreads % Tile::TM == 0, "a thread a row");
    const int r = threadIdx.x % Tile::TM;
    const int64_t n = tile_row + r;
    if (n >= row_end) return;
    const lt::RowTerm xt = RowTerms::row<M>(terms.x_mass, terms.x_ent, terms.x_inv, n);
    const bool live = valid[n] != 0;
#pragma unroll 4
    for (int j = threadIdx.x / Tile::TM; j < nq; j += Tile::kThreads / Tile::TM)
      keys[(int64_t)(q0 + j) * N + n] = key(sc[j * Tile::kScoreStride + r], j, xt, live);
  }
};

// A block: query group blockIdx.x % groups over row span blockIdx.x / groups.
template <int M, class Tile, bool kStream>
__global__ void __launch_bounds__(Tile::kThreads) elem_f32_kernel(const ElemArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ QueryTerms<Tile::TN> qt;
  const int group = blockIdx.x % a.groups;
  const int64_t span = blockIdx.x / a.groups;
  const int q0 = group * Tile::TN, nq = min(Tile::TN, a.B - q0);
  const int64_t row0 = span * a.span_rows;
  const int64_t row_end = min((int64_t)a.N, row0 + a.span_rows);
  for (int j = threadIdx.x; j < nq; j += Tile::kThreads) {  // read after the loop's first barrier
    const lt::RowTerm t = RowTerms::row<M>(a.terms.q_mass, a.terms.q_ent, a.terms.q_inv, q0 + j);
    qt.a[j] = t.a;
    qt.b[j] = t.b;
    qt.inv[j] = t.inv;
  }
  const lt::F32Span sp{a.q, a.x, a.D, a.vec, q0, nq, row0, row_end};
  const ElemKeys<M, Tile> epi{a.terms, a.valid, a.keys, a.N, &qt, q0, nq, row_end};
  if constexpr (kStream) {
    lt::stream_span_scores<Tile, lt::ElemStep<M>>(sp, smem, epi);
  } else {
    lt::fma_span_scores<Tile, lt::ElemStep<M>>(sp, smem, epi);
  }
}

template <int M, class Tile, bool kStream>
int launch_f32_tile(ElemArgs a, cudaStream_t stream) {
  const auto kernel = elem_f32_kernel<M, Tile, kStream>;
  static int resident = 0;
  if (resident == 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, Tile::kThreads, Tile::kSmem);
    if (resident < 1) resident = 1;
  }
  const lt::SpanGrid g = lt::span_grid<Tile>(a.B, a.N, resident);
  if (g.blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  a.groups = g.groups;
  a.span_rows = g.span_rows;
  kernel<<<(unsigned)g.blocks, Tile::kThreads, Tile::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The bytes route at B <= 16: the real queries, B rounded up to a power of two.
template <int M>
int route_bytes(const ElemArgs& a, cudaStream_t stream) {
  if (a.B <= 1) return launch_f32_tile<M, lt::BytesTile<1>, true>(a, stream);
  if (a.B <= 2) return launch_f32_tile<M, lt::BytesTile<2>, true>(a, stream);
  if (a.B <= 4) return launch_f32_tile<M, lt::BytesTile<4>, true>(a, stream);
  if (a.B <= 8) return launch_f32_tile<M, lt::BytesTile<8>, true>(a, stream);
  return launch_f32_tile<M, lt::BytesTile<16>, true>(a, stream);
}

// The 64-row tile (common.cuh's; TQ = 16 queries a block to B = 16, else
// 64): the f32 rows' under the rolled metrics above B = 8, and K9's Canberra
// keys over the centred bf16 copy above B = 8 (T bf16, the mean added back).
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

// The route by B. The per-dimension-cheap metrics route as K1: the bytes
// route to B = 16, then the FMA route (32, 64 or 128 queries a block;
// Bray-Curtis's two running values a pair keep it at 8 x 4 a thread). A
// rolled step (Canberra's division, Jensen-Shannon's logarithm) is a long
// dependent chain: the bytes route to B = 8, then the 64-row tile, which
// measured faster there than every FMA-route shape tried (PERF.md).
template <int M>
int route_f32_tile(const ElemArgs& a, cudaStream_t stream) {
  if constexpr (lt::ElemStep<M>::kRolled) {
    if (a.B <= 8) return route_bytes<M>(a, stream);
    return launch_tile<M, float>(a.q, a.x, nullptr, a.B, a.N, a.D, a.terms, a.valid, a.keys,
                                 stream);
  } else {
    if (a.B <= 16) return route_bytes<M>(a, stream);
    if (a.B <= 32) return launch_f32_tile<M, lt::FmaTile<32, 4, 16>, false>(a, stream);
    if constexpr (M == lt::kBrayCurtis) {
      return launch_f32_tile<M, lt::FmaTile<64, 4, 16>, false>(a, stream);
    } else {
      if (a.B <= 64) return launch_f32_tile<M, lt::FmaTile<64, 4, 16>, false>(a, stream);
      return launch_f32_tile<M, lt::FmaTile<128, 8, 8>, false>(a, stream);
    }
  }
}

template <int M>
int launch(const float* q, const float* x, int B, int N, int D, int C, RowTerms terms,
           const uint8_t* valid, const int* ids, float* keys, cudaStream_t stream) {
  if (ids != nullptr) {
    if ((size_t)D * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((C + kGatherSlots - 1) / kGatherSlots), (unsigned)B);
    elem_gather_kernel<M><<<grid, kGatherThreads, D * sizeof(float), stream>>>(q, x, ids, C, D,
                                                                              terms, keys);
    return (int)cudaGetLastError();
  }
  const bool vec = D % 4 == 0 && lt::aligned16(q) && lt::aligned16(x);
  return route_f32_tile<M>(ElemArgs{q, x, B, N, D, vec, 0, 0, terms, valid, keys}, stream);
}

// ── K9: the bf16 pass fused with its top C ─────────────────────────────

constexpr int kTopcPend = lt::WarpTopk::kPend;  // pending entries a list

struct TopcArgs {
  const float* q;              // (B, D)
  const __nv_bfloat16* x16;    // (N, D) centred
  const float* mean;           // (D,)
  const uint8_t* valid;        // (N,)
  const float* start;          // (B,) or null: each query's lowest key that may join
  int B, N, D, C, kp;
  bool vec;
  int span_c;                  // a span holds at least span_c x C rows
  int groups;
  int64_t span_rows;
  uint64_t* lists;             // (blocks, TN, kp + kTopcPend) the lists' entries
  float* out_keys;             // (B, spans * C)
  int* out_ids;
};

TopcArgs topc_args(const float* q, const __nv_bfloat16* x16, const float* mean,
                   const uint8_t* valid, const float* start, int B, int N, int D, int C,
                   bool vec, int span_c, uint64_t* lists, float* out_keys, int* out_ids) {
  return TopcArgs{q, x16, mean, valid, start, B, N, D, C, lt::list_kp(C), vec, span_c, 0, 0,
                  lists, out_keys, out_ids};
}

// One warp: a list's pending entries merged into its kept ones (WarpTopk's
// flush), the state in shared memory updated. Not inlined: one copy serves
// every route and metric.
__device__ __noinline__ void topc_merge(uint64_t* list, int* kept, int* pend, uint64_t* thr,
                                        int kp, int C) {
  lt::WarpTopk t;
  t.list = list;
  t.kept = *kept;
  t.pend = *pend;
  t.thr = *thr;
  t.flush(kp, C);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    *kept = t.kept;
    *pend = 0;
    *thr = t.thr;
  }
  __syncwarp();
}

// Each query's list state, in shared memory: its threshold (an entry joins
// the pending ones only if it is larger: the C-th kept, or while fewer are
// kept (start, INT_MAX), start -inf unless the caller gives a lower key, so
// -inf entries join in id order), its pending and
// kept counts. The entries themselves live in device memory (L2): a list
// takes 8 (kp + 256) bytes, and the group's lists would crowd out the
// tile's stages.
template <int TN>
struct TopcState {
  uint64_t thr[TN];
  int pend[TN], kept[TN];
};

// The running top C of a block's queries over its span of rows. Each
// thread offers its keys of a tile: an entry that beats its query's
// threshold takes a pending slot in the list (one shared atomic for the
// lanes that offer to the same query: a warp, or a half-warp). After a
// barrier, the warp that owns query j (j = warp + warps m) merges its
// pending entries into the kept ones (common.cuh WarpTopk) when another
// tile could overflow them, and raises the threshold. Rows are offered in
// tiles of ascending ids, and packed entries compare exactly, so the kept
// entries are exactly the span's best C whatever order a tile's entries
// join in. The kept entries are never written before the first merge
// (WarpTopk reads an empty list as pads).
template <int TN, int kThreads>
struct TopcLists {
  TopcState<TN>* st;
  uint64_t* lists;
  int kp, C, nq;

  __device__ __forceinline__ uint64_t* list(int j) const {
    return lists + (int64_t)j * (kp + kTopcPend);
  }

  __device__ __forceinline__ void init(const float* start, int q0) const {
    for (int j = threadIdx.x; j < nq; j += kThreads) {
      st->thr[j] = start != nullptr ? lt::pack_entry(start[q0 + j], INT_MAX) : lt::kPadEntry;
      st->pend[j] = st->kept[j] = 0;
    }
  }

  // Row n's key for query j (ok: a row and a query of the block); every
  // lane of the warp calls it, and the kLanes lanes of a group (the warp,
  // or each half) offer to the same query.
  template <int kLanes>
  __device__ __forceinline__ void offer(int j, int64_t n, float key, bool ok) const {
    const uint64_t v = lt::pack_entry(key, (int)n);
    const bool pass = ok && v > st->thr[j];
    const int lane = threadIdx.x & 31;
    const unsigned group = kLanes == 32 ? 0xffffffffu : 0xffffu << (lane & 16);
    const unsigned mine = __ballot_sync(0xffffffffu, pass) & group;
    const int leader = mine ? __ffs(mine) - 1 : lane;
    int base = 0;
    if (mine && lane == leader) base = atomicAdd(&st->pend[j], __popc(mine));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (pass) list(j)[kp + base + __popc(mine & ((1u << lane) - 1))] = v;
  }

  __device__ __forceinline__ void merge(int j) const {
    topc_merge(list(j), &st->kept[j], &st->pend[j], &st->thr[j], kp, C);
  }

  // After a tile's offers (every thread of the block calls it): the lists
  // that could not take another `tm` entries merge.
  __device__ __forceinline__ void settle(int tm) const {
    __syncthreads();
    for (int j = threadIdx.x >> 5; j < nq; j += kThreads / 32)
      if (st->pend[j] > kTopcPend - tm) merge(j);
  }

  // The last merges, then the span's best C of each query (pads past the
  // kept entries).
  __device__ __forceinline__ void finish(const TopcArgs& a, int q0, int64_t span) const {
    const int64_t ld = (int64_t)(gridDim.x / a.groups) * C;
    for (int j = threadIdx.x >> 5; j < nq; j += kThreads / 32) {
      merge(j);
      const uint64_t* l = list(j);
      const int kept = st->kept[j];
      const int64_t o = (int64_t)(q0 + j) * ld + span * C;
      for (int c = threadIdx.x & 31; c < C; c += 32) {
        const uint64_t v = c < kept ? l[c] : lt::kPadEntry;
        a.out_keys[o + c] = lt::entry_key(v);
        a.out_ids[o + c] = lt::entry_id(v);
      }
    }
  }
};

// The routes of the score, each a span of rows for a group of TN queries.
// bytes: Bf16BytesTile<QB> (f32_tile.cuh), a row a thread, the real queries.
template <int QB>
struct TopcBytes {
  using Tile = lt::Bf16BytesTile<QB>;
  static constexpr int TM = Tile::TM, TN = QB, kThreads = Tile::kThreads;
  static constexpr size_t kSmem = Tile::kSmem;

  template <int M, class L>
  __device__ __forceinline__ static void scan(const TopcArgs& a, float* smem, int q0, int nq,
                                              int64_t row0, int64_t row_end, const L& lists) {
    using Step = lt::ElemStep<M>;
    const lt::Bf16Span sp{a.q, a.x16, a.mean, a.D, true, q0, nq, row0, row_end};
    const auto epi = [&](int64_t tile_row, const typename Step::Value (&acc)[QB]) {
      const int64_t n = tile_row + threadIdx.x;
      const bool in = n < row_end;
      const bool live = in && a.valid[n] != 0;
#pragma unroll
      for (int j = 0; j < QB; ++j)
        if (j < nq)
          lists.template offer<32>(j, n, lt::to_key(Step::score(acc[j]), true, live), in);
      lists.settle(TM);
    };
    lt::stream_span_scores<Tile, Step>(sp, smem, epi);
  }
};

// FMA: FmaTile<TN, RN, KC> (K6c's f32 shapes), register tiles, the scores
// through the shared score tile; each thread offers its 8 rows x RN
// queries.
template <int TN_, int RN, int KC>
struct TopcFma {
  using Tile = lt::FmaTile<TN_, RN, KC>;
  static constexpr int TM = Tile::TM, TN = TN_, kThreads = Tile::kThreads;
  static constexpr size_t kSmem = Tile::kSmem;

  template <int M, class L>
  __device__ __forceinline__ static void scan(const TopcArgs& a, float* smem, int q0, int nq,
                                              int64_t row0, int64_t row_end, const L& lists) {
    const lt::Bf16Span sp{a.q, a.x16, a.mean, a.D, a.vec, q0, nq, row0, row_end};
    const auto epi = [&](int64_t tile_row, const float* sc) {
      const int tr = Tile::tr(), tq = Tile::tq();
#pragma unroll
      for (int g = 0; g < Tile::RM / 4; ++g) {
        float v[RN][4];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
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
          const bool in = n < row_end;
          const bool live = in && a.valid[n] != 0;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int qj = Tile::query(tq, j);  // one a half-warp
            lists.template offer<16>(qj, n, lt::to_key(v[j][e], true, live), in && qj < nq);
          }
        }
      }
      lists.settle(TM);
    };
    lt::fma_span_scores<Tile, lt::ElemStep<M>>(sp, smem, epi);
  }
};

// A block: query group blockIdx.x % groups over row span blockIdx.x / groups.
template <int M, class R>
__global__ void __launch_bounds__(R::kThreads) elem_topc_kernel(const TopcArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TopcState<R::TN> st;
  const int group = blockIdx.x % a.groups;
  const int64_t span = blockIdx.x / a.groups;
  const int q0 = group * R::TN, nq = min(R::TN, a.B - q0);
  const int64_t row0 = span * a.span_rows;
  const int64_t row_end = min((int64_t)a.N, row0 + a.span_rows);
  const TopcLists<R::TN, R::kThreads> lists{
      &st, a.lists + (int64_t)blockIdx.x * R::TN * (a.kp + kTopcPend), a.kp, a.C, nq};
  lists.init(a.start, q0);  // read after the route's first barrier
  R::template scan<M>(a, smem, q0, nq, row0, row_end, lists);
  lists.finish(a, q0, span);
}

struct TopcPlan {
  int groups, spans;
  int64_t span_rows;
  long long scratch;  // list entries (uint64) in device memory
};

// The grid of a route: one wave of the blocks the card holds at once, spans a
// whole number of tiles, spans x C at most N / span_c (each span's fill and
// the merge after cost C a span); a launch (plan null) or the plan alone.
template <int M, class R>
int topc_run(TopcArgs a, int spans, TopcPlan* plan, cudaStream_t stream) {
  const auto kernel = elem_topc_kernel<M, R>;
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::kSmem);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, R::kThreads, R::kSmem);
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    resident = n;
  }
  TopcPlan p{};
  p.groups = (a.B + R::TN - 1) / R::TN;
  const int64_t tiles = ((int64_t)a.N + R::TM - 1) / R::TM;
  const int64_t most = std::max<int64_t>(1, (int64_t)a.N / ((int64_t)a.span_c * a.C));
  const int64_t wave = std::max<int64_t>(1, (int64_t)resident * lt::sm_count() / p.groups);
  const int64_t want = std::max<int64_t>(1, std::min(tiles, std::min(most, wave)));
  p.span_rows = (tiles + want - 1) / want * R::TM;
  p.spans = (int)((a.N + p.span_rows - 1) / p.span_rows);
  if ((int64_t)p.groups * p.spans > INT_MAX) return (int)cudaErrorInvalidValue;
  p.scratch = (long long)p.groups * p.spans * R::TN * (a.kp + kTopcPend);
  if (plan != nullptr) {
    *plan = p;
    return 0;
  }
  if (spans != p.spans || a.lists == nullptr) return (int)cudaErrorInvalidValue;
  a.groups = p.groups;
  a.span_rows = p.span_rows;
  kernel<<<(unsigned)(p.groups * p.spans), R::kThreads, R::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The route by shape. The bytes route to B = 16 (Canberra, whose division
// makes each step a long dependent chain, to B = 8), the batch rounded up
// to 1, 4 or the route's last size, when the rows take 16-byte copies.
// Chebyshev takes the FMA route past it, and on any unaligned shape (64
// queries a block to B = 64, then 128; the scalar loads where D % 8 != 0 or
// a base is unaligned). Past those, L1, Canberra and Bray-Curtis take the
// 64-row tile's keys and K5 (lt_elementwise_bf16_keys), which measured
// faster than this FMA route on an H100 (PERF.md §6): topc_route returns
// kTopcChain for those shapes, and lt_elem_topc_plan's span count 0 sends
// the caller (ops/scan.py elementwise_topc) to that chain.
constexpr int kTopcChain = -2;

template <int M>
int topc_route(const TopcArgs& a, int spans, TopcPlan* plan, cudaStream_t stream) {
  constexpr int bytes_max = M == lt::kCanberra ? 8 : 16;
  if (a.vec && a.B <= bytes_max) {
    if (a.B <= 1) return topc_run<M, TopcBytes<1>>(a, spans, plan, stream);
    if (a.B <= 4) return topc_run<M, TopcBytes<4>>(a, spans, plan, stream);
    return topc_run<M, TopcBytes<bytes_max>>(a, spans, plan, stream);
  }
  if constexpr (M == lt::kChebyshev) {
    if (a.B <= 64) return topc_run<M, TopcFma<64, 4, 16>>(a, spans, plan, stream);
    return topc_run<M, TopcFma<128, 8, 8>>(a, spans, plan, stream);
  }
  return kTopcChain;
}

int topc_dispatch(const TopcArgs& a, int metric, int spans, TopcPlan* plan,
                  cudaStream_t stream) {
  if (a.B < 1 || a.N < 1 || a.D < 1 || a.C < 1 || a.C > a.N || (a.vec && a.D % 8 != 0) ||
      a.span_c < 1)
    return (int)cudaErrorInvalidValue;
  switch (metric) {
    case lt::kL1: return topc_route<lt::kL1>(a, spans, plan, stream);
    case lt::kChebyshev: return topc_route<lt::kChebyshev>(a, spans, plan, stream);
    case lt::kCanberra: return topc_route<lt::kCanberra>(a, spans, plan, stream);
    case lt::kBrayCurtis: return topc_route<lt::kBrayCurtis>(a, spans, plan, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, D) f32 query rows (the transform's: cdf for Wasserstein, p for
// Jensen-Shannon); x (N, D) the f32 corpus rows; mass / ent / inv the
// probability metrics' per-row terms (null otherwise). Tile mode (ids
// null): keys (B, N) over every row, masked by valid. Gather mode: keys (B,
// C) over the rows ids (B, C) int32. D may be 0 (Wasserstein of a
// one-column row).
extern "C" int lt_elementwise_scores(const float* q, const float* x, const float* q_mass,
                                     const float* q_ent, const uint8_t* q_inv,
                                     const float* x_mass, const float* x_ent,
                                     const uint8_t* x_inv, const uint8_t* valid, const int* ids,
                                     int B, int N, int D, int C, int metric, float* keys,
                                     cudaStream_t stream) {
  if (B < 1 || D < 0 || (ids == nullptr ? N < 1 : C < 1) || B > 65535 || metric < lt::kL1)
    return (int)cudaErrorInvalidValue;
  const RowTerms terms{q_mass, q_ent, q_inv, x_mass, x_ent, x_inv};
  switch (metric) {
    case lt::kL1: return launch<lt::kL1>(q, x, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kChebyshev:
      return launch<lt::kChebyshev>(q, x, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kCanberra:
      return launch<lt::kCanberra>(q, x, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kBrayCurtis:
      return launch<lt::kBrayCurtis>(q, x, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kWasserstein:
      return launch<lt::kWasserstein>(q, x, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kJensenShannon:
      return launch<lt::kJensenShannon>(q, x, B, N, D, C, terms, valid, ids, keys, stream);
    case lt::kHaversine: {
      if (D != 2) return (int)cudaErrorInvalidValue;
      if (ids != nullptr) {
        const dim3 grid((unsigned)((C + 255) / 256), (unsigned)B);
        haversine_gather_kernel<<<grid, 256, 0, stream>>>(q, x, ids, C, keys);
      } else {
        const dim3 grid((unsigned)((N + kGeoThreads - 1) / kGeoThreads),
                        (unsigned)((B + kGeoQueries - 1) / kGeoQueries));
        haversine_tile_kernel<<<grid, kGeoThreads, 0, stream>>>(q, x, valid, B, N, keys);
      }
      return (int)cudaGetLastError();
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// K9's plan for these shapes (span_c: a span holds at least span_c x C
// rows): the span count of lt_elementwise_topc's
// output (what = 0) or the uint64 entries of its device list buffer (what =
// 1); 0 where the route by shape takes the 64-row tile's keys and K5
// (lt_elementwise_bf16_keys) instead; -1 where the shapes are refused. It
// reads the shapes, the route's inputs and the kernels' occupancy.
long long lt_elem_topc_plan(int B, int N, int D, int C, int metric, int vec, int span_c,
                            int what) {
  TopcPlan p{};
  const TopcArgs a = topc_args(nullptr, nullptr, nullptr, nullptr, nullptr, B, N, D, C,
                               vec != 0, span_c, nullptr, nullptr, nullptr);
  const int rc = topc_dispatch(a, metric, 0, &p, nullptr);
  if (rc == kTopcChain) return 0;
  if (rc != 0) return -1;
  return what == 0 ? p.spans : p.scratch;
}

// K9: the top C of K6c's keys over the mean-centred bf16 copy, each span's
// list kept by the block that scores it. q (B, D) f32 queries; x16 (N, D)
// the centred bf16 rows, mean (D,) f32 added back to each value; valid (N,)
// 1 = live row; start (B,) or null: query b's entries with a key below
// start[b] never join (a carried state's C-th key); metric L1, Chebyshev,
// Canberra or Bray-Curtis; vec: D % 8 == 0 and 16-byte aligned q, x16 and
// mean (the 16-byte copies; checked). Writes each span's best C (key, id) a
// query to out_keys / out_ids (B, spans * C), best first, the lower id first
// between equal keys, -inf keys of masked rows kept in id order (start
// null or -inf), (-inf, INT_MAX) where a span has fewer than C entries;
// `spans` and `lists` (its entries) from lt_elem_topc_plan of the same
// shapes. 1 <= C <= N.
int lt_elementwise_topc(const float* q, const __nv_bfloat16* x16, const float* mean,
                        const uint8_t* valid, const float* start, int B, int N, int D, int C,
                        int metric, int vec, int span_c, int spans, uint64_t* lists,
                        float* out_keys, int* out_ids, cudaStream_t stream) {
  if (vec && !(lt::aligned16(q) && lt::aligned16(x16) && lt::aligned16(mean)))
    return (int)cudaErrorInvalidValue;
  const TopcArgs a = topc_args(q, x16, mean, valid, start, B, N, D, C, vec != 0, span_c, lists,
                               out_keys, out_ids);
  return topc_dispatch(a, metric, spans, nullptr, stream);
}

// K9's route by shape for L1, Canberra and Bray-Curtis past the fused
// bytes route (lt_elementwise_topc): the keys (B, N) of the 64-row tile over
// the centred bf16 copy with the mean (D,) added back, masked by valid, for
// K5 to select from.
int lt_elementwise_bf16_keys(const float* q, const __nv_bfloat16* x16, const float* mean,
                             const uint8_t* valid, int B, int N, int D, int metric, float* keys,
                             cudaStream_t stream) {
  if (B < 1 || B > 65535 || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const RowTerms terms{};
  switch (metric) {
    case lt::kL1:
      return launch_tile<lt::kL1>(q, x16, mean, B, N, D, terms, valid, keys, stream);
    case lt::kCanberra:
      return launch_tile<lt::kCanberra>(q, x16, mean, B, N, D, terms, valid, keys, stream);
    case lt::kBrayCurtis:
      return launch_tile<lt::kBrayCurtis>(q, x16, mean, B, N, D, terms, valid, keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
