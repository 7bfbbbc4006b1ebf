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
// Bound: at B <= 16 the read of the (N, D) corpus (512 MB at 1M x 128, 0.153
// ms at 3.35 TB/s) and the (B, N) key write; above, the 2 * B * N * D f32 FMA
// flops (0.977 ms at B = 256 on an H100 SXM's 67 TFLOP/s at 700 W). The
// gather mode reads C rows a query at random: bytes.
// Design: the pipelined tile of f32_tile.cuh, by B: at B <= 16 a block streams
// 128-row tiles of 32 dimensions through a 3-deep cp.async ring and holds the
// batch's real queries (QB = B rounded up to a power of two, not 16 padded
// ones), a row a thread; above, 128-row x 32/64/128-query block tiles staged
// k-major through registers, an 8 x 4 or 8 x 8 register tile a thread, the
// dot products leaving through a shared score tile. Spans of rows are sized
// so the grid is one wave of the blocks the card holds at once; the query
// group is the fastest grid index, so the groups of a span re-read it from
// L2. The epilogue forms the metric from the dot product and the per-row
// terms and writes the oriented key, -inf for masked rows and NaN, so K5 can
// select without another pass. The gather mode gives each (query, slot) a warp, as
// K11's per-query mode does.
#include "f32_tile.cuh"
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
    return lt::RowTerm{a ? a[i] : 0.f, b ? b[i] : 0.f, inv ? inv[i] != 0 : false};
  }

  __device__ __forceinline__ lt::RowTerm query(int64_t b) const { return row(qa, qb, qinv, b); }
  __device__ __forceinline__ lt::RowTerm corpus(int64_t n) const { return row(xa, xb, xinv, n); }

  __device__ __forceinline__ static float score(int metric, float dot, lt::RowTerm q,
                                                lt::RowTerm x) {
    if (metric == lt::kIP) return dot;
    if (metric == lt::kL2) return lt::clamp_nonneg(q.a + x.a - 2.f * dot);
    if (metric == lt::kCosine) return lt::cosine_distance(dot, sqrtf(q.a * x.a));
    return lt::gemm_distance(metric, dot, q, x);
  }

  __device__ __forceinline__ float score(int b, int64_t n, float dot) const {
    return score(metric, dot, query(b), corpus(n));
  }
};

struct MetricEpilogue {
  MetricTerms terms;
  const uint8_t* valid;  // (N,) 1 = live row
  bool ascending;

  __device__ __forceinline__ float operator()(float dot, lt::RowTerm q, lt::RowTerm x,
                                              bool live) const {
    return lt::to_key(MetricTerms::score(terms.metric, dot, q, x), ascending, live);
  }
};

struct TileArgs {
  const float* q;
  const float* x;
  int B, N, D;
  bool vec;  // 16-byte loads of q and x
  int groups;
  int64_t span_rows;
  MetricEpilogue epi;
  float* keys;  // (B, N)
};

// The group's query terms, in shared memory (read by the epilogue).
template <int TN>
struct QueryTerms {
  float a[TN], b[TN];
  bool inv[TN];

  __device__ __forceinline__ lt::RowTerm operator[](int j) const { return {a[j], b[j], inv[j]}; }
};

// The bytes route's epilogue: thread t's row, every query of the group.
template <class Tile>
struct StreamKeys {
  MetricEpilogue epi;
  float* keys;
  int N;
  const QueryTerms<Tile::TN>* qt;
  int q0, nq;
  int64_t row_end;

  __device__ __forceinline__ void operator()(int64_t tile_row,
                                             const float (&acc)[Tile::TN]) const {
    const int64_t n = tile_row + threadIdx.x;
    if (n >= row_end) return;
    const lt::RowTerm xt = epi.terms.corpus(n);
    const bool live = epi.valid[n] != 0;
#pragma unroll
    for (int j = 0; j < Tile::TN; ++j)
      if (j < nq) keys[(int64_t)(q0 + j) * N + n] = epi(acc[j], (*qt)[j], xt, live);
  }
};

// The FMA route's epilogue: the tile's keys from the shared score tile, a
// thread a row, so each query's stores coalesce.
template <class Tile>
struct FmaKeys {
  MetricEpilogue epi;
  float* keys;
  int N;
  const QueryTerms<Tile::TN>* qt;
  int q0, nq;
  int64_t row_end;

  __device__ __forceinline__ void operator()(int64_t tile_row, const float* sc) const {
    static_assert(Tile::kThreads % Tile::TM == 0, "a thread a row");
    const int r = threadIdx.x % Tile::TM;
    const int64_t n = tile_row + r;
    if (n >= row_end) return;
    const lt::RowTerm xt = epi.terms.corpus(n);
    const bool live = epi.valid[n] != 0;
#pragma unroll 4
    for (int j = threadIdx.x / Tile::TM; j < nq; j += Tile::kThreads / Tile::TM)
      keys[(int64_t)(q0 + j) * N + n] = epi(sc[j * Tile::kScoreStride + r], (*qt)[j], xt, live);
  }
};

template <class Tile>
__device__ __forceinline__ void load_query_terms(const TileArgs& a, QueryTerms<Tile::TN>& qt,
                                                 int q0, int nq) {
  for (int j = threadIdx.x; j < nq; j += Tile::kThreads) {
    const lt::RowTerm t = a.epi.terms.query(q0 + j);
    qt.a[j] = t.a;
    qt.b[j] = t.b;
    qt.inv[j] = t.inv;
  }
}

// A block: query group blockIdx.x % groups over row span blockIdx.x / groups.
template <class Tile, bool kStream>
__global__ void __launch_bounds__(Tile::kThreads, 2) f32_tile_kernel(const TileArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ QueryTerms<Tile::TN> qt;
  const int group = blockIdx.x % a.groups;
  const int64_t span = blockIdx.x / a.groups;
  const int q0 = group * Tile::TN, nq = min(Tile::TN, a.B - q0);
  const int64_t row0 = span * a.span_rows;
  const int64_t row_end = min((int64_t)a.N, row0 + a.span_rows);
  load_query_terms<Tile>(a, qt, q0, nq);  // read after the loop's first barrier
  const lt::F32Span sp{a.q, a.x, a.D, a.vec, q0, nq, row0, row_end};
  if constexpr (kStream) {
    const StreamKeys<Tile> epi{a.epi, a.keys, a.N, &qt, q0, nq, row_end};
    lt::stream_span_scores<Tile>(sp, smem, epi);
  } else {
    const FmaKeys<Tile> epi{a.epi, a.keys, a.N, &qt, q0, nq, row_end};
    lt::fma_span_scores<Tile>(sp, smem, epi);
  }
}

template <class Tile, bool kStream>
int launch_tile(TileArgs a, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    cudaFuncSetAttribute(f32_tile_kernel<Tile, kStream>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, f32_tile_kernel<Tile, kStream>,
                                                  Tile::kThreads, Tile::kSmem);
    if (resident < 1) resident = 1;
  }
  const lt::SpanGrid g = lt::span_grid<Tile>(a.B, a.N, resident);
  if (g.blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  a.groups = g.groups;
  a.span_rows = g.span_rows;
  f32_tile_kernel<Tile, kStream><<<(unsigned)g.blocks, Tile::kThreads, Tile::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The route by B: the bytes route (the real queries, B rounded up to a power
// of two up to 16) or the FMA route (32, 64 or 128 queries a block).
int launch_tile_scores(const TileArgs& a, cudaStream_t stream) {
  if (a.B <= 1) return launch_tile<lt::BytesTile<1>, true>(a, stream);
  if (a.B <= 2) return launch_tile<lt::BytesTile<2>, true>(a, stream);
  if (a.B <= 4) return launch_tile<lt::BytesTile<4>, true>(a, stream);
  if (a.B <= 8) return launch_tile<lt::BytesTile<8>, true>(a, stream);
  if (a.B <= 16) return launch_tile<lt::BytesTile<16>, true>(a, stream);
  if (a.B <= 32) return launch_tile<lt::FmaTile<32, 4, 16>, false>(a, stream);
  if (a.B <= 64) return launch_tile<lt::FmaTile<64, 4, 16>, false>(a, stream);
  return launch_tile<lt::FmaTile<128, 8, 8>, false>(a, stream);
}

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
// (B, N) over every row, masked by valid; the route by B. Gather mode: keys
// (B, C) over the rows ids (B, C) int32.
extern "C" int lt_gemm_metric_scores(const float* q, const float* x, const float* qa,
                                     const float* qb, const uint8_t* qinv, const float* xa,
                                     const float* xb, const uint8_t* xinv, const uint8_t* valid,
                                     const int* ids, int B, int N, int D, int C, int metric,
                                     int ascending, float* keys, cudaStream_t stream) {
  if (B < 1 || D < 1 || metric < lt::kIP || metric > lt::kHellinger)
    return (int)cudaErrorInvalidValue;
  const MetricTerms terms{qa, qb, qinv, xa, xb, xinv, metric};
  if (ids == nullptr) {
    if (N < 1) return (int)cudaErrorInvalidValue;
    const bool vec = D % 4 == 0 && lt::aligned16(q) && lt::aligned16(x);
    const MetricEpilogue epi{terms, valid, ascending != 0};
    const TileArgs a{q, x, B, N, D, vec, 0, 0, epi, keys};
    return launch_tile_scores(a, stream);
  }
  if (C < 1 || B > 65535 || (size_t)D * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kGatherSlots - 1) / kGatherSlots), (unsigned)B);
  metric_gather_kernel<<<grid, kGatherThreads, D * sizeof(float), stream>>>(
      q, x, ids, C, D, terms, ascending != 0, keys);
  return (int)cudaGetLastError();
}
