// The exact f32 score tile of K1 and K6a (flat_scores_f32.cu), K6c's f32
// tile mode and K9 (elementwise_scores.cu: Bf16Span, the centred bf16 rows
// with the mean added back), K16 (ivf_scan_blocks.cu: ProbeSpan, a block of
// the IVF index, dead rows never read, the queries through its probe list)
// and K19 (topl_scan.cu): each query's dot
// product with each corpus row as one f32 FMA chain over the dimensions in
// order (no TF32, no tensor cores); on either route the inner step may
// instead be an elementwise metric's accumulate<M> (metrics.cuh), one
// rounded operation at a time in the same order (K6c, K19's metric mode).
//
// A block takes a span of corpus rows for a group of queries and walks it in
// tiles of rows, a stage of dimensions at a time; the stages run on across
// tile boundaries, so the loads of the next tile fly while this one
// computes. After a tile's last stage the caller's epilogue takes the
// accumulators and the loop clears them. Two routes, chosen by B
// (flat_scores_f32.cu, elementwise_scores.cu):
//   bytes (B <= 16)  BytesTile<QB>, QB = B rounded up to 1, 2, 4, 8 or 16:
//                    128-row tiles of 32 dimensions through a 3-deep cp.async
//                    ring of 16-byte copies, a row a thread, every real query
//                    in every thread; the read of the corpus sets the time.
//   FMA (B > 16)     FmaTile<TN, RN, KC>, TN = 32, 64 or 128 queries: 128-row
//                    tiles of KC dimensions, loaded into registers (16 bytes
//                    a load) while the last stage computes and stored k-major
//                    into one of two shared stages; each thread makes an
//                    8 x RN outer product a dimension from 16-byte shared
//                    reads; a tile's dot products leave through a shared
//                    score tile, so the epilogue holds no accumulators; the
//                    FMAs set the time.
// A row-major (N, D) float corpus whose D is a multiple of 4 and whose bases
// are 16-byte aligned is loaded 16 bytes at a time; any other takes scalar
// loads on the same route (a route by shape).
#pragma once

#include <algorithm>
#include <type_traits>

#include "metrics.cuh"

namespace lt {

// The grid of a kernel that walks spans of rows with one of these tiles (K1,
// K6c): one wave of the `resident` blocks an SM holds on every SM, spans a
// whole number of tiles; block i takes query group i % groups of span i /
// groups, so the groups of a span re-read it from L2 together.
struct SpanGrid {
  int groups;
  int64_t span_rows, blocks;
};

template <class Tile>
inline SpanGrid span_grid(int B, int N, int resident) {
  SpanGrid g;
  g.groups = (B + Tile::TN - 1) / Tile::TN;
  const int64_t tiles = ((int64_t)N + Tile::TM - 1) / Tile::TM;
  const int64_t spans = std::max<int64_t>(
      1, std::min<int64_t>(tiles, (int64_t)resident * sm_count() / g.groups));
  g.span_rows = (tiles + spans - 1) / spans * Tile::TM;
  g.blocks = (int64_t)g.groups * ((N + g.span_rows - 1) / g.span_rows);
  return g;
}

// ── the bytes route: a cp.async ring, a row a thread ─────────────────────

// 128 rows x QB queries a block, 32 dimensions a stage, 3 stages (62 KB at
// QB = 16: three blocks an SM); thread t holds row t and every query. (On an
// H100 at B = 1 and 16, 64-dimension stages, 256-row tiles, a fourth stage
// or whole 128-dimension rows a stage were no faster.)
template <int QB>
struct BytesTile {
  static constexpr int TM = 128, TN = QB, KC = 32, kStages = 3;
  static constexpr int kThreads = TM;
  static constexpr int kStride = KC + 4;  // floats a staged row: 16-byte reads without conflicts
  static constexpr int kStageFloats = (TM + TN) * kStride;
  static constexpr size_t kSmem = (size_t)kStages * kStageFloats * sizeof(float);
};

// Four values of a row from dimension d (zeros past D): one 16-byte load
// (vec) or four scalar ones.
__device__ __forceinline__ float4 load_piece(const float* src, int d, int D, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(src + d));
  float4 v = make_float4(__ldg(src + d), 0.f, 0.f, 0.f);
  if (d + 1 < D) v.y = __ldg(src + d + 1);
  if (d + 2 < D) v.z = __ldg(src + d + 2);
  if (d + 3 < D) v.w = __ldg(src + d + 3);
  return v;
}

// One block's work: queries [q0, q0 + nq) of q (B, D) against rows [row0,
// row_end) of x (N, D). vec: 16-byte loads (D % 4 == 0, aligned bases).
// The FMA route reads a span's rows and queries four values at a time
// (row_piece, query_piece), and skips a row whose row_live() is false (a
// zero row to the tile); the spans below change what these read.
struct F32Span {
  const float* q;
  const float* x;
  int D;
  bool vec;
  int q0, nq;
  int64_t row0, row_end;

  __device__ __forceinline__ bool row_live(int64_t) const { return true; }
  __device__ __forceinline__ float4 row_piece(int64_t n, int d) const {
    return load_piece(x + n * D, d, D, vec);
  }
  __device__ __forceinline__ const float* query_row(int j) const {
    return q + (int64_t)(q0 + j) * D;
  }
  __device__ __forceinline__ float4 query_piece(int j, int d) const {
    return load_piece(query_row(j), d, D, vec);
  }
};

// K16's spans over a block of the IVF index: rows whose flag in `live`
// (shared memory, rows from live_base) is 0 are never read; with `probes`
// (K16's tile route), query j of the group is row probes[q0 + j] / nprobe
// of q (the probe's query).
struct ProbeSpan : F32Span {
  const uint8_t* live;
  int64_t live_base;
  const int* probes;
  int nprobe;

  __device__ __forceinline__ bool row_live(int64_t n) const { return live[n - live_base] != 0; }
  __device__ __forceinline__ const float* query_row(int j) const {
    return probes != nullptr ? q + (int64_t)(probes[q0 + j] / nprobe) * D
                             : F32Span::query_row(j);
  }
  __device__ __forceinline__ float4 query_piece(int j, int d) const {
    return load_piece(query_row(j), d, D, vec);
  }
};

// K9's span: the mean-centred bf16 copy x16 (N, D) with the mean (D,) added
// back in f32, each value one rounded add, as the parent tile's
// load_row does; f32 queries. vec: D % 8 == 0 and 16-byte aligned bases
// (the FMA route then loads 8 bytes of a row at a time, the bytes route
// 16).
struct Bf16Span {
  const float* q;
  const __nv_bfloat16* x16;
  const float* mean;
  int D;
  bool vec;
  int q0, nq;
  int64_t row0, row_end;

  __device__ __forceinline__ bool row_live(int64_t) const { return true; }
  __device__ __forceinline__ float4 row_piece(int64_t n, int d) const {
    const __nv_bfloat16* src = x16 + n * D;
    if (vec) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src + d));
      const float4 m = __ldg(reinterpret_cast<const float4*>(mean + d));
      return make_float4(__fadd_rn(__uint_as_float(raw.x << 16), m.x),
                         __fadd_rn(__uint_as_float(raw.x & 0xffff0000u), m.y),
                         __fadd_rn(__uint_as_float(raw.y << 16), m.z),
                         __fadd_rn(__uint_as_float(raw.y & 0xffff0000u), m.w));
    }
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) v[e] = __fadd_rn(__bfloat162float(src[d + e]), __ldg(mean + d + e));
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ float4 query_piece(int j, int d) const {
    return load_piece(q + (int64_t)(q0 + j) * D, d, D, vec);
  }
};

// Stage `step` (tile step / kchunks, dimensions from (step % kchunks) * KC)
// into dst by cp.async, 16 bytes a copy (sp.vec) or 4: TM rows, then TN
// queries; zeros past D, past the span, past the group and for a row that is
// not row_live() (its data is never read).
template <class Tile, class Span,
          class = std::enable_if_t<std::is_base_of<F32Span, Span>::value>>
__device__ __forceinline__ void stream_load_stage(const Span& sp, float* dst, int step,
                                                  int kchunks) {
  const int64_t r0 = sp.row0 + (int64_t)(step / kchunks) * Tile::TM;
  const int k0 = (step % kchunks) * Tile::KC;
  const int per = sp.vec ? 4 : 1;  // floats a copy
  const int copies = Tile::KC / per;  // a row's copies
  for (int c = threadIdx.x; c < (Tile::TM + Tile::TN) * copies; c += Tile::kThreads) {
    const int r = c / copies, col = (c % copies) * per, d = k0 + col;
    const float* src = sp.x;
    bool ok;
    if (r < Tile::TM) {
      ok = r0 + r < sp.row_end && d < sp.D && sp.row_live(r0 + r);
      if (ok) src = sp.x + (r0 + r) * sp.D + d;
    } else {
      ok = r - Tile::TM < sp.nq && d < sp.D;
      if (ok) src = sp.query_row(r - Tile::TM) + d;
    }
    if (sp.vec) {
      cp_async16(dst + r * Tile::kStride + col, src, ok ? 16 : 0);
    } else {
      cp_async4(dst + r * Tile::kStride + col, src, ok ? 4 : 0);
    }
  }
}

// The inner step of either route, acc op= (row value x, query value q) for
// one dimension: FmaStep the dot product's FMA (K1, K6a, K19's product
// modes); ElemStep<M> an elementwise metric's term (K6c; K19 under L1,
// Chebyshev, Wasserstein and Jensen-Shannon), whose running value is one
// float, or two for Bray-Curtis (its denominator); NoStep nothing (K19's
// Haversine keys come from the rows in its epilogue). score(acc) is what a
// pair's running value leaves the loop as: the value itself, or Bray-Curtis's
// finished distance (so the FMA route's score tile stays one float a pair).
// Dimensions past D are zeros on both sides, which leave each running value's
// bits as they are (a value that starts at +0 is never -0). Chebyshev's step
// is accumulate<M>'s max but for a NaN's payload (max.NaN gives the canonical
// NaN), which no key keeps: a NaN distance is a -inf key. kRolled: the
// stage's dimensions in a loop rather than unrolled (Jensen-Shannon's
// logarithm and Canberra's division make an unrolled stage too long for the
// instruction cache).
struct FmaStep {
  using Value = float;
  static constexpr bool kRolled = false;
  __device__ __forceinline__ void operator()(float& acc, float x, float q) const {
    acc = fmaf(x, q, acc);
  }
  __device__ __forceinline__ static float score(float acc) { return acc; }
};

template <int M>
struct ElemStep {
  static_assert(M == kL1 || M == kChebyshev || M == kCanberra || M == kBrayCurtis ||
                    M == kWasserstein || M == kJensenShannon,
                "an elementwise metric with a per-dimension term");
  using Value = std::conditional_t<M == kBrayCurtis, Acc, float>;
  static constexpr bool kRolled = M == kJensenShannon || M == kCanberra;
  __device__ __forceinline__ void operator()(Value& acc, float x, float q) const {
    if constexpr (M == kBrayCurtis) {
      accumulate<M>(acc, q, x);
    } else if constexpr (M == kChebyshev) {
      acc = max_nan(acc, fabsf(q - x));
    } else {
      Acc a{acc, 0.f};
      accumulate<M>(a, q, x);
      acc = a.a;
    }
  }
  __device__ __forceinline__ static float score(const Value& acc) {
    if constexpr (M == kBrayCurtis) return elem_distance<M>(acc, RowTerm{}, RowTerm{});
    else return acc;
  }
};

struct NoStep {
  using Value = float;
  static constexpr bool kRolled = false;
  __device__ __forceinline__ void operator()(float&, float, float) const {}
  __device__ __forceinline__ static float score(float acc) { return acc; }
};

// Tiles a span walks: a row of no dimensions still takes one stage (of
// zeros), so its epilogue runs (K6c's Wasserstein over a one-column row).
__device__ __forceinline__ int span_kchunks(int D, int KC) {
  return D > KC ? (D + KC - 1) / KC : 1;
}

// acc[j] op= the thread's row against query j over one stage, dimension by
// dimension (a rolled step: one dimension an iteration, TN steps).
template <class Tile, class Step>
__device__ __forceinline__ void stream_stage(const F32Span&, const float* st,
                                             typename Step::Value (&acc)[Tile::TN],
                                             const Step& step) {
  const float* xs = st + threadIdx.x * Tile::kStride;
  const float* qs = st + Tile::TM * Tile::kStride;
  if constexpr (Step::kRolled) {
#pragma unroll 1
    for (int k = 0; k < Tile::KC; ++k) {
      const float xv = xs[k];
#pragma unroll
      for (int j = 0; j < Tile::TN; ++j) step(acc[j], xv, qs[j * Tile::kStride + k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < Tile::KC; k += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + k);
#pragma unroll
      for (int j = 0; j < Tile::TN; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + j * Tile::kStride + k);
        step(acc[j], xv.x, qv.x);
        step(acc[j], xv.y, qv.y);
        step(acc[j], xv.z, qv.z);
        step(acc[j], xv.w, qv.w);
      }
    }
  }
}

// ── the bytes route over bf16 rows (K9) ──────────────────────────────────

// BytesTile's shape over the centred bf16 copy: a stage holds the tile's
// 128 rows x 32 dimensions as bf16 (80 bytes a row: its 16-byte reads fall
// on distinct banks), then the QB queries' 32 f32 values, then the mean's
// 32 values; three stages (38 KB at QB = 16). Every copy is 16 bytes
// (Bf16Span::vec: D % 8 == 0, aligned bases; any other shape takes the FMA
// route). Thread t converts its row's values to f32 and adds the mean, one
// rounded add each, once for all the queries.
template <int QB>
struct Bf16BytesTile {
  static constexpr int TM = 128, TN = QB, KC = 32, kStages = 3;
  static constexpr int kThreads = TM;
  static constexpr int kXStride = KC + 8;  // bf16 a staged row
  static constexpr int kQStride = KC + 4;  // floats a staged query
  static constexpr int kXBytes = TM * kXStride * 2;
  static constexpr int kStageFloats = kXBytes / 4 + TN * kQStride + KC;
  static constexpr size_t kSmem = (size_t)kStages * kStageFloats * sizeof(float);
};

template <class Tile>
__device__ __forceinline__ void stream_load_stage(const Bf16Span& sp, float* dst, int step,
                                                  int kchunks) {
  const int64_t r0 = sp.row0 + (int64_t)(step / kchunks) * Tile::TM;
  const int k0 = (step % kchunks) * Tile::KC;
  constexpr int kRow = Tile::KC / 8, kQuery = Tile::KC / 4;  // 16-byte copies a row, a query
  constexpr int kRows = Tile::TM * kRow, kQueries = kRows + Tile::TN * kQuery;
  unsigned char* xs = reinterpret_cast<unsigned char*>(dst);
  float* qs = dst + Tile::kXBytes / 4;
  for (int c = threadIdx.x; c < kQueries + kQuery; c += Tile::kThreads) {
    if (c < kRows) {
      const int r = c / kRow, col = (c % kRow) * 8, d = k0 + col;
      const bool ok = r0 + r < sp.row_end && d < sp.D;
      cp_async16(xs + (r * Tile::kXStride + col) * 2, ok ? sp.x16 + (r0 + r) * sp.D + d : sp.x16,
                 ok ? 16 : 0);
    } else if (c < kQueries) {
      const int j = (c - kRows) / kQuery, col = ((c - kRows) % kQuery) * 4, d = k0 + col;
      const bool ok = j < sp.nq && d < sp.D;
      cp_async16(qs + j * Tile::kQStride + col, ok ? sp.q + (int64_t)(sp.q0 + j) * sp.D + d : sp.q,
                 ok ? 16 : 0);
    } else {
      const int col = (c - kQueries) * 4, d = k0 + col;
      cp_async16(qs + Tile::TN * Tile::kQStride + col, d < sp.D ? sp.mean + d : sp.mean,
                 d < sp.D ? 16 : 0);
    }
  }
}

template <class Tile, class Step>
__device__ __forceinline__ void stream_stage(const Bf16Span&, const float* st,
                                             typename Step::Value (&acc)[Tile::TN],
                                             const Step& step) {
  const __nv_bfloat16* xs =
      reinterpret_cast<const __nv_bfloat16*>(st) + threadIdx.x * Tile::kXStride;
  const float* qs = st + Tile::kXBytes / 4;
  const float* ms = qs + Tile::TN * Tile::kQStride;
  if constexpr (Step::kRolled) {
#pragma unroll 1
    for (int k = 0; k < Tile::KC; ++k) {
      const float xv = __fadd_rn(__bfloat162float(xs[k]), ms[k]);
#pragma unroll
      for (int j = 0; j < Tile::TN; ++j) step(acc[j], xv, qs[j * Tile::kQStride + k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < Tile::KC; k += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + k);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float xv[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[2 * e] = __fadd_rn(__uint_as_float(w[e] << 16), ms[k + 2 * e]);
        xv[2 * e + 1] = __fadd_rn(__uint_as_float(w[e] & 0xffff0000u), ms[k + 2 * e + 1]);
      }
#pragma unroll
      for (int j = 0; j < Tile::TN; ++j) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + j * Tile::kQStride + k);
        const float4 qb = *reinterpret_cast<const float4*>(qs + j * Tile::kQStride + k + 4);
        step(acc[j], xv[0], qa.x);
        step(acc[j], xv[1], qa.y);
        step(acc[j], xv[2], qa.z);
        step(acc[j], xv[3], qa.w);
        step(acc[j], xv[4], qb.x);
        step(acc[j], xv[5], qb.y);
        step(acc[j], xv[6], qb.z);
        step(acc[j], xv[7], qb.w);
      }
    }
  }
}

// The bytes route over the block's span (Step: the inner step, FmaStep's dot
// product unless given): epi(tile_row, acc) after each tile's last stage,
// acc[j] the running value of row tile_row + thread against query q0 + j
// (rows past the span and queries past the group run on zeros and are the
// epilogue's to skip). `ring` is Tile::kSmem bytes of dynamic shared memory.
// The ring runs on across tile boundaries. Span: F32Span or ProbeSpan with
// BytesTile, Bf16Span with Bf16BytesTile.
template <class Tile, class Step = FmaStep, class Span, class Epi>
__device__ __forceinline__ void stream_span_scores(const Span& sp, float* ring, const Epi& epi) {
  const int kchunks = span_kchunks(sp.D, Tile::KC);
  const int tiles = (int)((sp.row_end - sp.row0 + Tile::TM - 1) / Tile::TM);
  const int steps = tiles * kchunks;
#pragma unroll
  for (int s = 0; s < Tile::kStages - 1; ++s) {
    if (s < steps) stream_load_stage<Tile>(sp, ring + s * Tile::kStageFloats, s, kchunks);
    cp_async_commit();
  }
  typename Step::Value acc[Tile::TN] = {};
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<Tile::kStages - 2>();
    __syncthreads();  // stage s has landed; every thread is done with stage s - 1
    const int next = s + Tile::kStages - 1;
    if (next < steps)
      stream_load_stage<Tile>(sp, ring + (next % Tile::kStages) * Tile::kStageFloats, next,
                              kchunks);
    cp_async_commit();
    stream_stage<Tile>(sp, ring + (s % Tile::kStages) * Tile::kStageFloats, acc, Step{});
    if (s % kchunks != kchunks - 1) continue;
    epi(sp.row0 + (int64_t)(s / kchunks) * Tile::TM, acc);
#pragma unroll
    for (int j = 0; j < Tile::TN; ++j) acc[j] = typename Step::Value{};
  }
  cp_async_wait<0>();
}

// ── the FMA route: register-staged k-major stages, an 8 x RN outer product ──

// 128 rows x TN queries (32, 64 or 128) a block, KC dimensions a stage, two
// stages; 16 x QT threads (QT = TN / RN), thread t = 16 tq + tr holding rows
// (i / 4) 64 + 4 tr + i % 4, i < 8, and queries (j / QV) (TN / QG) + QV tq +
// j % QV, j < RN (QV = min(RN, 4) consecutive queries, QG = RN / QV
// groups). A stage is stored k-major (xs[k][row], qs[k][query]), so a thread
// reads its 8 rows and RN queries of one dimension with 16-byte (or 8-byte)
// loads and makes 8 RN FMAs of them. (Measured on an H100 against the other
// shapes tried: the queries fastest in a warp, 8 x 16 a thread at 128
// threads, 16 dimensions a stage at TN = 128, or one block an SM were each
// 2-74% slower at B = 256.)
template <int TN_, int RN_, int KC_>
struct FmaTile {
  static constexpr int TM = 128, TN = TN_, KC = KC_, RM = 8, RN = RN_;
  static constexpr int QV = RN < 4 ? RN : 4, QG = RN / QV, QT = TN / RN;
  static constexpr int kThreads = 16 * QT;
  static constexpr int kXStride = TM + 4, kQStride = TN + 4;  // floats a staged dimension
  static constexpr int kStageFloats = KC * (kXStride + kQStride);
  static constexpr int kScoreStride = TM + 4;  // floats a query of the score tile
  // two stages, then the score tile
  static constexpr size_t kSmem = (2 * (size_t)kStageFloats + TN * kScoreStride) * sizeof(float);
  static constexpr int kLoads = ((TM + TN) * KC / 4 + kThreads - 1) / kThreads;  // float4 a thread

  __device__ __forceinline__ static int tr() { return threadIdx.x % 16; }
  __device__ __forceinline__ static int tq() { return threadIdx.x / 16; }
  __device__ __forceinline__ static int row(int tr, int i) { return (i / 4) * 64 + 4 * tr + i % 4; }
  __device__ __forceinline__ static int query(int tq, int j) {
    return (j / QV) * (TN / QG) + QV * tq + j % QV;
  }
};

// The next stage's 16-byte pieces, loaded into registers while the current
// stage computes: piece c = thread + 256 p covers dimensions 4 (c % (KC /
// 4)) .. of row c / (KC / 4) (the rows, then the queries), as the span
// reads them (row_piece, query_piece); zeros past D, the span and the group,
// and for a row that is not row_live().
template <class Tile, class Span>
__device__ __forceinline__ void fma_load(const Span& sp, int step, int kchunks,
                                         float4 (&pf)[Tile::kLoads]) {
  const int64_t r0 = sp.row0 + (int64_t)(step / kchunks) * Tile::TM;
  const int k0 = (step % kchunks) * Tile::KC;
  constexpr int kPieces = Tile::KC / 4;  // a row's pieces a stage
#pragma unroll
  for (int p = 0; p < Tile::kLoads; ++p) {
    const int c = threadIdx.x + p * Tile::kThreads, r = c / kPieces;
    const int d = k0 + 4 * (c % kPieces);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < sp.D) {
      if (r < Tile::TM) {
        if (r0 + r < sp.row_end && sp.row_live(r0 + r)) v = sp.row_piece(r0 + r, d);
      } else if (r < Tile::TM + Tile::TN && r - Tile::TM < sp.nq) {
        v = sp.query_piece(r - Tile::TM, d);
      }
    }
    pf[p] = v;
  }
}

template <class Tile>
__device__ __forceinline__ void fma_store(float* st, const float4 (&pf)[Tile::kLoads]) {
  constexpr int kPieces = Tile::KC / 4;
#pragma unroll
  for (int p = 0; p < Tile::kLoads; ++p) {
    const int c = threadIdx.x + p * Tile::kThreads, r = c / kPieces, k = 4 * (c % kPieces);
    if (r >= Tile::TM + Tile::TN) continue;
    float* dst = r < Tile::TM ? st + k * Tile::kXStride + r
                              : st + Tile::KC * Tile::kXStride + k * Tile::kQStride + r - Tile::TM;
    const int ld = r < Tile::TM ? Tile::kXStride : Tile::kQStride;
    dst[0] = pf[p].x;
    dst[ld] = pf[p].y;
    dst[2 * ld] = pf[p].z;
    dst[3 * ld] = pf[p].w;
  }
}

// One dimension k of a stage: the thread's 8 rows and RN queries, 8 RN steps.
template <class Tile, class Step>
__device__ __forceinline__ void fma_dim(const float* xs, const float* qs, int k,
                                        typename Step::Value (&acc)[Tile::RM][Tile::RN],
                                        const Step& step) {
  float xv[Tile::RM], qv[Tile::RN];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(xs + k * Tile::kXStride + 64 * g);
    xv[4 * g] = v.x;
    xv[4 * g + 1] = v.y;
    xv[4 * g + 2] = v.z;
    xv[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int g = 0; g < Tile::QG; ++g) {
    const float* src = qs + k * Tile::kQStride + g * (Tile::TN / Tile::QG);
    if constexpr (Tile::QV == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      qv[4 * g] = v.x;
      qv[4 * g + 1] = v.y;
      qv[4 * g + 2] = v.z;
      qv[4 * g + 3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(src);
      qv[2 * g] = v.x;
      qv[2 * g + 1] = v.y;
    }
  }
#pragma unroll
  for (int i = 0; i < Tile::RM; ++i)
#pragma unroll
    for (int j = 0; j < Tile::RN; ++j) step(acc[i][j], xv[i], qv[j]);
}

template <class Tile, class Step>
__device__ __forceinline__ void fma_stage(const float* st,
                                          typename Step::Value (&acc)[Tile::RM][Tile::RN],
                                          const Step& step) {
  const int tr = Tile::tr(), tq = Tile::tq();
  const float* xs = st + 4 * tr;
  const float* qs = st + Tile::KC * Tile::kXStride + Tile::QV * tq;
  if constexpr (Step::kRolled) {
#pragma unroll 1
    for (int k = 0; k < Tile::KC; ++k) fma_dim<Tile>(xs, qs, k, acc, step);
  } else {
#pragma unroll
    for (int k = 0; k < Tile::KC; ++k) fma_dim<Tile>(xs, qs, k, acc, step);
  }
}

// Stores the running values' scores (Step::score) to the score tile
// sc[query][row] (4 rows a 16-byte store) and clears the values.
template <class Tile, class Step>
__device__ __forceinline__ void fma_scores_to_smem(
    float* sc, typename Step::Value (&acc)[Tile::RM][Tile::RN]) {
  const int tr = Tile::tr(), tq = Tile::tq();
#pragma unroll
  for (int j = 0; j < Tile::RN; ++j)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float* dst = sc + Tile::query(tq, j) * Tile::kScoreStride + Tile::row(tr, 4 * g);
      *reinterpret_cast<float4*>(dst) =
          make_float4(Step::score(acc[4 * g][j]), Step::score(acc[4 * g + 1][j]),
                      Step::score(acc[4 * g + 2][j]), Step::score(acc[4 * g + 3][j]));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * g + e][j] = typename Step::Value{};
    }
}

// The FMA route over the block's span (Step: the inner step, FmaStep's dot
// product unless given): after each tile's last stage the values' scores
// go to a shared score tile sc[query][row] (sc[j * (TM + 4) + r]: row
// tile_row + r, query q0 + j) and epi(tile_row, sc) runs, every thread of the
// block, after the stage's barrier, so an epilogue of any cost holds no
// accumulator registers and its stores can coalesce. `smem` is Tile::kSmem
// bytes: two stages, one computed while the next is stored from registers,
// then the score tile; one barrier a stage. The score tile is rewritten at
// the next tile's last stage: when a tile has two stages or more, that step's
// barrier lies between; when it has one (D <= KC), every step is a last one,
// and a barrier after the epilogue keeps a fast warp from overwriting scores
// that others still read.
template <class Tile, class Step = FmaStep, class Span, class Epi>
__device__ __forceinline__ void fma_span_scores(const Span& sp, float* smem, const Epi& epi) {
  const int kchunks = span_kchunks(sp.D, Tile::KC);
  const int tiles = (int)((sp.row_end - sp.row0 + Tile::TM - 1) / Tile::TM);
  const int steps = tiles * kchunks;
  float* sc = smem + 2 * Tile::kStageFloats;
  float4 pf[Tile::kLoads];
  fma_load<Tile>(sp, 0, kchunks, pf);
  fma_store<Tile>(smem, pf);
  __syncthreads();
  typename Step::Value acc[Tile::RM][Tile::RN] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) fma_load<Tile>(sp, s + 1, kchunks, pf);
    fma_stage<Tile>(smem + (s & 1) * Tile::kStageFloats, acc, Step{});
    const bool last = s % kchunks == kchunks - 1;
    if (last) fma_scores_to_smem<Tile, Step>(sc, acc);
    if (s + 1 < steps) fma_store<Tile>(smem + ((s + 1) & 1) * Tile::kStageFloats, pf);
    __syncthreads();  // stage s + 1 and the scores stored; every thread is done with stage s
    if (!last) continue;
    epi(sp.row0 + (int64_t)(s / kchunks) * Tile::TM, sc);
    if (kchunks == 1) __syncthreads();  // the next step rewrites sc at once
  }
}

}  // namespace lt
