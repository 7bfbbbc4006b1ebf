// K6c: the elementwise family — L1, Chebyshev, Canberra, Bray-Curtis,
// Wasserstein (L1 over the rows' cdf transform), Jensen-Shannon (over the
// probability transform) and Haversine — with the metric a template
// parameter, in the modes of the family's jobs: a tile over every f32 row
// (exact search), a tile over the mean-centred bf16 copy with the mean added
// back in f32 (K9's approximate first pass) and an explicit (B, C) row list
// (the gather mode: K10's rescore of shortlists).
//
// Replaces lynsedb_tpu/ops/distance.py _pw_l1 (:199) to _pw_jensen_shannon
// (:254) inside scan.py flat_topk (:190) and flat_scores (:243); scan.py
// bf16_flat_topk (:681, the bf16 mode); scan.py rescore_rows (:744, the gather
// mode). The formulas, with the JAX package's policies (zero-mass, invalid
// and out-of-range rows; IEEE division, logf, sinf, cosf, asinf and sqrtf, no
// flush to zero: Canberra's 1e-45 floor is a denormal), are metrics.cuh's,
// shared with the graph kernels.
//
// Bound (tools/roofline.py elem_tile_bound): at small B the read of the f32
// rows (512 MB at 1M x 128: 0.153 ms at 3.35 TB/s) and the (B, N) key write;
// above, each (pair, dimension)'s f32 instructions (two for the L1 family's
// difference and add, four for Canberra and Bray-Curtis) over the f32
// instruction rate, and Canberra's division and Jensen-Shannon's logarithm
// over the special-function units. Haversine (D = 2) reads 8 bytes a row and
// is bound by its two sines, square root and arcsine a pair at large B.
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
//   Haversine  a row a thread, its GeoRow (radians, cos(lat)) formed once, the
//              block's 64 queries' GeoRows in shared memory, coalesced keys.
//   64-row     common.cuh's tile (TQ queries x 64 rows a block, 16-deep
//              shared stages): the bf16 corpus (K9), the mean added back in
//              f32, and the f32 rows under Canberra and Jensen-Shannon at
//              B > 8.
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

// The 64-row tile (common.cuh's; TQ = 16 queries a block to B = 16, else 64):
// the bf16 corpus's (K9), and the f32 rows' under the rolled metrics above
// B = 8.
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
  const float* xf = static_cast<const float*>(x);
  const bool vec = D % 4 == 0 && lt::aligned16(q) && lt::aligned16(xf);
  return route_f32_tile<M>(ElemArgs{q, xf, B, N, D, vec, 0, 0, terms, valid, keys}, stream);
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
      const float* xf = static_cast<const float*>(x);
      if (ids != nullptr) {
        const dim3 grid((unsigned)((C + 255) / 256), (unsigned)B);
        haversine_gather_kernel<<<grid, 256, 0, stream>>>(q, xf, ids, C, keys);
      } else {
        const dim3 grid((unsigned)((N + kGeoThreads - 1) / kGeoThreads),
                        (unsigned)((B + kGeoQueries - 1) / kGeoQueries));
        haversine_tile_kernel<<<grid, kGeoThreads, 0, stream>>>(q, xf, valid, B, N, keys);
      }
      return (int)cudaGetLastError();
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
