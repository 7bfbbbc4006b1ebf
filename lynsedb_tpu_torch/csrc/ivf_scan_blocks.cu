// ivf_scan_blocks: the IVF probe's block scan. For each query and each of
// its probed block slots, the exact f32 scores of the block's 2,048 rows as
// oriented selection keys (-inf where the slot is empty, the row is padding,
// or the row is not live); K5 then takes the top `fetch` of each query.
//
// Replaces lynsedb_tpu/index/ivf.py _ivf_search_kernel's per-query scan
// (:66-77: gather the probed blocks, D.pairwise at Precision.HIGHEST, mask),
// so the scores are true f32 (FMA, no TF32).
//
// Bound (tools/roofline.py ivf_probe_bound): bytes. Each distinct probed
// block's 2,048 row ids, the live flags of its real rows and the f32 data
// (and |x|^2) of its live rows read once, and the B * nprobe * max_bpc *
// 2,048 keys written; an FMA a dimension of each scored pair is far below
// the f32 rate until hundreds of queries share a block.
// Design: three routes. index/ivf.py _scan_route takes the rows route up to
// SCAN_ROWS_MAX_B queries, else the shared launch, in which the card picks
// the tile or the warp route by how many probes share each probed block
// (ivf_pairs_kernel, from the tile route's lists; no host round trip), as
// measured (PERF.md §6). On the rows
// and tile routes every key is one f32 FMA chain over the dimensions in
// order (f32_tile.cuh, no TF32), keyed by probe_key, so the two give the
// same bits; a row's id and live flag are read before its data, a dead row's
// data and anything past a block's last real row are never read.
//   rows (small B)  a block of 128 threads per (query, slot, quarter of the
//                   block: 512 rows): a slot past its cluster's blocks is
//                   -inf at once; else f32_tile.cuh's bytes route streams
//                   the quarter's rows up to its last real one through a
//                   3-deep cp.async ring of 16-byte copies, a row a thread,
//                   the query beside them: every row's loads in flight.
//   tile (blocks    the probe inverted, as K16b's: on the card, each
//   shared)         probe counted against its cluster, a one-block scan
//                   giving each cluster's list offset and listing the probed
//                   (cluster, block) pairs, each probe placed in its
//                   cluster's list; a grid over that list (blocks past its
//                   count exit at once) gives each pair a block of 128
//                   threads per quarter of its rows, which reads its
//                   cluster's probes (sorted into probe order) and, for each
//                   tile of 32 of them, runs f32_tile.cuh's FMA route
//                   (128-row x 32-query register tiles, 8 x 4 a thread) over
//                   its rows up to their last real one, each read once for
//                   the tile; keys go to each probe's slot. A slot past its
//                   cluster's blocks is -inf by a pass of its own
//                   (ivf_empty_kernel).
//   warp (blocks    the port's first design: a block of 256 threads per
//   rarely shared)  (query, slot), each warp one row at a time, lanes
//                   striding over D and a shuffle sum; each probed block is
//                   read once per query that probes it, and its keys may
//                   differ from the other routes' in the last bits. In the
//                   shared launch its blocks exit at once where the tile was
//                   chosen, and the tile kernel's where the warp was.
//
// K16b, the binary form (IVF-HAMMING, IVF-JACCARD): the same scan over blocks
// of bit-packed rows (2,048 rows x ceil(D / 32) uint32 words, with each row's
// bit count). Replaces _ivf_search_kernel's per-query scan under the binary
// metrics, a bf16 product of the thresholded {0, 1} rows. A row's
// intersection with the query is the popcount of their ANDed words, and
// lt::binary_distance (common.cuh, K6b's epilogue) forms the distance from it
// and the two bit counts: equal to JAX's and the plain version's to the bit.
// Bound: bytes, 128 B of words a 1,024-bit row (256 KB a block, against 1 MB
// a block of f32 rows at D = 128 and 4 MB at D = 1,024), each probed block
// read once, and the (B, slots x 2,048) keys written.
// Design, B >= tile_min_b (the probe inverted): one block of 256 threads per
// (cluster, block slot j of the cluster, part of the block's row tiles: up
// to 4 parts where there are few probes). It scans top_c (B x nprobe ints,
// from L2) for the probes of its cluster, in order, into shared memory, and
// exits at once if there are none. It stages its block's ids,
// forms each row's live flag from them in shared memory and finds the
// block's last real row (rows after it are padding, never read). Then for
// each tile of up to 64 of its probes it streams its part of the block's
// rows, 128 rows x 128 bytes a stage, with the tile's query words beside
// them through a 3-deep cp.async
// ring (zero past the row's W words, up to the 256-bit k-step: a zero adds
// nothing to an AND's popcount), and each warp runs mma.sync m16n8k256 .b1
// .and.popc (mma_int.cuh, K6b's tile) over 16 rows x the live n-tiles of 8
// queries. The epilogue keys each (row, query) from the int32 count with
// lt::binary_distance, as the parent did, and stores it at the probe's slot;
// rows past the last real one get -inf. So every probed block is read once
// for all the queries that probe it.
// Design, B < tile_min_b (a row a thread): a block of 128 threads per
// (query, slot, quarter of the block), each thread 4 rows; a row's id, its
// live flag and its words (16-byte loads where W % 4 == 0) are loaded
// together once the id says the row is real, the popcount runs in registers
// against the query's words in shared memory, with no shuffle.
#include <algorithm>

#include "common.cuh"
#include "f32_tile.cuh"
#include "mma_int.cuh"

namespace {

constexpr int kBlockRows = 2048;  // index/ivf.py BLOCK_SIZE

// ---- K16 ----

using RowTile = lt::BytesTile<1>;          // the row route: a row a thread
constexpr int kRowRouteParts = 4;          // blocks of threads a slot
constexpr int kPartRows = kBlockRows / kRowRouteParts;
using ProbeTile = lt::FmaTile<32, 4, 16>;  // the tile route: 32 probes x 128 rows
constexpr int kProbeCap = 1024;            // probes a round of a block's list
constexpr int kFillThreads = 128;
constexpr int kWarpThreads = 256;          // the warp route's block
// lt_ivf_scan_blocks's routes (index/ivf.py SCAN_ROUTES)
constexpr int kRowsRoute = 0, kTileRoute = 1, kWarpRoute = 2, kSharedRoute = 3;

// A row's key from its dot product with the query and the two squared norms,
// as D.pairwise forms it; both routes form every key with it.
__device__ __forceinline__ float probe_key(float ip, float q_sq, float x_sq, int metric,
                                           bool ascending) {
  float score;
  if (metric == lt::kIP) {
    score = ip;
  } else if (metric == lt::kL2) {
    score = lt::clamp_nonneg(__fmaf_rn(-2.f, ip, __fadd_rn(q_sq, x_sq)));
  } else {
    score = lt::cosine_distance(ip, sqrtf(q_sq * x_sq));
  }
  return lt::to_key(score, ascending, true);
}

// Writes -inf to n floats from out (16-byte aligned, n % 4 == 0).
__device__ __forceinline__ void fill_neg(float* out, int n, int threads) {
  const float4 neg = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  for (int e = threadIdx.x; e < n / 4; e += threads) reinterpret_cast<float4*>(out)[e] = neg;
}

// The row route: part blockIdx.z (512 rows) of slot blockIdx.x of query
// blockIdx.y. A slot past its cluster's blocks is -inf at once. Otherwise
// the part's row ids come first, with each real row's live flag, and give
// the part's last real row; then f32_tile.cuh's bytes route streams the
// rows up to it through its cp.async ring (a dead row is never read), the
// query beside them, and each thread keys its row.
__global__ void __launch_bounds__(RowTile::kThreads)
    ivf_rows_kernel(const float* __restrict__ q, const float* __restrict__ qsq,
                    const int* __restrict__ top_c, int nprobe,
                    const int* __restrict__ cluster_blocks, int max_bpc,
                    const float* __restrict__ blocks, const float* __restrict__ block_sq,
                    const int* __restrict__ block_orig, const uint8_t* __restrict__ live, int D,
                    int metric, bool ascending, bool vec, float* __restrict__ keys) {
  extern __shared__ __align__(16) float ring[];
  __shared__ uint8_t flags[kPartRows];
  __shared__ int last_real;
  const int s = blockIdx.x, b = blockIdx.y, slots = gridDim.x;
  const int p0 = blockIdx.z * kPartRows;
  float* out = keys + ((int64_t)b * slots + s) * kBlockRows + p0;
  const int cluster = top_c[(int64_t)b * nprobe + s / max_bpc];
  const int blk = cluster_blocks[(int64_t)cluster * max_bpc + s % max_bpc];
  if (blk < 0) {  // the cluster has fewer blocks than the widest one
    fill_neg(out, kPartRows, RowTile::kThreads);
    return;
  }
  const int64_t row0 = (int64_t)blk * kBlockRows + p0;
  if (threadIdx.x == 0) last_real = -1;
  __syncthreads();
  int last = -1;
  for (int r = threadIdx.x; r < kPartRows; r += RowTile::kThreads) {
    const int orig = __ldg(block_orig + row0 + r);
    flags[r] = orig >= 0 && __ldg(live + orig) != 0;
    if (orig >= 0) last = r;
  }
  if (last >= 0) atomicMax(&last_real, last);
  __syncthreads();
  const int fill = last_real + 1;
  for (int r = fill + threadIdx.x; r < kPartRows; r += RowTile::kThreads) out[r] = -INFINITY;
  if (fill == 0) return;
  const float q_sq = metric == lt::kIP ? 0.f : qsq[b];
  const lt::ProbeSpan sp{{q, blocks, D, vec, b, 1, row0, row0 + fill}, flags, row0, nullptr, 0};
  const auto epi = [&](int64_t tile_row, const float (&acc)[1]) {
    const int r = (int)(tile_row - row0) + threadIdx.x;
    if (r >= fill) return;
    const float x_sq = flags[r] && metric != lt::kIP ? __ldg(block_sq + row0 + r) : 0.f;
    out[r] = flags[r] ? probe_key(acc[0], q_sq, x_sq, metric, ascending) : -INFINITY;
  };
  lt::stream_span_scores<RowTile>(sp, ring, epi);
}

// The warp route (the port's first design, kept where it measured faster:
// the shared route's batches whose probes rarely share a block): a block of
// 256 threads per (query blockIdx.y, slot blockIdx.x), each warp one row at
// a time, lanes striding over D and a shuffle sum, so its keys may differ
// from the other routes' in the last bits (within K16's tolerance of the
// plain version). ``chosen`` (the shared route's flag, null when forced):
// every block exits at once unless it is kWarpRoute.
__global__ void __launch_bounds__(kWarpThreads)
    ivf_warp_kernel(const float* __restrict__ q, const float* __restrict__ qsq,
                    const int* __restrict__ top_c, int nprobe,
                    const int* __restrict__ cluster_blocks, int max_bpc,
                    const float* __restrict__ blocks, const float* __restrict__ block_sq,
                    const int* __restrict__ block_orig, const uint8_t* __restrict__ live, int D,
                    int metric, bool ascending, const int* __restrict__ chosen,
                    float* __restrict__ keys) {
  extern __shared__ float qs[];  // (D,)
  if (chosen != nullptr && *chosen != kWarpRoute) return;  // the shared launch took the tile
  const int s = blockIdx.x, b = blockIdx.y, slots = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = keys + ((int64_t)b * slots + s) * kBlockRows;
  const int cluster = top_c[(int64_t)b * nprobe + s / max_bpc];
  const int blk = cluster_blocks[(int64_t)cluster * max_bpc + s % max_bpc];
  if (blk < 0) {  // the cluster has fewer blocks than the widest one
    fill_neg(out, kBlockRows, kWarpThreads);
    return;
  }
  for (int d = threadIdx.x; d < D; d += kWarpThreads) qs[d] = q[(int64_t)b * D + d];
  __syncthreads();
  const float q_sq = metric == lt::kIP ? 0.f : qsq[b];
  const int64_t row0 = (int64_t)blk * kBlockRows;
  for (int r = warp; r < kBlockRows; r += kWarpThreads / 32) {
    const int orig = block_orig[row0 + r];
    float key = -INFINITY;
    if (orig >= 0 && live[orig]) {  // uniform across the warp
      const float* xr = blocks + (row0 + r) * D;
      float ip = 0.f;
      for (int d = lane; d < D; d += 32) ip = fmaf(qs[d], __ldg(xr + d), ip);
      ip = lt::warp_sum(ip);
      float score;
      if (metric == lt::kIP) {
        score = ip;
      } else if (metric == lt::kL2) {
        score = lt::clamp_nonneg(q_sq + block_sq[row0 + r] - 2.f * ip);
      } else {
        score = lt::cosine_distance(ip, sqrtf(q_sq * block_sq[row0 + r]));
      }
      key = lt::to_key(score, ascending, true);
    }
    if (lane == 0) out[r] = key;
  }
}

// The tile route's lists, built on the card before it: each probe (b *
// nprobe + p) counted against its cluster (the count before it is its slot
// in the cluster's list; counts zeroed before) ...
__global__ void ivf_count_kernel(const int* __restrict__ top_c, int64_t probes,
                                 int* __restrict__ counts, int* __restrict__ slot) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < probes) slot[e] = atomicAdd(&counts[top_c[e]], 1);
}

// ... then one block scans the counts into each cluster's list offset and
// lists each probed cluster's blocks in cluster order, as c * max_bpc + j
// (j < the cluster's blocks), with their count, and picks the route: the
// tile where the (probe, block) pairs scanned are at least min_share times
// the listed blocks, else the warp route, whose choice empties the list
// (*pairs_n = 0: the tile kernel's blocks exit at once) ...
__global__ void __launch_bounds__(1024)
    ivf_pairs_kernel(const int* __restrict__ counts, const int* __restrict__ cluster_blocks,
                     int n_clusters, int max_bpc, float min_share, int* __restrict__ offsets,
                     int* __restrict__ pairs, int* __restrict__ pairs_n,
                     int* __restrict__ chosen) {
  __shared__ int warp_sum[2][32];
  __shared__ int base[2];  // probes, pairs
  __shared__ unsigned long long scanned;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    base[0] = base[1] = 0;
    scanned = 0;
  }
  unsigned long long mine = 0;  // this thread's clusters' (probe, block) pairs
  for (int c0 = 0; c0 < n_clusters; c0 += 1024) {
    const int c = c0 + threadIdx.x;
    const int probes = c < n_clusters ? counts[c] : 0;
    int nb = 0;
    if (probes > 0)
      while (nb < max_bpc && cluster_blocks[(int64_t)c * max_bpc + nb] >= 0) ++nb;
    mine += (unsigned long long)probes * nb;
    int x[2] = {probes, nb};  // inclusive scans over the warp, then the warps
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x[k], o);
        if (lane >= o) x[k] += y;
      }
      if (lane == 31) warp_sum[k][warp] = x[k];
    }
    __syncthreads();
    if (warp < 2) {
      int w = warp_sum[warp][lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[warp][lane] = w;
    }
    __syncthreads();
    const int total[2] = {warp_sum[0][31], warp_sum[1][31]};
    const int before[2] = {warp > 0 ? warp_sum[0][warp - 1] : 0,
                           warp > 0 ? warp_sum[1][warp - 1] : 0};
    if (c < n_clusters) offsets[c] = base[0] + before[0] + x[0] - probes;
    const int at = base[1] + before[1] + x[1] - nb;
    for (int i = 0; i < nb; ++i) pairs[at + i] = c * max_bpc + i;
    __syncthreads();  // every thread has read base and warp_sum
    if (threadIdx.x == 0) {
      base[0] += total[0];
      base[1] += total[1];
    }
  }
  __syncthreads();
  if (mine > 0) atomicAdd(&scanned, mine);
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool tile = (double)scanned >= (double)min_share * (double)base[1];
    *chosen = tile ? kTileRoute : kWarpRoute;
    *pairs_n = tile ? base[1] : 0;
  }
}

// ... and each probe placed in its cluster's list (in the atomics' order;
// the tile kernel sorts each list).
__global__ void ivf_place_kernel(const int* __restrict__ top_c, int64_t probes,
                                 const int* __restrict__ offsets, const int* __restrict__ slot,
                                 int* __restrict__ plist) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < probes) plist[offsets[top_c[e]] + slot[e]] = (int)e;
}

// Slots past their cluster's blocks: -inf (the tile route's; a block a slot).
__global__ void __launch_bounds__(kFillThreads)
    ivf_empty_kernel(const int* __restrict__ top_c, int nprobe,
                     const int* __restrict__ cluster_blocks, int max_bpc,
                     float* __restrict__ keys) {
  const int s = blockIdx.x, b = blockIdx.y;
  const int cluster = top_c[(int64_t)b * nprobe + s / max_bpc];
  if (cluster_blocks[(int64_t)cluster * max_bpc + s % max_bpc] >= 0) return;
  fill_neg(keys + ((int64_t)b * gridDim.x + s) * kBlockRows, kBlockRows, kFillThreads);
}

// Sorts list[0, n) ascending in shared memory (a bitonic network over the
// next power of two, INT_MAX past n). Every thread of the block calls it.
template <int kThreads>
__device__ __forceinline__ void sort_probes(int* list, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += kThreads) list[i] = INT_MAX;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1)), k = i + stride;
        const int a = list[i], b = list[k];
        if (((i & size) == 0) == (a > b)) {
          list[i] = b;
          list[k] = a;
        }
      }
      __syncthreads();
    }
}

// The tile route: part blockIdx.x % kRowRouteParts (512 rows) of listed block
// pairs[blockIdx.x / parts] (cluster c, its block j), for every probe of c:
// the part's row ids first (each real row's live flag, its last real row),
// the cluster's probes from its list in probe order (rounds of kProbeCap),
// then for each tile of up to 32 probes f32_tile.cuh's FMA route streams the
// part's rows up to its last real one once (a dead row is never read), each
// query one f32 FMA chain in dimension order, and each key goes to its
// probe's slot; the part's rows past its last real one are -inf.
__global__ void __launch_bounds__(ProbeTile::kThreads)
    ivf_tile_kernel(const float* __restrict__ q, const float* __restrict__ qsq, int nprobe,
                    const int* __restrict__ cluster_blocks, int max_bpc,
                    const int* __restrict__ pairs, const int* __restrict__ pairs_n,
                    const int* __restrict__ counts, const int* __restrict__ offsets,
                    const int* __restrict__ plist, const float* __restrict__ blocks,
                    const float* __restrict__ block_sq, const int* __restrict__ block_orig,
                    const uint8_t* __restrict__ live, int D, int metric, bool ascending,
                    bool vec, float* __restrict__ keys) {
  extern __shared__ __align__(16) float tile_stages[];
  __shared__ int list[kProbeCap];
  __shared__ uint8_t flags[kPartRows];
  __shared__ float q_sq[ProbeTile::TN];
  __shared__ int last_real;
  const int pair = blockIdx.x / kRowRouteParts, p0 = (blockIdx.x % kRowRouteParts) * kPartRows;
  if (pair >= *pairs_n) return;
  const int cj = pairs[pair], c = cj / max_bpc, j = cj % max_bpc;
  const int64_t row0 = (int64_t)cluster_blocks[cj] * kBlockRows + p0;
  if (threadIdx.x == 0) last_real = -1;
  __syncthreads();
  int last = -1;
  for (int r = threadIdx.x; r < kPartRows; r += ProbeTile::kThreads) {
    const int orig = __ldg(block_orig + row0 + r);
    flags[r] = orig >= 0 && __ldg(live + orig) != 0;
    if (orig >= 0) last = r;
  }
  if (last >= 0) atomicMax(&last_real, last);
  const int found = counts[c], first = offsets[c];
  for (int l0 = 0; l0 < found; l0 += kProbeCap) {
    const int nl = min(kProbeCap, found - l0);
    __syncthreads();  // flags and last_real written; the last round's list read
    for (int i = threadIdx.x; i < nl; i += ProbeTile::kThreads) list[i] = plist[first + l0 + i];
    sort_probes<ProbeTile::kThreads>(list, nl);
    const int fill = last_real + 1;
    for (int i = 0; i < nl; ++i) {  // the part's rows past its last real one
      float* out = keys + ((int64_t)list[i] * max_bpc + j) * kBlockRows + p0;
      for (int r = fill + threadIdx.x; r < kPartRows; r += ProbeTile::kThreads) out[r] = -INFINITY;
    }
    for (int t0 = 0; t0 < nl && fill > 0; t0 += ProbeTile::TN) {
      const int nq = min(ProbeTile::TN, nl - t0);
      for (int i = threadIdx.x; i < nq; i += ProbeTile::kThreads)
        q_sq[i] = metric == lt::kIP ? 0.f : qsq[list[t0 + i] / nprobe];
      // read after fma_span_scores's first barrier
      const lt::ProbeSpan sp{{q, blocks, D, vec, t0, nq, row0, row0 + fill}, flags, row0, list,
                             nprobe};
      // row rr's key for probe k of the tile from its dot product
      const auto put = [&](int rr, int k, float ip) {
        const bool ok = flags[rr] != 0;
        const float x_sq = ok && metric != lt::kIP ? __ldg(block_sq + row0 + rr) : 0.f;
        float* out = keys + ((int64_t)list[t0 + k] * max_bpc + j) * kBlockRows + p0;
        out[rr] = ok ? probe_key(ip, q_sq[k], x_sq, metric, ascending) : -INFINITY;
      };
      const auto epi = [&](int64_t tile_row, const float* sc) {
        const int r = threadIdx.x % ProbeTile::TM, rr = (int)(tile_row - row0) + r;
        if (rr >= fill) return;
        for (int k = threadIdx.x / ProbeTile::TM; k < nq; k += ProbeTile::kThreads / ProbeTile::TM)
          put(rr, k, sc[k * ProbeTile::kScoreStride + r]);
      };
      lt::fma_span_scores<ProbeTile>(sp, tile_stages, epi);
      __syncthreads();  // q_sq, the stages and the score tile are reused
    }
  }
}

// ---- K16b ----

constexpr int kRowThreads = 128;              // the row route's block
constexpr int kRowParts = 4;                  // blocks a slot: 512 rows each
constexpr int kRowsPerThread = kBlockRows / (kRowParts * kRowThreads);
constexpr int kTileQ = 64;                    // queries (probes) a tile: 8 n-tiles
constexpr int kTileRows = 128;                // rows a stage: 8 warps x 16
constexpr int kTileStride = lt::kIntStride;   // a staged row or query (144 B)
constexpr int kTileSlot = (kTileRows + kTileQ) * kTileStride;
constexpr int kListCap = 4096;                // probes a round of the inverted list
constexpr int kTileSplits = 4;                // blocks of threads a block of the index, at most
constexpr size_t kTileSmem = (size_t)lt::kIntStages * kTileSlot + kListCap * 4 + kBlockRows +
                             kTileQ * 4;

// The row route: rows (blockIdx.z * 512 + threadIdx.x + 128 i) of slot
// blockIdx.x of query blockIdx.y.
__global__ void __launch_bounds__(kRowThreads)
    ivf_binary_rows_kernel(const uint32_t* __restrict__ q, const float* __restrict__ qcnt,
                           const int* __restrict__ top_c, int nprobe,
                           const int* __restrict__ cluster_blocks, int max_bpc,
                           const uint32_t* __restrict__ blocks,
                           const float* __restrict__ block_cnt,
                           const int* __restrict__ block_orig, const uint8_t* __restrict__ live,
                           int W, int metric, bool vec, float* __restrict__ keys) {
  extern __shared__ __align__(16) uint32_t qw[];  // (W,) rounded up to 4
  const int s = blockIdx.x, b = blockIdx.y, slots = gridDim.x;
  const int part0 = blockIdx.z * kRowThreads * kRowsPerThread;
  float* out = keys + ((int64_t)b * slots + s) * kBlockRows;
  const int cluster = top_c[(int64_t)b * nprobe + s / max_bpc];
  const int blk = cluster_blocks[(int64_t)cluster * max_bpc + s % max_bpc];
  if (blk < 0) {  // the cluster has fewer blocks than the widest one
    for (int i = 0; i < kRowsPerThread; ++i) out[part0 + i * kRowThreads + threadIdx.x] = -INFINITY;
    return;
  }
  for (int w = threadIdx.x; w < W; w += kRowThreads) qw[w] = q[(int64_t)b * W + w];
  __syncthreads();
  const float cq = qcnt[b];
  const int64_t row0 = (int64_t)blk * kBlockRows;
  int orig[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    orig[i] = __ldg(block_orig + row0 + part0 + i * kRowThreads + threadIdx.x);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = part0 + i * kRowThreads + threadIdx.x;
    float key = -INFINITY;
    if (orig[i] >= 0) {
      const bool ok = __ldg(live + orig[i]) != 0;  // in flight with the words
      const float cx = __ldg(block_cnt + row0 + r);
      const uint32_t* xr = blocks + (row0 + r) * W;
      int inter = 0;
      if (vec) {
        const uint4* x4 = reinterpret_cast<const uint4*>(xr);
        const uint4* q4 = reinterpret_cast<const uint4*>(qw);
#pragma unroll 8
        for (int w = 0; w < W / 4; ++w) {
          const uint4 xv = __ldg(x4 + w), qv = q4[w];
          inter += __popc(xv.x & qv.x) + __popc(xv.y & qv.y) + __popc(xv.z & qv.z) +
                   __popc(xv.w & qv.w);
        }
      } else {
        for (int w = 0; w < W; ++w) inter += __popc(__ldg(xr + w) & qw[w]);
      }
      if (ok) key = lt::to_key(lt::binary_distance(metric, (float)inter, cq, cx), true, true);
    }
    out[r] = key;
  }
}

// Bytes [k0, k0 + kc) of the query rows of probes list[0 .. nq) (probe
// b * nprobe + p: query b) into dst, kTileStride a row, zero past row_bytes,
// and zero rows from nq up to nq8. Every thread of the block calls it.
__device__ __forceinline__ void stage_queries(uint8_t* dst, const uint8_t* q, const int* list,
                                              int nprobe, int nq, int nq8, int row_bytes, int k0,
                                              int kc, bool vec) {
  const int seg = vec ? 16 : 4;
  const int per_row = kc / seg;
  for (int e = threadIdx.x; e < nq8 * per_row; e += lt::kIntThreads) {
    const int i = e / per_row;
    const int off = k0 + (e - i * per_row) * seg;
    const int bytes = i < nq ? max(0, min(seg, row_bytes - off)) : 0;
    const uint8_t* src = bytes ? q + (int64_t)(list[i] / nprobe) * row_bytes + off : q;
    uint8_t* d = dst + i * kTileStride + (off - k0);
    if (vec) {
      lt::cp_async16(d, src, bytes);
    } else {
      lt::cp_async4(d, src, bytes);
    }
  }
}

// The tile route: cluster (blockIdx.x / splits) / max_bpc, its block slot
// (blockIdx.x / splits) % max_bpc, that block's part blockIdx.x % splits of
// its row tiles, for every probe of the cluster (see the note at the top);
// the first part of slot 0 also writes -inf to the probes' slots past the
// cluster's last block, and the blocks of those slots exit at once.
__global__ void __launch_bounds__(lt::kIntThreads, 2)
    ivf_binary_tile_kernel(const uint32_t* __restrict__ q, const float* __restrict__ qcnt,
                           const int* __restrict__ top_c, int B, int nprobe,
                           const int* __restrict__ cluster_blocks, int max_bpc,
                           const uint32_t* __restrict__ blocks,
                           const float* __restrict__ block_cnt,
                           const int* __restrict__ block_orig, const uint8_t* __restrict__ live,
                           int W, int metric, bool vec, int splits, float* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* ring = smem;
  int* list = reinterpret_cast<int*>(ring + lt::kIntStages * kTileSlot);
  uint8_t* valid = reinterpret_cast<uint8_t*>(list + kListCap);
  float* qc = reinterpret_cast<float*>(valid + kBlockRows);
  __shared__ int warp_n[lt::kIntThreads / 32];
  __shared__ int last_real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = blockIdx.x % splits, cj = blockIdx.x / splits;
  const int c = cj / max_bpc, j = cj % max_bpc;
  const int blk = cluster_blocks[(int64_t)c * max_bpc + j];
  if (blk < 0 && (j > 0 || part > 0)) return;  // slot 0's first part fills the empty slots
  int nb = 0;                    // the cluster's blocks (-1 padded at the end)
  while (nb < max_bpc && cluster_blocks[(int64_t)c * max_bpc + nb] >= 0) ++nb;
  const int64_t probes = (int64_t)B * nprobe;
  const int64_t row0 = (int64_t)blk * kBlockRows;
  const int row_bytes = W * 4, kbytes = (row_bytes + 31) / 32 * 32;
  const int kchunks = (kbytes + lt::kIntChunk - 1) / lt::kIntChunk;
  bool staged = false;  // the block's live flags, once
  int fill = 0, tiles = 0, t0 = 0, t1 = 0;  // the block's row tiles, and this part's
  for (int64_t round = 0;; ++round) {
    // the probes of cluster c, in order, ranks [round * kListCap, + kListCap)
    int found = 0;
    for (int64_t base = 0; base < probes; base += lt::kIntThreads) {
      const int64_t e = base + threadIdx.x;
      const bool hit = e < probes && __ldg(top_c + e) == c;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < lt::kIntThreads / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      const int64_t rank = found + before + __popc(m & ((1u << lane) - 1)) - round * kListCap;
      if (hit && rank >= 0 && rank < kListCap) list[rank] = (int)e;
      found += total;
      __syncthreads();
    }
    const int nl = (int)min((int64_t)kListCap, found - round * kListCap);
    if (nl <= 0) return;
    if (j == 0 && part == 0 && nb < max_bpc) {  // the slots past the cluster's blocks: -inf
      const int per_probe = (max_bpc - nb) * kBlockRows / 4;
      const float4 neg = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      for (int i = 0; i < nl; ++i) {
        float4* out = reinterpret_cast<float4*>(
            keys + ((int64_t)list[i] * max_bpc + nb) * kBlockRows);
        for (int e = threadIdx.x; e < per_probe; e += lt::kIntThreads) out[e] = neg;
      }
    }
    if (blk >= 0) {
      if (!staged) {  // live flags and the last real row (padding is never read)
        if (threadIdx.x == 0) last_real = -1;
        __syncthreads();
        int last = -1;
        for (int r = threadIdx.x; r < kBlockRows; r += lt::kIntThreads) {
          const int orig = __ldg(block_orig + row0 + r);
          valid[r] = orig >= 0 && __ldg(live + orig) != 0;
          if (orig >= 0) last = r;
        }
        if (last >= 0) atomicMax(&last_real, last);
        __syncthreads();
        fill = last_real + 1;
        tiles = (fill + kTileRows - 1) / kTileRows;
        const int per = (tiles + splits - 1) / splits;
        t0 = min(tiles, part * per);
        t1 = min(tiles, t0 + per);
        staged = true;
      }
      for (int q0 = 0; q0 < nl; q0 += kTileQ) {
        const int nq = min(kTileQ, nl - q0), nq8 = (nq + 7) & ~7;
        const int nt_live = nq8 / 8;
        for (int i = threadIdx.x; i < nq; i += lt::kIntThreads)
          qc[i] = qcnt[list[q0 + i] / nprobe];
        const int steps = (t1 - t0) * kchunks;
        auto load_step = [&](int st) {
          uint8_t* slot = ring + (st % lt::kIntStages) * kTileSlot;
          const int k0 = (st % kchunks) * lt::kIntChunk, kc = min(lt::kIntChunk, kbytes - k0);
          lt::stage_rows(slot, kTileStride, reinterpret_cast<const uint8_t*>(blocks),
                         row0 + (int64_t)(t0 + st / kchunks) * kTileRows, row0 + fill, kTileRows,
                         row_bytes, k0, kc, vec);
          stage_queries(slot + kTileRows * kTileStride, reinterpret_cast<const uint8_t*>(q),
                        list + q0, nprobe, nq, nq8, row_bytes, k0, kc, vec);
        };
#pragma unroll
        for (int st = 0; st < lt::kIntStages - 1; ++st) {
          if (st < steps) load_step(st);
          lt::cp_async_commit();
        }
        int acc[kTileQ / 8][4] = {};
        float cx[2] = {0.f, 0.f};
        const int g = lane >> 2, t = lane & 3;
        for (int st = 0; st < steps; ++st) {
          lt::cp_async_wait<lt::kIntStages - 2>();
          __syncthreads();
          if (st + lt::kIntStages - 1 < steps) load_step(st + lt::kIntStages - 1);
          lt::cp_async_commit();
          const int kc0 = st % kchunks, rt = t0 + st / kchunks;
          const int r0 = rt * kTileRows + warp * 16 + g;  // this lane's rows r0, r0 + 8
          if (kc0 == 0) {  // the tile's bit counts, in flight with its stages
            cx[0] = r0 < fill ? __ldg(block_cnt + row0 + r0) : 0.f;
            cx[1] = r0 + 8 < fill ? __ldg(block_cnt + row0 + r0 + 8) : 0.f;
          }
          const uint8_t* slot = ring + (st % lt::kIntStages) * kTileSlot;
          const int ksteps = min(lt::kIntChunk, kbytes - kc0 * lt::kIntChunk) / 32;
          const uint8_t* arow = slot + (warp * 16 + (lane & 15)) * kTileStride + (lane >> 4) * 16;
          const uint8_t* brow =
              slot + (kTileRows + (lane & 7)) * kTileStride + ((lane >> 3) & 1) * 16;
          for (int ks = 0; ks < ksteps; ++ks) {
            uint32_t af[4];
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
                         : "r"(lt::smem_addr(arow + ks * 32)));
#pragma unroll
            for (int nt = 0; nt < kTileQ / 8; ++nt) {
              if (nt < nt_live) {
                uint32_t bf[2];
                asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                             : "=r"(bf[0]), "=r"(bf[1])
                             : "r"(lt::smem_addr(brow + nt * 8 * kTileStride + ks * 32)));
                lt::mma_int<true>(acc[nt], af, bf);
              }
            }
          }
          if (kc0 != kchunks - 1) continue;
          // the tile's keys: rows r0 and r0 + 8 of each live query
          const bool v0 = r0 < fill && valid[r0], v1 = r0 + 8 < fill && valid[r0 + 8];
#pragma unroll
          for (int nt = 0; nt < kTileQ / 8; ++nt) {
            if (nt < nt_live) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int qi = nt * 8 + 2 * t + e;
                if (qi < nq) {
                  float* out = keys + ((int64_t)list[q0 + qi] * max_bpc + j) * kBlockRows;
                  const float cq = qc[qi];
                  out[r0] = v0 ? lt::to_key(lt::binary_distance(metric, (float)acc[nt][e], cq,
                                                                 cx[0]), true, true)
                               : -INFINITY;
                  out[r0 + 8] = v1 ? lt::to_key(lt::binary_distance(metric, (float)acc[nt][2 + e],
                                                                     cq, cx[1]), true, true)
                                   : -INFINITY;
                }
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
            }
          }
        }
        lt::cp_async_wait<0>();
        // rows past the block's last tile: padding
        for (int i = 0; i < (part == 0 ? nq : 0); ++i) {
          float* out = keys + ((int64_t)list[q0 + i] * max_bpc + j) * kBlockRows;
          for (int r = tiles * kTileRows + threadIdx.x; r < kBlockRows; r += lt::kIntThreads)
            out[r] = -INFINITY;
        }
        __syncthreads();  // the ring, qc and the list are reused
      }
    }
    if ((round + 1) * kListCap >= found) return;
  }
}


}  // namespace

// q (B, D) f32, qsq (B,) f32 (L2 / cosine; null for IP), top_c (B, nprobe)
// int32 probed clusters, cluster_blocks (n_clusters, max_bpc) int32 (-1
// padded), blocks (n_blocks, 2048, D) f32, block_sq (n_blocks * 2048,) f32
// (L2 / cosine; null for IP), block_orig (n_blocks * 2048,) int32 (-1 =
// padding), live (rows,) uint8 -> keys (B, nprobe * max_bpc * 2048) f32.
// route (index/ivf.py SCAN_ROUTES): 0 a row a thread, 1 the probe inverted
// (scratch: lt_ivf_scan_scratch int32 for its lists), 2 a warp a row, 3
// shared: the tile route's lists built, then on the card the tile where the
// (probe, block) pairs scanned are at least min_share times the distinct
// blocks probed, else the warp route (scratch as the tile's; unused by 0
// and 2).
extern "C" int lt_ivf_scan_blocks(const float* q, const float* qsq, const int* top_c, int B,
                                  int nprobe, const int* cluster_blocks, int n_clusters,
                                  int max_bpc, const float* blocks, int n_blocks,
                                  const float* block_sq, const int* block_orig,
                                  const uint8_t* live, int D, int metric, int ascending,
                                  int route, float min_share, int* scratch, float* keys,
                                  cudaStream_t stream) {
  const long long slots = (long long)nprobe * max_bpc;
  if (B < 1 || B > 65535 || nprobe < 1 || max_bpc < 1 || n_clusters < 1 || n_blocks < 1 ||
      slots > INT_MAX || (long long)n_clusters * max_bpc > INT_MAX || D < 1 ||
      (metric != lt::kIP && (qsq == nullptr || block_sq == nullptr)) || !lt::aligned16(keys) ||
      route < kRowsRoute || route > kSharedRoute || !(min_share >= 0.f) ||
      (route >= kWarpRoute && D > 12 * 1024))  // the warp route's query in shared memory
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && lt::aligned16(q) && lt::aligned16(blocks);
  if (route == kRowsRoute) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          ivf_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RowTile::kSmem);
      if (err != cudaSuccess) return (int)err;
      raised = true;
    }
    ivf_rows_kernel<<<dim3((unsigned)slots, B, kRowRouteParts), RowTile::kThreads,
                      RowTile::kSmem, stream>>>(q, qsq, top_c, nprobe, cluster_blocks, max_bpc,
                                                blocks, block_sq, block_orig, live, D, metric,
                                                ascending != 0, vec, keys);
    return (int)cudaGetLastError();
  }
  if (route == kWarpRoute) {
    ivf_warp_kernel<<<dim3((unsigned)slots, B), kWarpThreads, (size_t)D * sizeof(float),
                      stream>>>(q, qsq, top_c, nprobe, cluster_blocks, max_bpc, blocks, block_sq,
                                block_orig, live, D, metric, ascending != 0, nullptr, keys);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ProbeTile::kSmem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const long long probes = (long long)B * nprobe;
  if (probes > INT_MAX) return (int)cudaErrorInvalidValue;
  int* counts = scratch;                  // n_clusters
  int* offsets = counts + n_clusters;     // n_clusters
  int* pairs_n = offsets + n_clusters;    // 1
  int* chosen = pairs_n + 1;              // 1: the route the pairs kernel picked
  int* pairs = chosen + 1;                // n_clusters * max_bpc
  int* slot = pairs + (int64_t)n_clusters * max_bpc;  // probes
  int* plist = slot + probes;             // probes
  const cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)n_clusters * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned probe_blocks = (unsigned)((probes + 255) / 256);
  ivf_count_kernel<<<probe_blocks, 256, 0, stream>>>(top_c, probes, counts, slot);
  ivf_pairs_kernel<<<1, 1024, 0, stream>>>(counts, cluster_blocks, n_clusters, max_bpc,
                                           route == kTileRoute ? 0.f : min_share, offsets, pairs,
                                           pairs_n, chosen);
  ivf_place_kernel<<<probe_blocks, 256, 0, stream>>>(top_c, probes, offsets, slot, plist);
  ivf_empty_kernel<<<dim3((unsigned)slots, B), kFillThreads, 0, stream>>>(
      top_c, nprobe, cluster_blocks, max_bpc, keys);
  // the grid covers every block that can be listed; the blocks past the
  // list's count exit at once
  const long long listed = std::min(probes * max_bpc, (long long)n_blocks);
  if (listed * kRowRouteParts > INT_MAX) return (int)cudaErrorInvalidValue;
  ivf_tile_kernel<<<(unsigned)(listed * kRowRouteParts), ProbeTile::kThreads, ProbeTile::kSmem,
                    stream>>>(q, qsq, nprobe, cluster_blocks, max_bpc, pairs, pairs_n, counts,
                              offsets, plist, blocks, block_sq, block_orig, live, D, metric,
                              ascending != 0, vec, keys);
  if (route == kSharedRoute)  // its blocks exit at once where the pairs kernel chose the tile
    ivf_warp_kernel<<<dim3((unsigned)slots, B), kWarpThreads, (size_t)D * sizeof(float),
                      stream>>>(q, qsq, top_c, nprobe, cluster_blocks, max_bpc, blocks, block_sq,
                                block_orig, live, D, metric, ascending != 0, chosen, keys);
  return (int)cudaGetLastError();
}

// int32 entries of lt_ivf_scan_blocks's scratch: each cluster's count of
// probes and its list's offset, the count of listed blocks, the route the
// pairs kernel chose and up to n_clusters x max_bpc listed blocks, each
// probe's slot and the probe lists.
extern "C" long long lt_ivf_scan_scratch(int n_clusters, int max_bpc, long long probes) {
  return 2LL * n_clusters + 2 + (long long)n_clusters * max_bpc + 2 * probes;
}

// K16b. q (B, W) uint32 words of the thresholded queries, qcnt (B,) their bit
// counts; blocks (n_blocks, 2048, W) words of the rows, block_cnt
// (n_blocks * 2048,) their bit counts; metric lt::kHamming or lt::kJaccard;
// n_clusters the rows of cluster_blocks; B >= tile_min_b takes the tile
// route, a smaller B the row route; the rest and keys as lt_ivf_scan_blocks.
extern "C" int lt_ivf_binary_blocks(const uint32_t* q, const float* qcnt, const int* top_c, int B,
                                    int nprobe, const int* cluster_blocks, int n_clusters,
                                    int max_bpc, const uint32_t* blocks, const float* block_cnt,
                                    const int* block_orig, const uint8_t* live, int W, int metric,
                                    int tile_min_b, float* keys, cudaStream_t stream) {
  const long long slots = (long long)nprobe * max_bpc;
  if (B < 1 || B > 65535 || nprobe < 1 || max_bpc < 1 || n_clusters < 1 || slots > INT_MAX ||
      (long long)n_clusters * max_bpc > INT_MAX || W < 1 || W > 12 * 1024 ||
      metric < lt::kHamming || metric > lt::kDice || !lt::aligned16(keys))
    return (int)cudaErrorInvalidValue;
  if (B < tile_min_b) {
    const bool vec = W % 4 == 0 && lt::aligned16(blocks);
    ivf_binary_rows_kernel<<<dim3((unsigned)slots, B, kRowParts), kRowThreads,
                             (size_t)(W + 3) / 4 * 4 * sizeof(uint32_t), stream>>>(
        q, qcnt, top_c, nprobe, cluster_blocks, max_bpc, blocks, block_cnt, block_orig, live, W,
        metric, vec, keys);
    return (int)cudaGetLastError();
  }
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_binary_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const bool vec = W % 4 == 0 && lt::aligned16(blocks) && lt::aligned16(q);
  // a block's row tiles over up to kTileSplits blocks of threads where few
  // probes give each one little to do (every one scans top_c)
  const long long probes = (long long)B * nprobe;
  const int splits = probes <= 1024 ? kTileSplits : probes <= 4096 ? kTileSplits / 2 : 1;
  if ((long long)n_clusters * max_bpc * splits > INT_MAX) return (int)cudaErrorInvalidValue;
  ivf_binary_tile_kernel<<<(unsigned)(n_clusters * max_bpc * splits), lt::kIntThreads, kTileSmem,
                           stream>>>(q, qcnt, top_c, B, nprobe, cluster_blocks, max_bpc, blocks,
                                     block_cnt, block_orig, live, W, metric, vec, splits, keys);
  return (int)cudaGetLastError();
}
