// ivf_scan_blocks: the IVF probe's block scan. For each query and each of
// its probed block slots, the exact f32 scores of the block's 2,048 rows as
// oriented selection keys (-inf where the slot is empty, the row is padding,
// or the row is not live); K5 then takes the top `fetch` of each query.
//
// Replaces lynsedb_tpu/index/ivf.py _ivf_search_kernel's per-query scan
// (:66-77: gather the probed blocks, D.pairwise at Precision.HIGHEST, mask),
// so the scores are true f32 (FMA, no TF32).
//
// Bound: bytes. Each probed block is 1 MB of f32 rows (2,048 x 128); a batch
// reads every distinct probed block at least once, and B * nprobe * blocks
// per cluster keys are written. The flops (2 * D per row) are far below the
// f32 rate.
// Design: one block of 256 threads per (query, slot). It looks the slot's
// block up (top_c -> cluster_blocks), stages the query in shared memory, and
// each warp scores one row at a time: lanes stride over D, so a row is read
// as whole 128-byte lines, and a shuffle reduction sums. The epilogue forms
// IP, L2 or cosine from the dot product and the row's precomputed |x|^2,
// exactly as D.pairwise does.
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
#include "common.cuh"
#include "mma_int.cuh"

namespace {

constexpr int kBlockRows = 2048;  // index/ivf.py BLOCK_SIZE
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ivf_scan_blocks_kernel(const float* __restrict__ q, const float* __restrict__ qsq,
                           const int* __restrict__ top_c, int nprobe,
                           const int* __restrict__ cluster_blocks, int max_bpc,
                           const float* __restrict__ blocks, const float* __restrict__ block_sq,
                           const int* __restrict__ block_orig, const uint8_t* __restrict__ live,
                           int D, int metric, bool ascending, float* __restrict__ keys) {
  extern __shared__ float qs[];  // (D,)
  const int s = blockIdx.x, b = blockIdx.y, slots = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = keys + ((int64_t)b * slots + s) * kBlockRows;
  const int cluster = top_c[(int64_t)b * nprobe + s / max_bpc];
  const int blk = cluster_blocks[(int64_t)cluster * max_bpc + s % max_bpc];
  if (blk < 0) {  // the cluster has fewer blocks than the widest one
    for (int e = threadIdx.x; e < kBlockRows; e += kThreads) out[e] = -INFINITY;
    return;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) qs[d] = q[(int64_t)b * D + d];
  __syncthreads();
  const float q_sq = metric == lt::kIP ? 0.f : qsq[b];
  const int64_t row0 = (int64_t)blk * kBlockRows;
  for (int r = warp; r < kBlockRows; r += kThreads / 32) {
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
// int32 probed clusters, cluster_blocks (Kc, max_bpc) int32 (-1 padded),
// blocks (n_blocks, 2048, D) f32, block_sq (n_blocks * 2048,) f32 (L2 /
// cosine; null for IP), block_orig (n_blocks * 2048,) int32 (-1 = padding),
// live (rows,) uint8 -> keys (B, nprobe * max_bpc * 2048) f32.
extern "C" int lt_ivf_scan_blocks(const float* q, const float* qsq, const int* top_c, int B,
                                  int nprobe, const int* cluster_blocks, int max_bpc,
                                  const float* blocks, const float* block_sq,
                                  const int* block_orig, const uint8_t* live, int D, int metric,
                                  int ascending, float* keys, cudaStream_t stream) {
  const long long slots = (long long)nprobe * max_bpc;
  if (B < 1 || B > 65535 || nprobe < 1 || max_bpc < 1 || slots > INT_MAX || D < 1 ||
      D > 12 * 1024 || (metric != lt::kIP && (qsq == nullptr || block_sq == nullptr)))
    return (int)cudaErrorInvalidValue;
  ivf_scan_blocks_kernel<<<dim3((unsigned)slots, B), kThreads, (size_t)D * sizeof(float),
                           stream>>>(q, qsq, top_c, nprobe, cluster_blocks, max_bpc, blocks,
                                     block_sq, block_orig, live, D, metric, ascending != 0, keys);
  return (int)cudaGetLastError();
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
