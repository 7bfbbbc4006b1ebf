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
// a block of f32 rows at D = 128 and 4 MB at D = 1,024).
// Design: K16's, one block of 256 threads per (query, slot) and a warp a row:
// lane l ANDs and popcounts words l, l + 32, ..., so a row of 32 words is one
// 128-byte line, and a shuffle sums the integer counts (exact in any order).
#include "common.cuh"

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

__global__ void __launch_bounds__(kThreads)
    ivf_binary_blocks_kernel(const uint32_t* __restrict__ q, const float* __restrict__ qcnt,
                             const int* __restrict__ top_c, int nprobe,
                             const int* __restrict__ cluster_blocks, int max_bpc,
                             const uint32_t* __restrict__ blocks,
                             const float* __restrict__ block_cnt,
                             const int* __restrict__ block_orig, const uint8_t* __restrict__ live,
                             int W, int metric, float* __restrict__ keys) {
  extern __shared__ uint32_t qw[];  // (W,)
  const int s = blockIdx.x, b = blockIdx.y, slots = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = keys + ((int64_t)b * slots + s) * kBlockRows;
  const int cluster = top_c[(int64_t)b * nprobe + s / max_bpc];
  const int blk = cluster_blocks[(int64_t)cluster * max_bpc + s % max_bpc];
  if (blk < 0) {  // the cluster has fewer blocks than the widest one
    for (int e = threadIdx.x; e < kBlockRows; e += kThreads) out[e] = -INFINITY;
    return;
  }
  for (int w = threadIdx.x; w < W; w += kThreads) qw[w] = q[(int64_t)b * W + w];
  __syncthreads();
  const float cq = qcnt[b];
  const int64_t row0 = (int64_t)blk * kBlockRows;
  for (int r = warp; r < kBlockRows; r += kThreads / 32) {
    const int orig = block_orig[row0 + r];
    float key = -INFINITY;
    if (orig >= 0 && live[orig]) {  // uniform across the warp
      const uint32_t* xr = blocks + (row0 + r) * W;
      int inter = 0;
      for (int w = lane; w < W; w += 32) inter += __popc(qw[w] & __ldg(xr + w));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) inter += __shfl_xor_sync(0xffffffffu, inter, o);
      key = lt::to_key(lt::binary_distance(metric, (float)inter, cq, block_cnt[row0 + r]), true,
                       true);
    }
    if (lane == 0) out[r] = key;
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
// the rest and keys as lt_ivf_scan_blocks.
extern "C" int lt_ivf_binary_blocks(const uint32_t* q, const float* qcnt, const int* top_c, int B,
                                    int nprobe, const int* cluster_blocks, int max_bpc,
                                    const uint32_t* blocks, const float* block_cnt,
                                    const int* block_orig, const uint8_t* live, int W, int metric,
                                    float* keys, cudaStream_t stream) {
  const long long slots = (long long)nprobe * max_bpc;
  if (B < 1 || B > 65535 || nprobe < 1 || max_bpc < 1 || slots > INT_MAX || W < 1 ||
      W > 12 * 1024 || metric < lt::kHamming || metric > lt::kDice)
    return (int)cudaErrorInvalidValue;
  ivf_binary_blocks_kernel<<<dim3((unsigned)slots, B), kThreads, (size_t)W * sizeof(uint32_t),
                             stream>>>(q, qcnt, top_c, nprobe, cluster_blocks, max_bpc, blocks,
                                       block_cnt, block_orig, live, W, metric, keys);
  return (int)cudaGetLastError();
}
