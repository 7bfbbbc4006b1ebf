// K6b: the binary family (Hamming, Jaccard, Tanimoto, Dice) over bit-packed
// rows: the intersection of a query and a row is the popcount of their ANDed
// words, and the distance follows from it and the two rows' bit counts in f32,
// with the JAX package's operations in its order, so the distances are equal to
// the bit to the plain version's and to JAX's:
//   Hamming         cq + cx - 2 inter
//   Jaccard         union = cq + cx - inter; 0 if union == 0,
//   (and Tanimoto)  else 1 - inter / max(union, 1)
//   Dice            total = cq + cx; 0 if total == 0,
//                   else 1 - 2 inter / max(total, 1)
// Every count is an integer below 2^24, so each f32 operation is exact but the
// one division, which rounds the same on both sides. The key is the negated
// distance (every binary metric is ascending), -inf for a masked row.
//
// Replaces lynsedb_tpu/ops/distance.py _binary_parts (:177) and _pw_hamming /
// _pw_jaccard / _pw_dice (:182-197), a bf16 product of the {0, 1} rows, inside
// scan.py flat_topk (:190) and rescore_rows (:744, the gather mode).
//
// Bound: at 1M x 1,024 bits the packed rows are 128 MB (2 GB as bf16 rows).
// At B = 1 and 16 the bytes bound it; at B = 256 the 8.2e9 popcounts do
// (132 SMs x 16 popcounts a clock at 1.98 GHz, about 2 ms), where a bf16
// tensor-core product of the unpacked rows would be bounded near 0.6 ms.
// Design: a block of 128 threads holds 128 rows x 32 words (1,024 bits) in
// shared memory, loaded coalesced, a row a thread (stride 33 words: no bank
// conflicts), and TQ queries' words, read as broadcasts; a thread ANDs and
// popcounts its row against each query and accumulates integer counts, 32
// words at a time for any width. The gather mode scores explicit rows, a
// thread a (query, slot).
#include "common.cuh"

namespace {

enum BinaryMetric : int { kHamming = 0, kJaccard = 1, kDice = 2 };

constexpr int kRows = 128;  // rows a block, one a thread
constexpr int kChunk = 32;  // words staged at a time

__device__ __forceinline__ float binary_distance(int metric, float inter, float cq, float cx) {
  if (metric == kHamming) return __fsub_rn(__fadd_rn(cq, cx), __fmul_rn(2.f, inter));
  if (metric == kJaccard) {
    const float uni = __fsub_rn(__fadd_rn(cq, cx), inter);
    return uni == 0.f ? 0.f : __fsub_rn(1.f, __fdiv_rn(inter, fmaxf(uni, 1.f)));
  }
  const float total = __fadd_rn(cq, cx);
  return total == 0.f ? 0.f : __fsub_rn(1.f, __fdiv_rn(__fmul_rn(2.f, inter), fmaxf(total, 1.f)));
}

template <int TQ>
__global__ void __launch_bounds__(kRows)
    binary_tile_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                       const float* __restrict__ qcnt, const float* __restrict__ xcnt,
                       const uint8_t* __restrict__ valid, int B, int N, int W, int metric,
                       float* __restrict__ keys) {
  __shared__ uint32_t xs[kRows][kChunk + 1];
  __shared__ uint32_t qs[TQ][kChunk];
  const int t = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kRows;
  const int q0 = blockIdx.y * TQ;
  int acc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) acc[i] = 0;
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    const int wc = min(kChunk, W - w0);
    // the tile's rows are contiguous runs of wc words: consecutive threads
    // read consecutive words
    for (int e = t; e < kRows * wc; e += kRows) {
      const int r = e / wc, c = e % wc;
      const int64_t n = n0 + r;
      xs[r][c] = n < N ? __ldg(x + n * W + w0 + c) : 0u;
    }
    for (int e = t; e < TQ * wc; e += kRows) {
      const int r = e / wc, c = e % wc;
      qs[r][c] = q0 + r < B ? __ldg(q + (int64_t)(q0 + r) * W + w0 + c) : 0u;
    }
    __syncthreads();
    for (int c = 0; c < wc; ++c) {
      const uint32_t xw = xs[t][c];
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[i] += __popc(xw & qs[i][c]);
    }
    __syncthreads();
  }
  const int64_t n = n0 + t;
  if (n >= N) return;
  const bool live = valid[n] != 0;
  const float cx = xcnt[n];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int b = q0 + i;
    if (b >= B) break;
    const float d = binary_distance(metric, (float)acc[i], qcnt[b], cx);
    keys[(int64_t)b * N + n] = lt::to_key(d, true, live);
  }
}

// keys[b, c] for the row ids[b, c] (negative: an empty slot, -inf); a thread
// a slot.
__global__ void __launch_bounds__(kRows)
    binary_gather_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                         const float* __restrict__ qcnt, const float* __restrict__ xcnt,
                         const int* __restrict__ ids, int C, int W, int metric,
                         float* __restrict__ keys) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kRows + threadIdx.x;
  if (c >= C) return;
  const int n = ids[(int64_t)b * C + c];
  float key = -INFINITY;
  if (n >= 0) {
    const uint32_t* qr = q + (int64_t)b * W;
    const uint32_t* xr = x + (int64_t)n * W;
    int inter = 0;
    for (int w = 0; w < W; ++w) inter += __popc(__ldg(qr + w) & __ldg(xr + w));
    key = lt::to_key(binary_distance(metric, (float)inter, qcnt[b], xcnt[n]), true, true);
  }
  keys[(int64_t)b * C + c] = key;
}

}  // namespace

// q (B, W) and x (N, W) uint32 words of the bits (column j of a row is bit
// j % 32 of word j / 32, pad bits zero), qcnt (B,) and xcnt (N,) their bit
// counts. Tile mode (ids null): keys (B, N) over every row, masked by valid.
// Gather mode: keys (B, C) over the rows ids (B, C) int32.
extern "C" int lt_binary_scores(const uint32_t* q, const uint32_t* x, const float* qcnt,
                                const float* xcnt, const uint8_t* valid, const int* ids, int B,
                                int N, int W, int C, int metric, float* keys,
                                cudaStream_t stream) {
  if (B < 1 || W < 1 || metric < kHamming || metric > kDice) return (int)cudaErrorInvalidValue;
  if (ids != nullptr) {
    if (C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((C + kRows - 1) / kRows), (unsigned)B);
    binary_gather_kernel<<<grid, kRows, 0, stream>>>(q, x, qcnt, xcnt, ids, C, W, metric, keys);
    return (int)cudaGetLastError();
  }
  if (N < 1) return (int)cudaErrorInvalidValue;
  const unsigned row_blocks = (unsigned)((N + kRows - 1) / kRows);
  if (B == 1) {
    binary_tile_kernel<1><<<dim3(row_blocks, 1), kRows, 0, stream>>>(q, x, qcnt, xcnt, valid, B,
                                                                     N, W, metric, keys);
  } else {
    if ((B + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
    binary_tile_kernel<16><<<dim3(row_blocks, (unsigned)((B + 15) / 16)), kRows, 0, stream>>>(
        q, x, qcnt, xcnt, valid, B, N, W, metric, keys);
  }
  return (int)cudaGetLastError();
}
