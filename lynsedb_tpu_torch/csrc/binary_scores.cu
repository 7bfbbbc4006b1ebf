// K6b: the binary family (Hamming, Jaccard, Tanimoto, Dice) over bit-packed
// rows: the intersection of a query and a row is the popcount of their ANDed
// words, and the distance follows from it and the two rows' bit counts in f32
// (lt::binary_distance in common.cuh, the JAX package's operations in its
// order), so the distances are equal to the bit to the plain version's and to
// JAX's. The key is the negated distance (every binary metric is ascending),
// -inf for a masked row.
//
// Replaces lynsedb_tpu/ops/distance.py _binary_parts (:177) and _pw_hamming /
// _pw_jaccard / _pw_dice (:182-197), a bf16 product of the {0, 1} rows, inside
// scan.py flat_topk (:190) and rescore_rows (:744, the gather mode).
//
// Bound: bytes. At 1M x 1,024 bits the packed rows are 128 MB (2 GB as bf16
// rows) and the keys 4 * B * N bytes (1 GB at B = 256); the 2 * B * N * W * 32
// bit-operations take a few percent of that time on the integer tensor
// cores (the data sheet gives no b1 rate; at its int8 rate 0.27 ms at B =
// 256), where a thread's __popc of a word a query would take about 2 ms.
// Design: the tile mode is mma_int.cuh's tile with mma.sync m16n8k256
// .b1 .and.popc (a k-step is 256 bits): the batch's query bits held in
// shared memory, the rows streamed once through a cp.async ring (4-byte
// copies where W % 4 != 0: a row is then not 16-byte aligned), the keys
// staged through shared memory into row-contiguous 16-byte stores. The
// gather mode scores explicit rows, a thread a (query, slot).
#include "mma_int.cuh"

namespace {

using lt::binary_distance;

constexpr int kRows = 128;  // slots a block of the gather mode

// The tile's epilogue: the distance of the intersection count and the two
// bit counts, negated (every binary metric is ascending), -inf where masked.
struct BinaryEpilogue {
  static constexpr int kTerms = 1;
  const float* term[kTerms];  // (N,) the rows' bit counts
  const uint8_t* valid;       // (N,) 1 = live row
  const float* qcnt;          // (B,)
  int metric;

  struct Query {
    float cnt = 0.f;
  };
  __device__ __forceinline__ Query query(int b) const { return {__ldg(qcnt + b)}; }
  __device__ __forceinline__ float key(const Query& q, float cnt, float, float, bool live,
                                       int inter) const {
    return lt::to_key(binary_distance(metric, (float)inter, q.cnt, cnt), true, live);
  }
};

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
// counts. Tile mode (ids null): keys (B, N) over every row, masked by valid;
// W at most 4,092 words (130,944 bits: a group of 8 queries fits in shared
// memory). Gather mode: keys (B, C) over the rows ids (B, C) int32.
extern "C" int lt_binary_scores(const uint32_t* q, const uint32_t* x, const float* qcnt,
                                const float* xcnt, const uint8_t* valid, const int* ids, int B,
                                int N, int W, int C, int metric, float* keys,
                                cudaStream_t stream) {
  if (B < 1 || W < 1 || metric < lt::kHamming || metric > lt::kDice)
    return (int)cudaErrorInvalidValue;
  if (ids != nullptr) {
    if (C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((C + kRows - 1) / kRows), (unsigned)B);
    binary_gather_kernel<<<grid, kRows, 0, stream>>>(q, x, qcnt, xcnt, ids, C, W, metric, keys);
    return (int)cudaGetLastError();
  }
  if (W > 4092) return (int)cudaErrorInvalidValue;
  const BinaryEpilogue epi{{xcnt}, valid, qcnt, metric};
  return lt::int_tile_scores<true>(reinterpret_cast<const uint8_t*>(q),
                                   reinterpret_cast<const uint8_t*>(x), B, N, 4 * W, epi, keys,
                                   stream);
}
