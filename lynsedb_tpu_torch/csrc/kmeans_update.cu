// kmeans_update: one Lloyd update from an assignment. Per centroid: the sum
// and count of its valid rows, the new centroid (the mean, or the old
// centroid where no row is assigned) and its squared move.
//
// Replaces lynsedb_tpu/ops/kmeans.py _lloyd_step's one-hot segment sum
// (:92-98) and its epilogue (:106-109). The JAX step is deterministic and
// 100 Lloyd steps amplify any reordering, so this kernel is too: no float
// atomics; every sum is taken in row order by one thread.
//
// Bound: bytes. The rows are read once (131 MB at N = 256,000, D = 128:
// about 0.04 ms at 3.35 TB/s); the N * D adds are negligible. Every block
// also reads the whole (N,) assignment vector (1 MB at N = 256,000), which
// stays in the 50 MB L2, so the K passes over it cost L2 bandwidth, not
// device memory.
// Design: one block per centroid walks the assignment vector in row order,
// 1,024 rows a step (4 a thread). A block-wide prefix sum of the matches
// lists the step's matching rows in order in shared memory, and then thread
// t adds dimensions t, t + 256, ... of each listed row into its own
// accumulators. The epilogue divides, writes, and reduces the move in a
// fixed tree.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // assignments a thread tests per step
constexpr int kStep = kThreads * kPer;

__global__ void __launch_bounds__(kThreads)
    kmeans_update_kernel(const float* __restrict__ x, const int* __restrict__ assign,
                         const uint8_t* __restrict__ valid, const float* __restrict__ old_c,
                         int N, int D, float* __restrict__ sums, float* __restrict__ counts,
                         float* __restrict__ new_c, float* __restrict__ moves) {
  extern __shared__ float acc[];  // (D,) this centroid's sums; thread t owns t, t + 256, ...
  __shared__ int rows[kStep];
  __shared__ int warp_tot[kThreads / 32];
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < D; d += kThreads) acc[d] = 0.f;
  long long count = 0;
  for (int base = 0; base < N; base += kStep) {
    int mine[kPer];
    int nm = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int r = base + threadIdx.x * kPer + p;
      if (r < N && assign[r] == c && valid[r]) mine[nm++] = r;
    }
    // exclusive prefix of nm over the block: a warp scan, then the warps'
    // totals in order
    int incl = nm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int offset = incl - nm, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) offset += warp_tot[w];
      total += warp_tot[w];
    }
    for (int t = 0; t < nm; ++t) rows[offset + t] = mine[t];
    __syncthreads();
    for (int m = 0; m < total; ++m) {
      const float* xr = x + (int64_t)rows[m] * D;
      for (int d = threadIdx.x; d < D; d += kThreads) acc[d] += xr[d];
    }
    count += total;
    __syncthreads();  // rows[] and warp_tot[] are rewritten by the next step
  }
  const float cnt = (float)count;
  const float denom = cnt > 1.f ? cnt : 1.f;
  float mv = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const int64_t at = (int64_t)c * D + d;
    const float old = old_c[at];
    const float nv = cnt > 0.f ? acc[d] / denom : old;
    sums[at] = acc[d];
    new_c[at] = nv;
    mv = fmaf(nv - old, nv - old, mv);
  }
  mv = lt::warp_sum(mv);
  if (lane == 0) red[warp] = mv;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    moves[c] = total;
    counts[c] = cnt;
  }
}

}  // namespace

// x (N, D) f32, assign (N,) int32 centroid ids, valid (N,) uint8, old_c
// (K, D) f32 -> sums (K, D), counts (K,), new_c (K, D), moves (K,) f32
// (moves[c] = |new_c[c] - old_c[c]|^2).
extern "C" int lt_kmeans_update(const float* x, const int* assign, const uint8_t* valid,
                                const float* old_c, int N, int K, int D, float* sums,
                                float* counts, float* new_c, float* moves, cudaStream_t stream) {
  if (N < 1 || K < 1 || D < 1 || D > 12 * 1024) return (int)cudaErrorInvalidValue;
  kmeans_update_kernel<<<K, kThreads, (size_t)D * sizeof(float), stream>>>(
      x, assign, valid, old_c, N, D, sums, counts, new_c, moves);
  return (int)cudaGetLastError();
}
