// kmeans_assign: the nearest centroid of every row, by L2 (argmin of the
// clamped expansion |x|^2 + |c|^2 - 2 x.c) or by inner product (argmax of
// x.c); the lower centroid index wins ties, as jnp.argmin / jnp.argmax do.
//
// Replaces lynsedb_tpu/ops/kmeans.py _lloyd_step's assignment (:88-91) and
// assign_clusters (:114), which run their products at Precision.HIGHEST: the
// product stays true f32 (FMA, no TF32, no tensor cores).
//
// Bound: f32 FMA throughput, 2 * N * K * D flops (65.5 GFLOP at N = 256,000,
// K = 1,000, D = 128: about 1 ms at 67 TFLOP/s); the bytes are small (the
// rows are read K / 64 times, mostly from L2, and only (N,) int32 is
// written).
// Design: a block holds 64 rows and walks every 64-centroid tile with the
// shared-memory tile product of common.cuh's scheme (16-deep stages, 4 x 4
// outputs a thread); each thread keeps its rows' best (score, index) in
// registers, and the 16 threads that share a row reduce by shuffles at the
// end. The (N, K) matrix is never written.
#include "common.cuh"

namespace {

constexpr int kRows = 64;     // data rows per block
constexpr int kCents = 64;    // centroids per tile
constexpr int kDepth = 16;    // depth of one shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 rows x 4 centroids each

// a is better than b: smaller distance (L2) or larger product (IP); the
// lower index between equal scores
__device__ __forceinline__ bool closer(bool ip, float va, int ia, float vb, int ib) {
  return (ip ? va > vb : va < vb) || (va == vb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
    kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                         const float* __restrict__ c_sq, int N, int K, int D, bool ip,
                         int* __restrict__ out) {
  __shared__ float xs[kDepth][kRows + 4];
  __shared__ float cs[kDepth][kCents + 4];
  __shared__ float s_xsq[kRows];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  if (!ip) {  // |x|^2 of the block's rows, one warp a row
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float acc = 0.f;
      if (r0 + r < N)
        for (int d = lane; d < D; d += 32) {
          const float v = x[(r0 + r) * D + d];
          acc = fmaf(v, v, acc);
        }
      acc = lt::warp_sum(acc);
      if (lane == 0) s_xsq[r] = acc;
    }
  }
  float best[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = ip ? -INFINITY : INFINITY;
    best_i[i] = INT_MAX;
  }
  for (int c0 = 0; c0 < K; c0 += kCents) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += kDepth) {
      for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, cc = e % kDepth, d = k0 + cc;
        xs[cc][r] = (r0 + r < N && d < D) ? __ldg(x + (r0 + r) * D + d) : 0.f;
        cs[cc][r] = (c0 + r < K && d < D) ? __ldg(c + (int64_t)(c0 + r) * D + d) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = cs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // centroids reach a thread in increasing index order, so a strict
    // comparison keeps the lowest index among its equal scores
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + tx * 4 + j;
      if (ci >= K) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v =
            ip ? acc[i][j] : lt::clamp_nonneg(s_xsq[ty * 4 + i] + c_sq[ci] - 2.f * acc[i][j]);
        if (ip ? v > best[i] : v < best[i]) {
          best[i] = v;
          best_i[i] = ci;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = best[i];
    int id = best_i[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // the 16 lanes of one row
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, id, o);
      if (closer(ip, ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    const int64_t row = r0 + ty * 4 + i;
    if (tx == 0 && row < N) out[row] = id == INT_MAX ? 0 : id;  // no finite score: index 0
  }
}

}  // namespace

// x (N, D) f32, c (K, D) f32, c_sq (K,) f32 squared centroid norms (L2; may
// be null for IP) -> out (N,) int32.
extern "C" int lt_kmeans_assign(const float* x, const float* c, const float* c_sq, int N, int K,
                                int D, int ip, int* out, cudaStream_t stream) {
  if (N < 1 || K < 1 || D < 1 || (!ip && c_sq == nullptr)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kRows - 1) / kRows);
  kmeans_assign_kernel<<<blocks, kThreads, 0, stream>>>(x, c, c_sq, N, K, D, ip != 0, out);
  return (int)cudaGetLastError();
}
