// Shared pieces of the kernels: the metric codes and keys, the selection
// order, an in-shared-memory bitonic sort and a tiled f32 score product.
//
// Every entry point of the library is a plain C function that launches on the
// caller's stream, allocates nothing and returns the cudaError_t of its launch
// (0 on success). The Python wrappers in lynsedb_tpu_torch/ops allocate the
// outputs with torch.empty and raise on a non-zero return.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace lt {

enum Metric : int { kIP = 0, kL2 = 1, kCosine = 2, kCorrelation = 3, kHellinger = 4 };

// The selection order of the whole port: the bigger key first, and between
// equal keys the lower index first (lax.top_k's order in the JAX package).
__device__ __forceinline__ bool better(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// One step of a bitonic network over n (key, index) pairs in shared memory:
// compare-exchange i and i + stride, the block of `size` holding i ordering
// best first when (i & size) == 0 and worst first otherwise.
__device__ __forceinline__ void bitonic_step(float* keys, int* idx, int n, int size, int stride) {
  for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
    const int i = 2 * t - (t & (stride - 1));
    const int j = i + stride;
    const float ki = keys[i], kj = keys[j];
    const int ii = idx[i], ij = idx[j];
    const bool best_first = (i & size) == 0;
    if (best_first ? better(kj, ij, ki, ii) : better(ki, ii, kj, ij)) {
      keys[i] = kj;
      keys[j] = ki;
      idx[i] = ij;
      idx[j] = ii;
    }
  }
  __syncthreads();
}

// Sorts n (a power of two) pairs held in shared memory into the order of
// better(). All threads of the block call it; the caller has already
// synchronised after filling the arrays.
__device__ __forceinline__ void bitonic_sort(float* keys, int* idx, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_step(keys, idx, n, size, stride);
}

// Leaves the best kp of n pairs (both powers of two, kp <= n, and
// n <= 4 * blockDim.x: a thread holds at most two entries while halving)
// sorted best first in positions [0, kp). Runs of kp are sorted in
// alternating directions; then, while more than one run is left, position p
// of each pair of runs keeps the better of its two entries (the best kp of
// the pair, as a bitonic sequence) and one bitonic merge sorts each new run.
// That is a sort of kp-runs plus log2(n / kp) merges instead of a full sort.
__device__ __forceinline__ void bitonic_topk(float* keys, int* idx, int n, int kp) {
  for (int size = 2; size <= kp; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_step(keys, idx, n, size, stride);
  for (int m = n; m > kp; m >>= 1) {
    float nk[2];
    int ni[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = threadIdx.x + c * blockDim.x;
      if (t < (m >> 1)) {
        const int a = 2 * (t / kp) * kp + t % kp, b = a + kp;
        const bool take_b = better(keys[b], idx[b], keys[a], idx[a]);
        nk[c] = take_b ? keys[b] : keys[a];
        ni[c] = take_b ? idx[b] : idx[a];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = threadIdx.x + c * blockDim.x;
      if (t < (m >> 1)) {
        keys[t] = nk[c];
        idx[t] = ni[c];
      }
    }
    __syncthreads();
    for (int stride = kp >> 1; stride > 0; stride >>= 1) bitonic_step(keys, idx, m >> 1, kp, stride);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max(d, 0) that keeps a NaN, as jnp.maximum does (fmaxf would drop it).
__device__ __forceinline__ float clamp_nonneg(float d) { return d < 0.f ? 0.f : d; }

// jnp.maximum / jnp.minimum / jnp.clip, which keep a NaN in the first operand.
__device__ __forceinline__ float max_keep_nan(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float min_keep_nan(float a, float b) { return a > b ? b : a; }
__device__ __forceinline__ float clip_keep_nan(float a, float lo, float hi) {
  return min_keep_nan(max_keep_nan(a, lo), hi);
}

// The reference's zero-mass policy of two rows' masses: both zero -> 0, one
// zero -> `one_zero`, neither -> `d`.
__device__ __forceinline__ float mass_policy(float mass_q, float mass_x, float one_zero, float d) {
  const bool zq = mass_q == 0.f, zx = mass_x == 0.f;
  return (zq || zx) ? ((zq && zx) ? 0.f : one_zero) : d;
}

// 1 - num / denom with the reference's zero-norm policy (denominator below
// 1e-30 gives distance 1.0).
__device__ __forceinline__ float cosine_distance(float num, float denom) {
  return denom < 1e-30f ? 1.f : 1.f - num / fmaxf(denom, 1e-30f);
}

// D.pairwise's oriented IP / L2 / cosine key from a dot product and the two
// squared norms, every operation separately rounded, so the plain versions in
// ops/graph.py form the same bits (K17's f32 tier and K20).
__device__ __forceinline__ float pairwise_key(float ip, float sa, float sb, int metric) {
  if (metric == kIP) return ip;
  if (metric == kL2) return -clamp_nonneg(__fsub_rn(__fadd_rn(sa, sb), __fmul_rn(2.f, ip)));
  const float denom = __fsqrt_rn(__fmul_rn(sa, sb));
  return -(denom < 1e-30f ? 1.f : __fsub_rn(1.f, __fdiv_rn(ip, fmaxf(denom, 1e-30f))));
}

// The oriented, masked selection key of a score: NaN and masked rows -> -inf.
__device__ __forceinline__ float to_key(float score, bool ascending, bool valid) {
  const float key = ascending ? -score : score;
  return (valid && !isnan(key)) ? key : -INFINITY;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

constexpr int kTile = 64;          // corpus rows per block (and queries, for B > 16)
constexpr int kTileK = 16;         // depth of one shared-memory stage
constexpr int kTileThreads = 256;  // 16 x 16 threads, (TQ / 16) x 4 outputs each

// acc[i][j] += q[q0 + ty * RQ + i] . x[n0 + tx * 4 + j] over all D dimensions
// (tx = thread % 16, ty = thread / 16, RQ = TQ / 16), staged kTileK dimensions
// at a time through qs and xs; queries >= B and rows >= n_end read as 0. The
// products and sums are f32 FMA in dimension order. All kTileThreads threads
// of the block call it.
template <int TQ, typename T>
__device__ __forceinline__ void tile_accumulate(const T* __restrict__ q, const T* __restrict__ x,
                                                int B, int64_t n_end, int D, int q0, int64_t n0,
                                                float (&qs)[kTileK][TQ + 4],
                                                float (&xs)[kTileK][kTile + 4],
                                                float (&acc)[TQ / 16][4]) {
  constexpr int RQ = TQ / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < D; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kTileThreads) {
      const int r = e / kTileK, c = e % kTileK, d = k0 + c;
      if (r < TQ) {
        const int qi = q0 + r;
        qs[c][r] = (qi < B && d < D) ? load_f32(q + (int64_t)qi * D + d) : 0.f;
      }
      const int64_t ni = n0 + r;
      xs[c][r] = (ni < n_end && d < D) ? load_f32(x + ni * D + d) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[RQ], b[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[kk][ty * RQ + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// keys[b, n] = epi(b, n, q[b] . x[n]) for a (B, D) query block against an
// (N, D) corpus, both row-major. Products and sums are f32 FMA (no TF32, no
// tensor cores); T is float or __nv_bfloat16, upcast on the way to shared
// memory, so a bf16 x bf16 product is exact and only the sum rounds. A block
// covers TQ queries x 64 rows: TQ = 64 for large batches, 16 for B <= 16 so
// a single query does not pay for 63 empty ones.
template <int TQ, typename T, typename Epi>
__global__ void __launch_bounds__(kTileThreads)
    tile_scores_kernel(const T* __restrict__ q, const T* __restrict__ x, int B, int N, int D,
                       Epi epi, float* __restrict__ keys) {
  constexpr int RQ = TQ / 16;  // query rows per thread
  __shared__ float qs[kTileK][TQ + 4];
  __shared__ float xs[kTileK][kTile + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * TQ;
  const int64_t n0 = (int64_t)blockIdx.x * kTile;
  float acc[RQ][4] = {};
  tile_accumulate<TQ>(q, x, B, N, D, q0, n0, qs, xs, acc);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int b = q0 + ty * RQ + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx * 4 + j;
      if (n < N) keys[(int64_t)b * N + n] = epi(b, n, acc[i][j]);
    }
  }
}

template <typename T, typename Epi>
inline int launch_tile_scores(const T* q, const T* x, int B, int N, int D, Epi epi, float* keys,
                              cudaStream_t stream) {
  const unsigned row_blocks = (unsigned)((N + kTile - 1) / kTile);
  if (B <= 16) {
    tile_scores_kernel<16, T, Epi><<<dim3(row_blocks, 1), kTileThreads, 0, stream>>>(
        q, x, B, N, D, epi, keys);
  } else {
    const unsigned query_blocks = (unsigned)((B + kTile - 1) / kTile);
    tile_scores_kernel<64, T, Epi><<<dim3(row_blocks, query_blocks), kTileThreads, 0, stream>>>(
        q, x, B, N, D, epi, keys);
  }
  return (int)cudaGetLastError();
}

}  // namespace lt
