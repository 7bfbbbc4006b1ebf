// kmeans_assign (K15a): the nearest centroid of every row, by L2 (argmin of
// the clamped expansion |x|^2 + |c|^2 - 2 x.c) or by inner product (argmax of
// x.c); the lower centroid index wins ties, as jnp.argmin / jnp.argmax do.
//
// Replaces lynsedb_tpu/ops/kmeans.py _lloyd_step's assignment (:88-91) and
// assign_clusters (:114), which run their products at Precision.HIGHEST: the
// product stays true f32 (FMA, no TF32, no tensor cores).
//
// Bound: f32 throughput, 2 N K D flops plus the epilogue's few operations a
// (row, centroid) pair (tools/roofline.py assign_bound): 65.5 GFLOP at N =
// 256,000, K = 1,000, D = 128, about 1 ms at 67 TFLOP/s; the bytes are small
// (the rows read once, the centroids from L2, (N,) int32 written).
//
// A row's index is a function of its scores alone. Each score is one fmaf
// chain over the dimensions in order from +0; L2's is l2_score(|x|^2, |c|^2,
// dot), |x|^2 the lane-strided fmaf sums of a warp met in lt::warp_sum's
// butterfly. The answer is the smallest L2 (largest IP) score strictly below
// +inf (above -inf), the lowest index among equal ones, a NaN never, index 0
// if none. A thread that folds its centroids in index order with a strict
// comparison, then merges with others by (score, index), gets that answer
// whatever the split, so both routes give the same index as each other (and
// as the 64 x 64 tile they replaced).
//
// Design, two routes by shape:
//   FMA (D >= 16, or a small D whose centroids overflow kSmallSmem):
//     f32_tile.cuh's FMA route with the block's 128 rows as the tile's query
//     side and the centroids streamed through as its rows: 128 centroids a
//     tile, 8-deep k-major stages in two shared buffers, the next stage's
//     16-byte loads in registers while one computes, an 8 x 8 outer product a
//     thread. After each tile's last stage a thread folds its 8 x 8 scores
//     into its 8 rows' running best in registers (tiles in index order); at
//     the end the 16 threads of a row meet by shuffles. No (N, K) matrix is
//     written; the centroids (512 KB at K = 1,000) stay in L2.
//   small D (D < 16: PQ's codebooks, D = 8 and K = 256): a row a thread, two
//     rows a thread, every centroid and |c|^2 in shared memory read by 16-byte
//     broadcasts, the rows in registers with no padded depth (16-byte loads
//     where D is a multiple of 4 and the base aligned); |x|^2 replays
//     lt::warp_sum's tree over the row's squares.
#include "f32_tile.cuh"

namespace {

using AssignTile = lt::FmaTile<128, 8, 8>;  // 128 rows x 128 centroids a tile
// the FMA route's two stages (the tile's shared score tile is not used)
constexpr size_t kFmaSmem = 2 * (size_t)AssignTile::kStageFloats * sizeof(float);
constexpr int kSmallThreads = 256, kSmallRows = 2;  // rows a thread
constexpr int kSmallSmem = 64 * 1024;               // the small route's centroids at most

// The L2 score of a (row, centroid) pair: one expression for both routes, so
// the compiler forms it the same way (2 dot is exact either way).
__device__ __forceinline__ float l2_score(float xsq, float csq, float dot) {
  return lt::clamp_nonneg(xsq + csq - 2.f * dot);
}

// a is better than b: smaller distance (L2) or larger product (IP); the
// lower index between equal scores
__device__ __forceinline__ bool closer(bool ip, float va, int ia, float vb, int ib) {
  return (ip ? va > vb : va < vb) || (va == vb && ia < ib);
}

template <bool IP>
__device__ __forceinline__ void fold(float v, int i, float& best, int& best_i) {
  if (IP ? v > best : v < best) {
    best = v;
    best_i = i;
  }
}

__global__ void __launch_bounds__(AssignTile::kThreads, 2)
    assign_fma_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      const float* __restrict__ c_sq, int N, int K, int D, bool vec, bool ip,
                      int* __restrict__ out) {
  using Tile = AssignTile;
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_xsq[Tile::TN];
  const int q0 = blockIdx.x * Tile::TN, nq = min(Tile::TN, N - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!ip) {  // |x|^2 of the block's rows, a warp a row
    for (int r = warp; r < Tile::TN; r += Tile::kThreads / 32) {
      float acc = 0.f;
      if (r < nq)
        for (int d = lane; d < D; d += 32) {
          const float v = x[(int64_t)(q0 + r) * D + d];
          acc = fmaf(v, v, acc);
        }
      acc = lt::warp_sum(acc);
      if (lane == 0) s_xsq[r] = acc;
    }
  }
  const lt::F32Span sp{x, c, D, vec, q0, nq, 0, K};  // the rows are the queries
  const int kchunks = lt::span_kchunks(D, Tile::KC);
  const int steps = (K + Tile::TM - 1) / Tile::TM * kchunks;
  float4 pf[Tile::kLoads];
  lt::fma_load<Tile>(sp, 0, kchunks, pf);
  lt::fma_store<Tile>(smem, pf);
  __syncthreads();  // the first stage and |x|^2
  const int tr = Tile::tr(), tq = Tile::tq();
  float best[Tile::RN];
  int best_i[Tile::RN];
#pragma unroll
  for (int j = 0; j < Tile::RN; ++j) {
    best[j] = ip ? -INFINITY : INFINITY;
    best_i[j] = INT_MAX;
  }
  float acc[Tile::RM][Tile::RN] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) lt::fma_load<Tile>(sp, s + 1, kchunks, pf);
    lt::fma_stage<Tile>(smem + (s & 1) * Tile::kStageFloats, acc, lt::FmaStep{});
    if (s % kchunks == kchunks - 1) {
      const int c0 = s / kchunks * Tile::TM;
      // a thread's centroids rise with i, and tiles come in index order
#pragma unroll
      for (int i = 0; i < Tile::RM; ++i) {
        const int ci = c0 + Tile::row(tr, i);
        if (ci < K) {
          if (ip) {
#pragma unroll
            for (int j = 0; j < Tile::RN; ++j) fold<true>(acc[i][j], ci, best[j], best_i[j]);
          } else {
            const float cq = __ldg(c_sq + ci);
#pragma unroll
            for (int j = 0; j < Tile::RN; ++j)
              fold<false>(l2_score(s_xsq[Tile::query(tq, j)], cq, acc[i][j]), ci, best[j],
                          best_i[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < Tile::RN; ++j) acc[i][j] = 0.f;
      }
    }
    if (s + 1 < steps) lt::fma_store<Tile>(smem + ((s + 1) & 1) * Tile::kStageFloats, pf);
    __syncthreads();  // the next stage stored; every thread is done with this one
  }
#pragma unroll
  for (int j = 0; j < Tile::RN; ++j) {
    float v = best[j];
    int id = best_i[j];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // the 16 threads of a row (tr)
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, id, o);
      if (closer(ip, ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    const int r = Tile::query(tq, j);
    if (tr == 0 && r < nq) out[q0 + r] = id == INT_MAX ? 0 : id;  // no finite score: index 0
  }
}

// lt::warp_sum of the squares of a D-wide row (D <= 32), as lane 0 of a warp
// forms it: lane l holds fmaf(x_l, x_l, 0) (0 past D), then lane l adds lane l
// ^ o for o = 16, 8, 4, 2, 1.
template <int D>
__device__ __forceinline__ float row_sq_tree(const float (&xr)[D]) {
  float u[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    const int a = l < D ? l : 0, b = l + 16 < D ? l + 16 : 0;  // in bounds
    const float lo = l < D ? fmaf(xr[a], xr[a], 0.f) : 0.f;
    const float hi = l + 16 < D ? fmaf(xr[b], xr[b], 0.f) : 0.f;
    u[l] = lo + hi;
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int l = 0; l < o; ++l) u[l] = u[l] + u[l + o];
  return u[0];
}

template <int D, bool IP>
__global__ void __launch_bounds__(kSmallThreads)
    assign_small_kernel(const float* __restrict__ x, const float* __restrict__ c,
                        const float* __restrict__ c_sq, int N, int K, bool vec,
                        int* __restrict__ out) {
  constexpr int DP = (D + 3) / 4 * 4;  // a staged centroid's floats: 16-byte reads
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;            // (K, DP)
  float* csq = sm + K * DP;  // (K,)
  for (int e = threadIdx.x; e < K * DP; e += kSmallThreads) {
    const int k = e / DP, d = e % DP;
    cs[e] = d < D ? __ldg(c + (int64_t)k * D + d) : 0.f;
  }
  if (!IP)
    for (int k = threadIdx.x; k < K; k += kSmallThreads) csq[k] = __ldg(c_sq + k);
  const int64_t base = (int64_t)blockIdx.x * kSmallThreads * kSmallRows + threadIdx.x;
  float xr[kSmallRows][D], xsq[kSmallRows], best[kSmallRows];
  int best_i[kSmallRows];
#pragma unroll
  for (int i = 0; i < kSmallRows; ++i) {
    const int64_t row = base + (int64_t)i * kSmallThreads;
    const float* src = x + row * D;
    if (row >= N) {
#pragma unroll
      for (int d = 0; d < D; ++d) xr[i][d] = 0.f;
    } else if constexpr (D % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src + d));
          xr[i][d] = v.x;
          xr[i][d + 1] = v.y;
          xr[i][d + 2] = v.z;
          xr[i][d + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) xr[i][d] = __ldg(src + d);
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) xr[i][d] = __ldg(src + d);
    }
    xsq[i] = IP ? 0.f : row_sq_tree<D>(xr[i]);
    best[i] = IP ? -INFINITY : INFINITY;
    best_i[i] = INT_MAX;
  }
  __syncthreads();
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float cv[DP];
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(cs + k * DP + d);
      cv[d] = v.x;
      cv[d + 1] = v.y;
      cv[d + 2] = v.z;
      cv[d + 3] = v.w;
    }
    const float cq = IP ? 0.f : csq[k];
#pragma unroll
    for (int i = 0; i < kSmallRows; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(xr[i][d], cv[d], dot);
      fold<IP>(IP ? dot : l2_score(xsq[i], cq, dot), k, best[i], best_i[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kSmallRows; ++i) {
    const int64_t row = base + (int64_t)i * kSmallThreads;
    if (row < N) out[row] = best_i[i] == INT_MAX ? 0 : best_i[i];  // no finite score: index 0
  }
}

template <int D, bool IP>
int launch_small(const float* x, const float* c, const float* c_sq, int N, int K, bool vec,
                 int* out, cudaStream_t stream) {
  const int smem = K * ((D + 3) / 4 * 4 + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(assign_small_kernel<D, IP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = ((int64_t)N + kSmallThreads * kSmallRows - 1) / (kSmallThreads * kSmallRows);
  assign_small_kernel<D, IP><<<(unsigned)blocks, kSmallThreads, smem, stream>>>(x, c, c_sq, N, K,
                                                                               vec, out);
  return (int)cudaGetLastError();
}

template <int D>
int small_route(const float* x, const float* c, const float* c_sq, int N, int K, bool ip,
                bool vec, int* out, cudaStream_t stream) {
  return ip ? launch_small<D, true>(x, c, c_sq, N, K, vec, out, stream)
            : launch_small<D, false>(x, c, c_sq, N, K, vec, out, stream);
}

}  // namespace

// x (N, D) f32, c (K, D) f32, c_sq (K,) f32 squared centroid norms (L2; may
// be null for IP) -> out (N,) int32. The route by shape: a row a thread for
// D < 16 whose centroids fit kSmallSmem, else the FMA tile.
extern "C" int lt_kmeans_assign(const float* x, const float* c, const float* c_sq, int N, int K,
                                int D, int ip, int* out, cudaStream_t stream) {
  if (N < 1 || K < 1 || D < 1 || (!ip && c_sq == nullptr)) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && lt::aligned16(x) && lt::aligned16(c);
  if (D < 16 && (int64_t)K * ((D + 3) / 4 * 4 + 1) * 4 <= kSmallSmem) {
    switch (D) {
      case 1: return small_route<1>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 2: return small_route<2>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 3: return small_route<3>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 4: return small_route<4>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 5: return small_route<5>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 6: return small_route<6>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 7: return small_route<7>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 8: return small_route<8>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 9: return small_route<9>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 10: return small_route<10>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 11: return small_route<11>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 12: return small_route<12>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 13: return small_route<13>(x, c, c_sq, N, K, ip, vec, out, stream);
      case 14: return small_route<14>(x, c, c_sq, N, K, ip, vec, out, stream);
      default: return small_route<15>(x, c, c_sq, N, K, ip, vec, out, stream);
    }
  }
  const int64_t blocks = ((int64_t)N + AssignTile::TN - 1) / AssignTile::TN;
  assign_fma_kernel<<<(unsigned)blocks, AssignTile::kThreads, kFmaSmem, stream>>>(
      x, c, c_sq, N, K, D, vec, ip != 0, out);
  return (int)cudaGetLastError();
}
