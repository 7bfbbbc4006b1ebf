// K3: the two-pass search's second pass. Gathers each query's C shortlisted
// rows from the resident f32 corpus copy, scores them exactly, sorts on
// (score desc, id asc) and writes the top k, with +/-inf fill and id -1 for
// empty slots.
//
// Replaces lynsedb_tpu/ops/scan.py _rescore_sort_pack (the device rescore of
// bf16_exact_pass_packed), following the host rescore's rule for non-finite
// scores (scan.py _rescore_topk drops them; the device path kept them).
//
// Bound: the gather of B * C rows of D f32 values (32 MB at B = 256,
// C = 256, D = 128), scattered rows, so latency of random 512-byte reads.
// Design: one block per query; each warp scores one candidate row at a time
// (lanes stride over D, a shuffle reduction sums), so a row is read as whole
// 128-byte lines; for C <= 1024 the (key, id) pairs are then sorted
// bitonically in shared memory. A larger shortlist does not fit that sort:
// lt_rescore_keys writes the (B, C) exact keys, K5 (topk_select.cu) selects
// the top k with the row ids as its tie-break, and the wrapper maps the keys
// back to distances (ops/scan.py rescore_topk).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float exact_score(int metric, float ip, float q_sq, float r_sq) {
  if (metric == lt::kIP) return ip;
  if (metric == lt::kL2) return lt::clamp_nonneg(q_sq + r_sq - 2.f * ip);
  return lt::cosine_distance(ip, sqrtf(q_sq * r_sq));
}

// |q|^2 of one query, computed by warp 0 and shared with the block.
__device__ __forceinline__ float block_q_sq(const float* qb, int D) {
  __shared__ float s_qsq;
  if (threadIdx.x < 32) {
    float acc = 0.f;
    for (int d = threadIdx.x; d < D; d += 32) acc = fmaf(qb[d], qb[d], acc);
    acc = lt::warp_sum(acc);
    if (threadIdx.x == 0) s_qsq = acc;
  }
  __syncthreads();
  return s_qsq;
}

// The exact selection key of one live shortlist row, computed by a whole
// warp (every lane returns it); non-finite scores become -inf (dropped).
__device__ __forceinline__ float row_key(const float* qb, float q_sq, const float* xr, int D,
                                         int metric, bool ascending) {
  const int lane = threadIdx.x & 31;
  float ip = 0.f, r_sq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float xv = xr[d];
    ip = fmaf(qb[d], xv, ip);
    r_sq = fmaf(xv, xv, r_sq);
  }
  ip = lt::warp_sum(ip);
  r_sq = lt::warp_sum(r_sq);
  const float s = exact_score(metric, ip, q_sq, r_sq);
  const float kv = ascending ? -s : s;
  return isfinite(kv) ? kv : -INFINITY;
}

__global__ void __launch_bounds__(kThreads)
    rescore_topk_kernel(const float* __restrict__ q, const float* __restrict__ x32,
                        const float* __restrict__ cand_keys, const int* __restrict__ cand_idx,
                        int C, int cp, int D, int k, int metric, bool ascending,
                        float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sk + cp);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float* qb = q + (int64_t)b * D;
  const float q_sq = block_q_sq(qb, D);
  for (int c = warp; c < cp; c += warps) {
    float key = -INFINITY;
    int id = INT_MAX;
    // a slot is live when the first pass kept it (its key is above -inf);
    // the test is uniform across the warp, so the shuffles stay converged
    if (c < C && cand_keys[(int64_t)b * C + c] > -INFINITY) {
      id = cand_idx[(int64_t)b * C + c];
      key = row_key(qb, q_sq, x32 + (int64_t)id * D, D, metric, ascending);
    }
    if (lane == 0) {
      sk[c] = key;
      si[c] = id;
    }
  }
  __syncthreads();
  lt::bitonic_sort(sk, si, cp);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const float key = sk[e];
    const bool kept = key > -INFINITY;
    out_d[(int64_t)b * k + e] = kept ? (ascending ? -key : key) : (ascending ? INFINITY : -INFINITY);
    out_i[(int64_t)b * k + e] = kept ? (int64_t)si[e] : -1;
  }
}

// keys[b, c]: the exact key of slot c (-inf when empty or non-finite). One
// block per (query, 64 slots): each of its 8 warps scores 8 slots.
__global__ void __launch_bounds__(kThreads)
    rescore_keys_kernel(const float* __restrict__ q, const float* __restrict__ x32,
                        const float* __restrict__ cand_keys, const int* __restrict__ cand_idx,
                        int C, int D, int metric, bool ascending, float* __restrict__ keys) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qb = q + (int64_t)b * D;
  const float q_sq = block_q_sq(qb, D);
  const int warps = gridDim.x * (kThreads / 32);
  for (int c = blockIdx.x * (kThreads / 32) + warp; c < C; c += warps) {
    const int64_t at = (int64_t)b * C + c;
    float key = -INFINITY;
    if (cand_keys[at] > -INFINITY)
      key = row_key(qb, q_sq, x32 + (int64_t)cand_idx[at] * D, D, metric, ascending);
    if (lane == 0) keys[at] = key;
  }
}

}  // namespace

extern "C" {

// q (B, D) f32, x32 (N, D) f32, cand_keys (B, C) f32 (first-pass keys, -inf =
// empty slot), cand_idx (B, C) int32 row ids -> out_d (B, k) f32, out_i (B, k)
// int64. C <= 1024.
int lt_rescore_topk(const float* q, const float* x32, const float* cand_keys, const int* cand_idx,
                    int B, int C, int D, int k, int metric, int ascending, float* out_d,
                    int64_t* out_i, cudaStream_t stream) {
  if (B < 1 || C < 1 || C > 1024 || k < 1 || k > C || D < 1) return (int)cudaErrorInvalidValue;
  int cp = 1;
  while (cp < C) cp <<= 1;
  const size_t smem = (size_t)cp * (sizeof(float) + sizeof(int));
  rescore_topk_kernel<<<B, kThreads, smem, stream>>>(q, x32, cand_keys, cand_idx, C, cp, D, k,
                                                     metric, ascending != 0, out_d, out_i);
  return (int)cudaGetLastError();
}

// The same inputs -> keys (B, C) f32, the exact oriented key of every slot.
int lt_rescore_keys(const float* q, const float* x32, const float* cand_keys, const int* cand_idx,
                    int B, int C, int D, int metric, int ascending, float* keys,
                    cudaStream_t stream) {
  if (B < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (C + 8 * (kThreads / 32) - 1) / (8 * (kThreads / 32));
  for (int g = 0; g < B; g += 65535) {  // gridDim.y holds at most 65,535 queries
    const int rows = B - g < 65535 ? B - g : 65535;
    const int64_t off = (int64_t)g * C;
    rescore_keys_kernel<<<dim3(blocks, rows), kThreads, 0, stream>>>(
        q + (int64_t)g * D, x32, cand_keys + off, cand_idx + off, C, D, metric, ascending != 0,
        keys + off);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
