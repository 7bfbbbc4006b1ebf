// K3: the two-pass search's second pass. Gathers each query's C shortlisted
// rows from the resident f32 corpus copy, scores them exactly, and keeps the
// best k on (score desc, id asc), with +/-inf fill and id -1 for empty slots.
//
// Replaces lynsedb_tpu/ops/scan.py _rescore_sort_pack (the device rescore of
// bf16_exact_pass_packed), following the host rescore's rule for non-finite
// scores (scan.py _rescore_topk drops them; the device path kept them).
//
// Bound: the gather of B * C rows of D f32 values (32 MB at B = 256,
// C = 256, D = 128): scattered 512-byte rows, so at small B the latency of
// the random reads, not their bytes.
// Design: one block a query reads its C first-pass keys and row ids once,
// coalesced, and lists the live slots (one shared atomic a warp: a
// same-address atomic a thread serialises the block); each warp scores U of
// them at once
// (every row's loads, 4 a lane of 32 dimensions each, issued before any sum;
// the rows' warp sums interleaved), so a query's rows are all in flight
// together where C <= warps x U. Each row's sum keeps one order: lane l adds
// d = l, l + 32, ... with fmaf, then the warp's butterfly. At small B the
// wide route gives a query 1,024 threads (32 warps of 4 rows), else 256 (8
// warps of 8). Up to kRankMax slots the top k are placed by count, each
// thread ranking its slot's packed (key, id) against the others (no barrier
// a stage, as a bitonic sort needs); a larger shortlist (to 1,024) sorts
// bitonically in shared memory. Past 1,024: lt_rescore_keys writes the
// (B, C) exact keys in the same in-flight scoring, K5 (topk_select.cu)
// selects the top k with the row ids as its tie-break, and the wrapper maps
// the keys back to distances (ops/scan.py rescore_topk).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // the narrow route's block, and the keys kernel's
constexpr int kWideThreads = 1024;
constexpr int kRankMax = 256;      // shortlists up to this are ranked by count
constexpr int kV = 4;              // 32-dimension steps of a row a lane keeps in flight

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

// The exact selection keys of U rows of one query (ids[u] < 0: no row, key
// -inf), scored by the whole warp at once; every lane returns them. Lane l
// sums the row's d = l, l + 32, ... in order with fmaf (kV steps' loads of
// every row issued before their sums), then the warp's butterfly on each
// sum, the rows interleaved. Non-finite scores become -inf (dropped).
template <int U>
__device__ __forceinline__ void row_keys(const float* qb, float q_sq, const float* x32, int D,
                                         const int (&ids)[U], int metric, bool ascending,
                                         float (&key)[U]) {
  const int lane = threadIdx.x & 31;
  float ip[U], rs[U];
#pragma unroll
  for (int u = 0; u < U; ++u) ip[u] = rs[u] = 0.f;
  for (int d0 = lane; d0 < D; d0 += 32 * kV) {
    float xv[U][kV];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int d = d0 + 32 * v;
        xv[u][v] = ids[u] >= 0 && d < D ? __ldg(x32 + (int64_t)ids[u] * D + d) : 0.f;
      }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int d = d0 + 32 * v;
      if (d < D) {
        const float qv = __ldg(qb + d);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          ip[u] = fmaf(qv, xv[u][v], ip[u]);
          rs[u] = fmaf(xv[u][v], xv[u][v], rs[u]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ip[u] += __shfl_xor_sync(0xffffffffu, ip[u], o);
      rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], o);
    }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float s = exact_score(metric, ip[u], q_sq, rs[u]);
    const float kv = ascending ? -s : s;
    key[u] = ids[u] >= 0 && isfinite(kv) ? kv : -INFINITY;
  }
}

// One block a query (kT threads, warps of U rows). Shared memory: the packed
// entries (ranking), the slot keys and ids (cp, the shortlist rounded up to
// a power of two), the live slots' list.
template <int kT, int U>
__global__ void __launch_bounds__(kT)
    rescore_topk_kernel(const float* __restrict__ q, const float* __restrict__ x32,
                        const float* __restrict__ cand_keys, const int* __restrict__ cand_idx,
                        int C, int cp, int D, int k, int metric, bool ascending,
                        float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* pk = reinterpret_cast<uint64_t*>(smem);
  float* sk = reinterpret_cast<float*>(pk + cp);
  int* si = reinterpret_cast<int*>(sk + cp);
  int* order = si + cp;
  __shared__ int s_live;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kT / 32;
  const float* qb = q + (int64_t)b * D;
  if (threadIdx.x == 0) s_live = 0;
  const float q_sq = block_q_sq(qb, D);
  // the slots once, coalesced: a slot is live when the first pass kept it
  // (its key is above -inf); the rest sort last as (-inf, INT_MAX)
  for (int base = 0; base < cp; base += kT) {  // every lane of a warp, each round
    const int c = base + threadIdx.x;
    const int64_t at = (int64_t)b * C + c;
    const bool live = c < C && cand_keys[at] > -INFINITY;
    const int pos = lt::warp_append(&s_live, live);  // one shared atomic a warp
    if (live) order[pos] = c;
    if (c < cp) {
      sk[c] = -INFINITY;
      si[c] = live ? cand_idx[at] : INT_MAX;
    }
  }
  __syncthreads();
  const int nl = s_live;
  for (int base = warp * U; base < nl; base += kWarps * U) {
    int slot[U], ids[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      slot[u] = base + u < nl ? order[base + u] : -1;
      ids[u] = slot[u] >= 0 ? si[slot[u]] : -1;
    }
    float key[U];
    row_keys<U>(qb, q_sq, x32, D, ids, metric, ascending, key);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (slot[u] >= 0) sk[slot[u]] = key[u];
    }
  }
  __syncthreads();
  const float fill = ascending ? INFINITY : -INFINITY;
  if (C <= kRankMax) {
    // thread c's rank: the entries better than slot c's, and the equal ones
    // (a row listed twice) at a lower slot
    const int c = threadIdx.x;
    const float key = c < C ? sk[c] : -INFINITY;
    const uint64_t mine = key > -INFINITY ? lt::pack_entry(key, si[c]) : 0;
    if (c < C) pk[c] = mine;
    const int kept = __syncthreads_count(mine != 0);
    if (mine != 0) {
      // 8 entries a step, loaded together (past C: 0, never better); the
      // step that takes the rank to k is the last
      int rank = 0;
      for (int j0 = 0; j0 < C && rank < k; j0 += 8) {
        uint64_t o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = j0 + e < C ? pk[j0 + e] : 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) rank += o[e] > mine || (o[e] == mine && j0 + e < c);
      }
      if (rank < k) {
        out_d[(int64_t)b * k + rank] = ascending ? -key : key;
        out_i[(int64_t)b * k + rank] = si[c];
      }
    }
    for (int e = kept + threadIdx.x; e < k; e += kT) {
      out_d[(int64_t)b * k + e] = fill;
      out_i[(int64_t)b * k + e] = -1;
    }
    return;
  }
  lt::bitonic_sort(sk, si, cp);
  for (int e = threadIdx.x; e < k; e += kT) {
    const float key = sk[e];
    const bool kept = key > -INFINITY;
    out_d[(int64_t)b * k + e] = kept ? (ascending ? -key : key) : fill;
    out_i[(int64_t)b * k + e] = kept ? (int64_t)si[e] : -1;
  }
}

constexpr int kKeysU = 8;  // rows a warp of the keys kernel scores at once

// keys[b, c]: the exact key of slot c (-inf when empty or non-finite). One
// block per (query, 64 slots): each of its 8 warps scores 8 slots at once.
__global__ void __launch_bounds__(kThreads)
    rescore_keys_kernel(const float* __restrict__ q, const float* __restrict__ x32,
                        const float* __restrict__ cand_keys, const int* __restrict__ cand_idx,
                        int C, int D, int metric, bool ascending, float* __restrict__ keys) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qb = q + (int64_t)b * D;
  const float q_sq = block_q_sq(qb, D);
  const int warps = gridDim.x * (kThreads / 32);
  for (int c0 = (blockIdx.x * (kThreads / 32) + warp) * kKeysU; c0 < C; c0 += warps * kKeysU) {
    const int64_t at = (int64_t)b * C + c0 + lane;
    const bool mine = lane < kKeysU && c0 + lane < C;
    const int id = mine && cand_keys[at] > -INFINITY ? cand_idx[at] : -1;
    int ids[kKeysU];
#pragma unroll
    for (int u = 0; u < kKeysU; ++u) ids[u] = __shfl_sync(0xffffffffu, id, u);
    float key[kKeysU];
    row_keys<kKeysU>(qb, q_sq, x32, D, ids, metric, ascending, key);
    float out = -INFINITY;
#pragma unroll
    for (int u = 0; u < kKeysU; ++u)
      if (lane == u) out = key[u];
    if (mine) keys[at] = out;
  }
}

}  // namespace

extern "C" {

// q (B, D) f32, x32 (N, D) f32, cand_keys (B, C) f32 (first-pass keys, -inf =
// empty slot), cand_idx (B, C) int32 row ids -> out_d (B, k) f32, out_i (B, k)
// int64. C <= 1024. wide: 1,024-thread blocks (the small-B route).
int lt_rescore_topk(const float* q, const float* x32, const float* cand_keys, const int* cand_idx,
                    int B, int C, int D, int k, int metric, int ascending, int wide, float* out_d,
                    int64_t* out_i, cudaStream_t stream) {
  if (B < 1 || C < 1 || C > 1024 || k < 1 || k > C || D < 1) return (int)cudaErrorInvalidValue;
  const int cp = lt::next_pow2(C);
  const size_t smem = (size_t)cp * (sizeof(uint64_t) + sizeof(float) + 2 * sizeof(int));
  if (wide) {
    rescore_topk_kernel<kWideThreads, 4><<<B, kWideThreads, smem, stream>>>(
        q, x32, cand_keys, cand_idx, C, cp, D, k, metric, ascending != 0, out_d, out_i);
  } else {
    rescore_topk_kernel<kThreads, 8><<<B, kThreads, smem, stream>>>(
        q, x32, cand_keys, cand_idx, C, cp, D, k, metric, ascending != 0, out_d, out_i);
  }
  return (int)cudaGetLastError();
}

// The same inputs -> keys (B, C) f32, the exact oriented key of every slot.
int lt_rescore_keys(const float* q, const float* x32, const float* cand_keys, const int* cand_idx,
                    int B, int C, int D, int metric, int ascending, float* keys,
                    cudaStream_t stream) {
  if (B < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int per_block = kKeysU * (kThreads / 32);
  const int blocks = (C + per_block - 1) / per_block;
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
