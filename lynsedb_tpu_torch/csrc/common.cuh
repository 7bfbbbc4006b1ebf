// Shared pieces of the kernels: the metric codes and keys, the binary
// distances, the selection order, a bitonic sort, the span threshold select
// (WarpTopk), the cp.async copies and the f32 tile product of K19. The other
// metrics' formulas are in metrics.cuh; the pipelined f32 tile of K1 / K6a
// is in f32_tile.cuh, the bf16 tensor-core stage of K2 / K11 in mma_bf16.cuh,
// the integer tensor-core tile of K6b / K12 in mma_int.cuh.
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

// The metric codes of the kernels that take a metric (ops/scan.py _GEMM_CODE
// and _ELEM_CODE): the GEMM family, then the elementwise family.
enum Metric : int {
  kIP = 0, kL2 = 1, kCosine = 2, kCorrelation = 3, kHellinger = 4, kL1 = 5, kChebyshev = 6,
  kCanberra = 7, kBrayCurtis = 8, kWasserstein = 9, kJensenShannon = 10, kHaversine = 11
};

// The binary family's codes (ops/scan.py _BINARY_CODE; Tanimoto is Jaccard).
enum BinaryMetric : int { kHamming = 0, kJaccard = 1, kDice = 2 };

// A binary distance from the popcount of the two rows' AND and their bit
// counts, with the JAX package's f32 operations in its order:
//   Hamming         cq + cx - 2 inter
//   Jaccard         union = cq + cx - inter; 0 if union == 0,
//   (and Tanimoto)  else 1 - inter / max(union, 1)
//   Dice            total = cq + cx; 0 if total == 0,
//                   else 1 - 2 inter / max(total, 1)
// Every count is an integer below 2^24, so each operation is exact but the one
// division, which rounds the same on both sides: the distances equal JAX's and
// the plain version's to the bit (K6b, K16b).
__device__ __forceinline__ float binary_distance(int metric, float inter, float cq, float cx) {
  if (metric == kHamming) return __fsub_rn(__fadd_rn(cq, cx), __fmul_rn(2.f, inter));
  if (metric == kJaccard) {
    const float uni = __fsub_rn(__fadd_rn(cq, cx), inter);
    return uni == 0.f ? 0.f : __fsub_rn(1.f, __fdiv_rn(inter, fmaxf(uni, 1.f)));
  }
  const float total = __fadd_rn(cq, cx);
  return total == 0.f ? 0.f : __fsub_rn(1.f, __fdiv_rn(__fmul_rn(2.f, inter), fmaxf(total, 1.f)));
}

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

// A (key, id) entry as one 64-bit value that orders as better() does: the
// key's bits made order-preserving (-0 folded into +0, which compares equal
// to it), then the id inverted, so a larger value is a bigger key or, at an
// equal key, a lower id. Keys are never NaN here (callers map NaN to -inf).
__device__ __forceinline__ uint64_t pack_entry(float key, int id) {
  uint32_t u = __float_as_uint(key + 0.f);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;
  return ((uint64_t)u << 32) | (uint32_t)((int64_t)INT_MAX - id);
}

__device__ __forceinline__ float entry_key(uint64_t v) {
  const uint32_t u = (uint32_t)(v >> 32);
  return __uint_as_float((u >> 31) ? u ^ 0x80000000u : ~u);
}

__device__ __forceinline__ int entry_id(uint64_t v) {
  return (int)((int64_t)INT_MAX - (int64_t)(uint32_t)v);
}

constexpr uint64_t kPadEntry = 0x007fffff00000000ull;  // pack_entry(-inf, INT_MAX)
constexpr uint64_t kNoRowEntry = 0x007fffff80000000ull;  // pack_entry(-inf, -1)

// Sorts 256 packed entries, larger first, held 8 a lane (entry 8 * lane + e
// in register e): a bitonic network, in-lane compare-exchanges for strides
// below 8 and shuffles for the others.
__device__ __forceinline__ void warp_sort256(uint64_t (&v)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 256; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e & stride) continue;
          const int f = e + stride;
          const bool larger_first = ((lane * 8 + e) & size) == 0;
          if (larger_first ? v[f] > v[e] : v[e] > v[f]) {
            const uint64_t t = v[e];
            v[e] = v[f];
            v[f] = t;
          }
        }
      } else {
        const int m = stride >> 3;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool larger_first = ((lane * 8 + e) & size) == 0;
          const uint64_t o = __shfl_xor_sync(0xffffffffu, v[e], m);
          // the pair's lower position keeps the larger one when larger_first
          if ((lower == larger_first) == (o > v[e])) v[e] = o;
        }
      }
    }
  }
}

// The span threshold select shared by K2's fused first pass
// (bf16_centered_topc.cu) and K5 (topk_select.cu): the running exact top k
// of the entries one warp offers, for one list (a query's, or a span of a
// key row's). The list's memory, shared or device, holds kp packed entries
// kept (kp = k rounded up to a power of two, at least 8), largest first,
// padded with kPadEntry past `kept`, then kPend pending entries.
//
// An entry joins the pending ones only if it is larger than the k-th kept
// so far (or than the caller's start value while fewer than k are kept), so
// after the first few rounds almost every offer costs one compare. flush()
// sorts the pending entries in registers (warp_sort256) and keeps the best
// kp of them and the kept ones: in registers up to kp = 256
// (merge_registers), else along the merge path, in place (merge_path: each
// lane finds where its 8 outputs start by a binary search on its diagonal
// and merges them into registers before any lane writes, 256 outputs at a
// time from the back, so a chunk reads no kept position below the one
// before it wrote); then it raises the threshold. The caller flushes
// before a round could overflow the pending entries. Packed entries order
// as better() does, so the result is exactly the best k in any order of
// offers: where ids arrive in ascending order (K2's rows, K5's first level)
// the test is a strict `key > threshold`, since a later equal key loses the
// tie to the kept one. Every lane holds the same counts and threshold; no
// block barrier is used.
struct WarpTopk {
  static constexpr int kPend = 256;

  uint64_t* list;
  int kept, pend;
  uint64_t thr;

  // start: the threshold while fewer than k are kept. kPadEntry (-inf,
  // INT_MAX) keeps -inf entries (K5 returns them); kNoRowEntry (-inf, -1)
  // drops them (K2).
  __device__ __forceinline__ void init(uint64_t* entries, int kp, uint64_t start) {
    list = entries;
    kept = pend = 0;
    thr = start;
    for (int e = threadIdx.x & 31; e < kp; e += 32) list[e] = kPadEntry;
    __syncwarp();
  }

  // One entry a lane (`live`: the lane has one); every lane calls it. The
  // caller leaves room for 32 pending entries.
  __device__ __forceinline__ void offer(int kp, uint64_t v, bool live) {
    const bool pass = live && v > thr;
    const unsigned mask = __ballot_sync(0xffffffffu, pass);
    if (pass) list[kp + pend + __popc(mask & ((1u << (threadIdx.x & 31)) - 1))] = v;
    pend += __popc(mask);
  }

  // kp <= 256: the kept entries, 8 a lane on the first kp / 8 lanes, each
  // against the sorted pending entry kp - 1 - its position (one shuffle),
  // keep the larger: the best kp as a bitonic sequence, which log2(kp)
  // compare-exchange steps sort, in registers.
  __device__ __forceinline__ void merge_registers(int kp, const uint64_t (&v)[8]) {
    const int lane = threadIdx.x & 31, lanes = kp >> 3;
    const bool mine = lane < lanes;
    uint64_t x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, v[7 - e], lanes - 1);
      const uint64_t kv = mine ? list[lane * 8 + e] : 0;
      x[e] = kv > o ? kv : o;
    }
    for (int m = lanes >> 1; m > 0; m >>= 1) {
      const bool lower = (lane & m) == 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint64_t o = __shfl_xor_sync(0xffffffffu, x[e], m);
        x[e] = lower == (o > x[e]) ? o : x[e];
      }
    }
#pragma unroll
    for (int stride = 4; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e & stride) continue;
        if (x[e + stride] > x[e]) {
          const uint64_t t = x[e];
          x[e] = x[e + stride];
          x[e + stride] = t;
        }
      }
    }
    __syncwarp();
    if (mine) {
#pragma unroll
      for (int e = 0; e < 8; ++e) list[lane * 8 + e] = x[e];
    }
    __syncwarp();
  }

  // kp > 256: the sorted pending entries (at list + kp) merged into the kept
  // ones along the merge path, in place, 256 outputs at a time from the back.
  __device__ __forceinline__ void merge_path(int kp) {
    const int lane = threadIdx.x & 31;
    const uint64_t* pending = list + kp;
    for (int c = (kp - 1) >> 8; c >= 0; --c) {
      const int d0 = c * 256 + lane * 8;
      uint64_t out[8];
      // i = how many of the first d0 merged entries are kept ones
      int lo = max(0, d0 - kPend), hi = d0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pending[d0 - 1 - mid] > list[mid]) hi = mid;
        else lo = mid + 1;
      }
      int i = lo, j = d0 - lo;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool take_b = j < kPend && (i >= kp || pending[j] > list[i]);
        out[e] = take_b ? pending[j] : list[i];
        i += !take_b;
        j += take_b;
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) list[d0 + e] = out[e];
      __syncwarp();
    }
  }

  __device__ __forceinline__ void flush(int kp, int k) {
    if (pend == 0) return;
    const int lane = threadIdx.x & 31;
    uint64_t* pending = list + kp;
    uint64_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = lane * 8 + e < pend ? pending[lane * 8 + e] : kPadEntry;
    warp_sort256(v);
    if (kp <= 256) {
      merge_registers(kp, v);
    } else {
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) pending[lane * 8 + e] = v[e];
      __syncwarp();
      merge_path(kp);
    }
    kept = min(kept + pend, k);
    pend = 0;
    if (kept == k) thr = list[k - 1];
  }
};

// kp of a list of k: k rounded up to a power of two, at least 8.
__host__ __device__ inline int list_kp(int k) {
  int p = 8;
  while (p < k) p <<= 1;
  return p;
}

inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The card's SM count (the grids of the select kernels are sized from it).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// cp.async: 16-byte copies from device to shared memory that run while the
// threads compute. A copy of `bytes` < 16 copies that many and zero-fills
// the rest (0: all zeros, for padding). Commit closes a group; wait<N>
// returns once at most N of the thread's groups are still in flight.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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

}  // namespace lt
