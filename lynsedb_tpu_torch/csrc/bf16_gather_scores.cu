// K11: bf16 scores of gathered rows. Scores the bf16-rounded centred query
// against rows gathered from the mean-centred bf16 corpus copy, accumulating
// in f32, and restores each metric with K2's per-row rank-1 corrections; K5
// then takes the top C that K3 rescores exactly in f32.
//
// Replaces the gather and rescore of lynsedb_tpu/ops/scan.py
// shortlist_device_rescore_ids (:416; rows = take(x16, cand), the einsum and
// the epilogue at :443-458) and the first pass of the gather route,
// bf16_gather_pass_ids (:385):
//   IP      ip_c + xm
//   L2      max(qc_sq + xc_sq - 2 ip_c, 0), qc_sq from the f32 centred query
//   cosine  1 - (ip_c + xm + q.m) / sqrt(q_sq * xsq_true), 1.0 below 1e-30
// then the orientation; an empty slot (a negative id, or a slot key of -inf)
// and a NaN score give -inf.
//
// The index list has a batch stride, and the route follows it:
//   idx_stride = S  one list a query (a quantized index's shortlist): the
//                   rows differ by query, so nothing is shared. One block per
//                   (query, 64 slots); a warp takes one slot at a time, its
//                   lanes read the row with 16-byte loads (8 bf16) where D is
//                   a multiple of 8, dot them with the query held in f32 in
//                   shared memory, and reduce by shuffles.
//   idx_stride = 0  one list shared by every query (the gather route of a
//                   selective filter, K4): K2's tensor-core tile over
//                   gathered rows. A block takes 128 slots x a group of up
//                   to 32 queries, reads the tile's row ids once into shared
//                   memory, and fills a 3-deep cp.async ring of 64-dimension
//                   stages, each 16-byte copy taking its source row from the
//                   id (an empty slot zero-filled; a D that is not a multiple
//                   of 8, or an unaligned base, takes scalar loads); 8 warps
//                   of 16 rows run mma.sync m16n8k16 (mma_bf16.cuh), rows on
//                   M and queries on N, so B = 1 pads to 8 queries, not 128.
//                   The epilogue writes the keys through a shared score tile
//                   (the ring's memory), so the (B, S) stores coalesce. Query
//                   groups are the fastest grid index, so the groups that
//                   share a row tile re-read it from L2.
//
// Bound: bytes, the gathered rows (2 * D bytes each, 256 B at D = 128) plus
// their aux word, the ids and slot keys read and the (B, S) keys written; the
// 2 * B * S * D flops take the tensor cores a fraction of that in the shared
// mode. The gathers are random 256-byte reads.
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 64;  // shortlist slots a block (per-query mode)
constexpr int kTM = lt::kMmaRows;  // slots a tile (shared mode)
constexpr int kKC = lt::kMmaDims;
constexpr int kStride = lt::kMmaStride;
constexpr int kStages = lt::kMmaStages;
constexpr int kMaxQN = 32;         // queries a block (4 n-tiles of 8)
constexpr int kSRow = kTM + 4;     // floats a query of the score tile

struct GatherEpilogue {
  const float* qc_sq;     // (B,) |q - m|^2 from the f32 centred query
  const float* qm;        // (B,) q . m
  const float* q_sq;      // (B,) |q|^2
  const float* xm;        // (N,) m . (x - m) of the rounded rows
  const float* xc_sq;     // (N,) |x - m|^2 of the rounded rows
  const float* xsq_true;  // (N,) |x|^2 of the f32 rows
  int metric;
  bool ascending;

  __device__ __forceinline__ float operator()(int b, int64_t n, float ip_c) const {
    float s;
    if (metric == lt::kIP) {
      s = ip_c + xm[n];
    } else if (metric == lt::kL2) {
      s = lt::clamp_nonneg(qc_sq[b] + xc_sq[n] - 2.f * ip_c);
    } else {
      s = lt::cosine_distance(ip_c + xm[n] + qm[b], sqrtf(q_sq[b] * xsq_true[n]));
    }
    return lt::to_key(s, ascending, true);
  }
};

__global__ void __launch_bounds__(kThreads)
    bf16_gather_kernel(const __nv_bfloat16* __restrict__ qc16, const __nv_bfloat16* __restrict__ x16,
                       const int* __restrict__ idx, int idx_stride,
                       const float* __restrict__ slot_keys, int S, int D, GatherEpilogue epi,
                       float* __restrict__ keys) {
  extern __shared__ __align__(16) float qs[];  // the query, upcast, D floats
  const int b = blockIdx.y;
  for (int d = threadIdx.x; d < D; d += kThreads) qs[d] = __bfloat162float(qc16[(int64_t)b * D + d]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* ib = idx + (int64_t)b * idx_stride;
  const float* kb = slot_keys ? slot_keys + (int64_t)b * idx_stride : nullptr;
  const int s_end = min(S, ((int)blockIdx.x + 1) * kSlots);
  for (int s = (int)blockIdx.x * kSlots + warp; s < s_end; s += kThreads / 32) {
    const int n = ib[s];
    float key = -INFINITY;
    if (n >= 0 && (kb == nullptr || kb[s] > -INFINITY)) {  // the same for the whole warp
      const __nv_bfloat16* xr = x16 + (int64_t)n * D;
      float acc = 0.f;
      if ((D & 7) == 0) {
        for (int v = lane; v < D / 8; v += 32) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(xr) + v);
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
          const float4 qa = reinterpret_cast<const float4*>(qs)[2 * v];
          const float4 qb = reinterpret_cast<const float4*>(qs)[2 * v + 1];
          const float2 x0 = __bfloat1622float2(p[0]), x1 = __bfloat1622float2(p[1]),
                       x2 = __bfloat1622float2(p[2]), x3 = __bfloat1622float2(p[3]);
          acc = fmaf(x0.x, qa.x, acc);
          acc = fmaf(x0.y, qa.y, acc);
          acc = fmaf(x1.x, qa.z, acc);
          acc = fmaf(x1.y, qa.w, acc);
          acc = fmaf(x2.x, qb.x, acc);
          acc = fmaf(x2.y, qb.y, acc);
          acc = fmaf(x3.x, qb.z, acc);
          acc = fmaf(x3.y, qb.w, acc);
        }
      } else {
        for (int d = lane; d < D; d += 32) acc = fmaf(__bfloat162float(xr[d]), qs[d], acc);
      }
      acc = lt::warp_sum(acc);
      key = epi(b, n, acc);
    }
    if (lane == 0) keys[(int64_t)b * S + s] = key;
  }
}

struct SharedArgs {
  const __nv_bfloat16* q;  // (B, D) bf16(q - m)
  const __nv_bfloat16* x;  // (N, D) centred bf16 corpus
  const int* idx;          // (S,) row ids, negative = empty
  const float* slot_keys;  // (S,) or null, -inf = empty
  int B, S, D;
  bool vec;
  int groups, ql;
  GatherEpilogue epi;
  float* keys;             // (B, S)
};

// Stage `chunk` (dimensions from chunk * kKC) of the tile's gathered rows and
// the group's queries into dst: rows first, then queries, kStride bf16 each;
// zeros for an empty slot, past D and past the group.
template <int QN>
__device__ __forceinline__ void load_gathered(const SharedArgs& a, const int* ids,
                                              __nv_bfloat16* dst, int chunk, int q0, int nq) {
  const int k0 = chunk * kKC;
  if (a.vec) {
    constexpr int kChunks = kKC / 8;  // 16-byte copies a row
    for (int c = threadIdx.x; c < (kTM + QN) * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, d = k0 + col;
      const __nv_bfloat16* src = a.x;
      bool ok;
      if (r < kTM) {
        const int n = ids[r];
        ok = n >= 0 && d < a.D;
        if (ok) src = a.x + (int64_t)n * a.D + d;
      } else {
        ok = r - kTM < nq && d < a.D;
        if (ok) src = a.q + (int64_t)(q0 + r - kTM) * a.D + d;
      }
      lt::cp_async16(dst + r * kStride + col, src, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < (kTM + QN) * kKC; e += kThreads) {
      const int r = e / kKC, col = e % kKC, d = k0 + col;
      __nv_bfloat16 v = zero;
      if (r < kTM) {
        const int n = ids[r];
        if (n >= 0 && d < a.D) v = a.x[(int64_t)n * a.D + d];
      } else if (r - kTM < nq && d < a.D) {
        v = a.q[(int64_t)(q0 + r - kTM) * a.D + d];
      }
      dst[r * kStride + col] = v;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) shared_list_kernel(const SharedArgs a) {
  constexpr int QN = 8 * NT;
  constexpr int kStageElems = (kTM + QN) * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* score = reinterpret_cast<float*>(smem);  // QN x kSRow, after the last stage
  __shared__ int ids[kTM];
  const int group = blockIdx.x % a.groups, tile = blockIdx.x / a.groups;
  const int q0 = group * a.ql, nq = min(a.ql, a.B - q0);
  const int s0 = tile * kTM;
  for (int r = threadIdx.x; r < kTM; r += kThreads) {
    const int s = s0 + r;
    int n = -1;
    if (s < a.S) {
      n = a.idx[s];
      if (a.slot_keys && !(a.slot_keys[s] > -INFINITY)) n = -1;
    }
    ids[r] = n < 0 ? -1 : n;
  }
  __syncthreads();
  const int kchunks = (a.D + kKC - 1) / kKC;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < kchunks) load_gathered<QN>(a, ids, ring + c * kStageElems, c, q0, nq);
    lt::cp_async_commit();
  }
  float acc[NT][4] = {};
  for (int c = 0; c < kchunks; ++c) {
    lt::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage c has landed; every warp is done with stage c - 1
    const int next = c + kStages - 1;
    if (next < kchunks)
      load_gathered<QN>(a, ids, ring + (next % kStages) * kStageElems, next, q0, nq);
    lt::cp_async_commit();
    lt::mma_stage<NT>(ring + (c % kStages) * kStageElems, acc);
  }
  lt::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the score tile now
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    const int n = ids[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * (lane & 3) + e;
        score[j * kSRow + r] =
            n >= 0 && j < nq ? a.epi(q0 + j, n, acc[nt][2 * h + e]) : -INFINITY;
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * kTM; e += kThreads) {
    const int j = e / kTM, r = e % kTM;
    if (s0 + r < a.S) a.keys[(int64_t)(q0 + j) * a.S + s0 + r] = score[j * kSRow + r];
  }
}

template <int NT>
int launch_shared(const SharedArgs& a, int tiles, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * (kTM + 8 * NT) * kStride * sizeof(__nv_bfloat16);
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(shared_list_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    raised = true;
  }
  shared_list_kernel<NT><<<(unsigned)(a.groups * tiles), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// qc16 (B, D) bf16 centred query, x16 (N, D) bf16 centred corpus, idx
// (B, S) or (S,) int32 row ids (idx_stride S or 0; negative = empty slot),
// slot_keys laid out as idx or null (a -inf key = empty slot), per-query and
// per-row terms as GatherEpilogue -> keys (B, S) f32.
extern "C" int lt_bf16_gather_scores(const __nv_bfloat16* qc16, const __nv_bfloat16* x16,
                                     const int* idx, int idx_stride, const float* slot_keys,
                                     const float* qc_sq, const float* qm, const float* q_sq,
                                     const float* xm, const float* xc_sq, const float* xsq_true,
                                     int B, int S, int D, int metric, int ascending, float* keys,
                                     cudaStream_t stream) {
  if (B < 1 || S < 1 || D < 1 || (idx_stride != 0 && idx_stride != S))
    return (int)cudaErrorInvalidValue;
  const GatherEpilogue epi{qc_sq, qm, q_sq, xm, xc_sq, xsq_true, metric, ascending != 0};
  if (idx_stride == 0) {
    // groups of at most 32 queries, as even as B allows
    const int groups = (B + kMaxQN - 1) / kMaxQN, ql = (B + groups - 1) / groups;
    const int tiles = (S + kTM - 1) / kTM;
    if ((int64_t)groups * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool vec = D % 8 == 0 && lt::aligned16(qc16) && lt::aligned16(x16);
    const SharedArgs a{qc16, x16, idx, slot_keys, B, S, D, vec, groups, ql, epi, keys};
    switch ((ql + 7) / 8) {
      case 1: return launch_shared<1>(a, tiles, stream);
      case 2: return launch_shared<2>(a, tiles, stream);
      case 3: return launch_shared<3>(a, tiles, stream);
      default: return launch_shared<4>(a, tiles, stream);
    }
  }
  if (B > 65535 || (size_t)D * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kSlots - 1) / kSlots), (unsigned)B);
  bf16_gather_kernel<<<grid, kThreads, D * sizeof(float), stream>>>(qc16, x16, idx, idx_stride,
                                                                     slot_keys, S, D, epi, keys);
  return (int)cudaGetLastError();
}
