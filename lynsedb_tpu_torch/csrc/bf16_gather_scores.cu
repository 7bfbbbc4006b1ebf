// K11: the near-exact rescore of a quantized index's shortlist. Scores the
// bf16-rounded centred query against shortlisted rows gathered from the
// mean-centred bf16 corpus copy, accumulating in f32, and restores each metric
// with K2's per-row rank-1 corrections; K5 then takes the top C that K3
// rescores exactly in f32.
//
// Replaces the gather and rescore of lynsedb_tpu/ops/scan.py
// shortlist_device_rescore_ids (:416; rows = take(x16, cand), the einsum and
// the epilogue at :443-458):
//   IP      ip_c + xm
//   L2      max(qc_sq + xc_sq - 2 ip_c, 0), qc_sq from the f32 centred query
//   cosine  1 - (ip_c + xm + q.m) / sqrt(q_sq * xsq_true), 1.0 below 1e-30
// then the orientation; an empty shortlist slot (a negative id, or a slot key
// of -inf) and a NaN score give -inf.
//
// The index list has a batch stride: idx_stride = S reads one list a query
// (the shortlist), 0 one list shared by every query (the gather route of
// selective filters, K4, which can reuse this kernel).
//
// Bound: bytes, the gathered rows (2 * D bytes each, 256 B at D = 128) plus
// their aux word, the ids and slot keys read and the keys written; the
// 2 * B * S * D flops are small. The gathers are random 256-byte reads.
// Design: one block per (query, 64 slots); a warp takes one slot at a time,
// its lanes read the row with 16-byte loads (8 bf16) where D is a multiple
// of 8, dot them with the query held in f32 in shared memory, and reduce by
// shuffles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 64;  // shortlist slots a block

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
  if (B < 1 || B > 65535 || S < 1 || D < 1 || (idx_stride != 0 && idx_stride != S) ||
      (size_t)D * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const GatherEpilogue epi{qc_sq, qm, q_sq, xm, xc_sq, xsq_true, metric, ascending != 0};
  const dim3 grid((unsigned)((S + kSlots - 1) / kSlots), (unsigned)B);
  bf16_gather_kernel<<<grid, kThreads, D * sizeof(float), stream>>>(qc16, x16, idx, idx_stride,
                                                                     slot_keys, S, D, epi, keys);
  return (int)cudaGetLastError();
}
