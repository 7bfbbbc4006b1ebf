// K2: the two-pass search's first pass. Scores a bf16-rounded centred query
// block against the mean-centred bf16 corpus copy, accumulating in f32, and
// restores each metric with the per-row rank-1 corrections; K5 then takes the
// top-C shortlist that K3 rescores exactly.
//
// Replaces lynsedb_tpu/ops/scan.py _bf16_scores (inside bf16_exact_pass_packed
// and _exact_rescore_packed_body): ip_c = bf16(q - m) . (x - m) with
// preferred_element_type=f32, then
//   IP      ip_c + xm
//   L2      max(qc_sq + xc_sq - 2 ip_c, 0)
//   cosine  1 - (ip_c + xm + q.m) / sqrt(q_sq * xsq_true), 1.0 below 1e-30
// term for term, then orientation and the mask.
//
// Bound: the corpus read is 2 * N * D bytes (256 MB at 1M x 128), the key
// write 4 * B * N bytes (1 GB at B = 256), and 2 * B * N * D flops; as a
// plain FMA product it is bound by f32 FMA throughput from B of a few dozen.
// Design: the shared tile product of common.cuh reading bf16 and upcasting on
// the way to shared memory (a bf16 x bf16 product is exact in f32, so only
// the summation order differs from the tensor-core result), with the
// correction, orientation and mask fused into the epilogue.
#include "common.cuh"

namespace {

struct CenteredEpilogue {
  const float* qc_sq;     // (B,) |q - m|^2 from the f32 centred query
  const float* qm;        // (B,) q . m
  const float* q_sq;      // (B,) |q|^2
  const float* xm;        // (N,) m . (x - m) of the rounded rows
  const float* xc_sq;     // (N,) |x - m|^2 of the rounded rows
  const float* xsq_true;  // (N,) |x|^2 of the f32 rows
  const uint8_t* valid;   // (N,) 1 = live row
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
    return lt::to_key(s, ascending, valid[n] != 0);
  }
};

}  // namespace

extern "C" int lt_bf16_centered_scores(const __nv_bfloat16* qc16, const __nv_bfloat16* x16,
                                       const float* qc_sq, const float* qm, const float* q_sq,
                                       const float* xm, const float* xc_sq, const float* xsq_true,
                                       const uint8_t* valid, int B, int N, int D, int metric,
                                       int ascending, float* keys, cudaStream_t stream) {
  if (B < 1 || B > 65535 * lt::kTile || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const CenteredEpilogue epi{qc_sq, qm, q_sq, xm, xc_sq, xsq_true, valid, metric, ascending != 0};
  return lt::launch_tile_scores(qc16, x16, B, N, D, epi, keys, stream);
}
