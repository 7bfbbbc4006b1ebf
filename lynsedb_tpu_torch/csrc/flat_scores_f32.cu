// K1: exact f32 scores of a query block against the f32 corpus copy, with the
// IP / L2 / cosine epilogue, orientation and masking fused; K5 then selects.
//
// Replaces lynsedb_tpu/ops/scan.py flat_topk / flat_search_step through
// ops/distance.py pairwise (_pw_ip, _pw_l2, _pw_cosine), which run at
// Precision.HIGHEST: the path must stay true f32, so no TF32 and no tensor
// cores.
//
// Bound: f32 FMA throughput outside the tensor cores (2 * B * N * D flops;
// about 67 TFLOP/s on an H100 SXM at 700 W) once B reaches a few dozen; below
// that, the read of the (N, D) corpus and the (B, N) key write.
// Design: the shared tile product of common.cuh (64 x 64 outputs a block,
// 4 x 4 a thread, 16-deep shared-memory stages) with an epilogue that forms
// the metric from the dot product and the row norms and writes the oriented
// key, -inf for masked rows and NaN, so K5 can select without another pass.
#include "common.cuh"

namespace {

struct F32Epilogue {
  const float* qsq;      // (B,) squared query norms (L2 / cosine)
  const float* xsq;      // (N,) squared row norms (L2 / cosine)
  const uint8_t* valid;  // (N,) 1 = live row
  int metric;
  bool ascending;

  __device__ __forceinline__ float operator()(int b, int64_t n, float ip) const {
    float s;
    if (metric == lt::kIP) {
      s = ip;
    } else if (metric == lt::kL2) {
      s = lt::clamp_nonneg(qsq[b] + xsq[n] - 2.f * ip);
    } else {
      s = lt::cosine_distance(ip, sqrtf(qsq[b] * xsq[n]));
    }
    return lt::to_key(s, ascending, valid[n] != 0);
  }
};

}  // namespace

extern "C" int lt_flat_scores_f32(const float* q, const float* x, const float* qsq,
                                  const float* xsq, const uint8_t* valid, int B, int N, int D,
                                  int metric, int ascending, float* keys, cudaStream_t stream) {
  if (B < 1 || B > 65535 * lt::kTile || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const F32Epilogue epi{qsq, xsq, valid, metric, ascending != 0};
  return lt::launch_tile_scores(q, x, B, N, D, epi, keys, stream);
}
