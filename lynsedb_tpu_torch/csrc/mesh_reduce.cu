// kmeans_reduce_shards (K21b): the cross-shard reduce of one sharded Lloyd
// step. Each corpus shard's K15b update leaves its partial sums (K, D) and
// counts (K,); this kernel adds the S shards' partials and forms the new
// centroids: where(count > 0, sum / max(count, 1), old centroid).
//
// Replaces the psum and the epilogue of lynsedb_tpu/parallel/mesh.py
// sharded_kmeans_step_fn (:117; its psum over "corpus" and the division,
// :145-149). The JAX step is deterministic, so this kernel is too (K15's
// rule): no float atomics; each element's partials are added in shard order
// s = 0..S-1, one rounded add at a time, starting from shard 0's value, so
// at S = 1 the result is K15b's own centroid to the bit. The division is
// IEEE (nvcc's default -prec-div), as K15b's and PyTorch's tensor division.
//
// Bound: bytes, (S K D + 2 K D + S K + K) * 4: at K = 1,000, D = 128, S = 4
// about 3 MB, under a microsecond at 3.35 TB/s; the S K D adds are nothing.
// The call is launch-bound.
//
// Design: a thread an element (k, d) over a grid-stride loop, consecutive
// threads on consecutive d (coalesced reads of every shard's slab); each
// thread also adds its centroid's S counts (the same few cached words for a
// row of threads), and the thread at d = 0 writes the summed count.
#include "common.cuh"

namespace {

__global__ void kmeans_reduce_shards_kernel(const float* __restrict__ sums,
                                            const float* __restrict__ counts,
                                            const float* __restrict__ old_c, int S, int K, int D,
                                            float* __restrict__ new_c,
                                            float* __restrict__ counts_out) {
  const int64_t kd = (int64_t)K * D;
  const int width = D > 0 ? D : 1;  // a D = 0 row still writes its count
  const int64_t total = (int64_t)K * width;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(e / width);
    const int d = (int)(e - (int64_t)k * width);
    float cnt = counts[k];
    for (int s = 1; s < S; ++s) cnt += counts[(int64_t)s * K + k];
    if (d == 0) counts_out[k] = cnt;
    if (d < D) {
      const int64_t at = (int64_t)k * D + d;
      float acc = sums[at];
      for (int s = 1; s < S; ++s) acc += sums[s * kd + at];
      const float denom = cnt > 1.f ? cnt : 1.f;
      new_c[at] = cnt > 0.f ? acc / denom : old_c[at];
    }
  }
}

}  // namespace

// sums (S, K, D) f32, counts (S, K) f32, centroids (K, D) f32 -> new_c (K, D)
// f32, counts_out (K,) f32.
extern "C" int lt_kmeans_reduce_shards(const float* sums, const float* counts,
                                       const float* centroids, int S, int K, int D, float* new_c,
                                       float* counts_out, cudaStream_t stream) {
  if (S < 1 || K < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t total = (int64_t)K * (D > 0 ? D : 1);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  kmeans_reduce_shards_kernel<<<blocks, kThreads, 0, stream>>>(sums, counts, centroids, S, K, D,
                                                               new_c, counts_out);
  return (int)cudaGetLastError();
}
