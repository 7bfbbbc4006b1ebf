// K14: the randomized Hadamard rotation of the RaBitQ and PolarVec queries.
// Pads each query row to dim_pad (a power of two), flips the signs, runs the
// log2(dim_pad) butterfly stages of the fast Walsh-Hadamard transform and
// divides by sqrt(dim_pad), so the transform is orthonormal.
//
// Replaces lynsedb_tpu/ops/quantize.py fwht (:40) and rotate (:59). A stage
// of width h pairs element j * 2h + i with j * 2h + h + i and writes a + b to
// the first, a - b to the second: quantize.py's reshape to (d / 2h, 2, h) and
// concatenate, the same additions in the same order, so the output equals the
// JAX rotation to the last bit.
//
// Bound: bytes, B * (D + dim_pad) * 4 plus dim_pad * 4 for the signs, and
// B * dim_pad * (log2(dim_pad) + 2) flops: microseconds at any batch. The
// call is launch-bound.
// Design: one block per query row holds the padded row in shared memory; each
// stage is one pass of the block's threads over dim_pad / 2 pairs (looping
// when dim_pad / 2 exceeds the block), with a barrier between stages.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;

__global__ void fwht_rotate_kernel(const float* __restrict__ q, const float* __restrict__ signs,
                                   int D, int Dp, float* __restrict__ out) {
  extern __shared__ float xs[];
  const float* qb = q + (int64_t)blockIdx.x * D;
  for (int d = threadIdx.x; d < Dp; d += blockDim.x) xs[d] = (d < D ? qb[d] : 0.f) * signs[d];
  __syncthreads();
  for (int h = 1; h < Dp; h <<= 1) {
    for (int t = threadIdx.x; t < (Dp >> 1); t += blockDim.x) {
      const int i = (t / h) * 2 * h + (t & (h - 1));
      const float a = xs[i], b = xs[i + h];
      xs[i] = a + b;
      xs[i + h] = a - b;
    }
    __syncthreads();
  }
  const float norm = sqrtf((float)Dp);
  float* ob = out + (int64_t)blockIdx.x * Dp;
  for (int d = threadIdx.x; d < Dp; d += blockDim.x) ob[d] = xs[d] / norm;
}

}  // namespace

// q (B, D) f32, signs (Dp,) f32 of +-1 -> out (B, Dp) f32; Dp a power of two
// and >= D.
extern "C" int lt_fwht_rotate(const float* q, const float* signs, int B, int D, int Dp, float* out,
                              cudaStream_t stream) {
  if (B < 1 || D < 1 || Dp < D || (Dp & (Dp - 1)) != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Dp * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = Dp / 2 < 32 ? 32 : (Dp / 2 > kMaxThreads ? kMaxThreads : Dp / 2);
  fwht_rotate_kernel<<<B, threads, smem, stream>>>(q, signs, D, Dp, out);
  return (int)cudaGetLastError();
}
