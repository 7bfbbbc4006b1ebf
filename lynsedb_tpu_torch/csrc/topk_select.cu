// K5: top-k selection of a (B, N) f32 key matrix, best first, lower index
// first between equal keys, NaN as -inf.
//
// Replaces lynsedb_tpu/ops/topk.py masked_top_k / masked_top_c / merge_top_k
// (jax.lax.top_k and, on the TPU, approx_max_k; exact here).
//
// Bound: at the main path's shapes (B up to 256, N = 1M, k = 10 or C = 256)
// the first pass reads the whole key matrix once (4 bytes a key, 1 GB at
// B = 256) and does log^2 work per element in shared memory, so it is bound
// by shared-memory traffic of the sort more than by device memory.
// Design: one block per (row, chunk of up to 4096 keys) loads the chunk into
// shared memory and reduces it bitonically on (key desc, index asc) to its
// top k (common.cuh bitonic_topk: sorted runs of k, then halving merges, not
// a full sort). The passes repeat over the per-chunk lists (k of every 4096
// keys survive a pass) until one list is left. Every pass keeps the original
// column index beside each key, so the order of equal keys is global and the
// result is exactly a stable descending sort's first k. k <= 1024.
#include "common.cuh"

namespace {

constexpr int kMaxChunk = 4096;
static_assert(kMaxChunk <= 4 * 1024, "bitonic_topk holds at most two entries a thread");

__global__ void topk_chunk_kernel(const float* __restrict__ keys, const int* __restrict__ idx_in,
                                  int64_t ld_in, int n, int chunk, int kp, int k,
                                  float* __restrict__ out_keys, int* __restrict__ out_idx,
                                  int64_t ld_out) {
  extern __shared__ unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sk + chunk);
  const int64_t row_in = (int64_t)blockIdx.y * ld_in;
  const int start = blockIdx.x * chunk;
  for (int e = threadIdx.x; e < chunk; e += blockDim.x) {
    const int p = start + e;
    float kv = -INFINITY;
    int iv = INT_MAX;  // padding sorts after every real entry, -inf ones included
    if (p < n) {
      kv = keys[row_in + p];
      if (isnan(kv)) kv = -INFINITY;
      iv = idx_in ? idx_in[row_in + p] : p;
    }
    sk[e] = kv;
    si[e] = iv;
  }
  __syncthreads();
  lt::bitonic_topk(sk, si, chunk, kp);
  const int64_t row_out = (int64_t)blockIdx.y * ld_out + (int64_t)blockIdx.x * k;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_keys[row_out + e] = sk[e];
    out_idx[row_out + e] = si[e];
  }
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int chunk_for(int n, int k) {  // a power of two >= k
  return n <= kMaxChunk ? next_pow2(n > k ? n : k) : kMaxChunk;
}

}  // namespace

extern "C" {

// Number of per-chunk entries the first pass writes per row; the wrapper
// sizes each of the two scratch buffers to B times this.
long long lt_topk_scratch_per_row(int n, int k) {
  const int chunk = chunk_for(n, k);
  const long long chunks = (n + chunk - 1) / chunk;
  return chunks > 1 ? chunks * k : 0;
}

// keys (B, N) f32 -> out_keys (B, k) f32, out_idx (B, k) int32 column indices.
// scratch_keys{0,1} / scratch_idx{0,1}: B * lt_topk_scratch_per_row(N, k)
// entries each (may be null when that is 0).
int lt_topk_select(const float* keys, int B, int N, int k, float* out_keys, int* out_idx,
                   float* scratch_keys0, int* scratch_idx0, float* scratch_keys1,
                   int* scratch_idx1, cudaStream_t stream) {
  if (k < 1 || k > 1024 || k > N || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const float* in_keys = keys;
  const int* in_idx = nullptr;
  int64_t ld = N;
  int n = N;
  int ping = 0;
  while (true) {
    const int chunk = chunk_for(n, k);
    const int chunks = (n + chunk - 1) / chunk;
    const bool last = chunks == 1;
    float* dst_keys = last ? out_keys : (ping ? scratch_keys1 : scratch_keys0);
    int* dst_idx = last ? out_idx : (ping ? scratch_idx1 : scratch_idx0);
    const int64_t ld_out = last ? k : (int64_t)chunks * k;
    const int threads = chunk / 2 < 32 ? 32 : (chunk / 2 > 1024 ? 1024 : chunk / 2);
    const size_t smem = (size_t)chunk * (sizeof(float) + sizeof(int));
    topk_chunk_kernel<<<dim3(chunks, B), threads, smem, stream>>>(
        in_keys, in_idx, ld, n, chunk, next_pow2(k), k, dst_keys, dst_idx, ld_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return (int)err;
    in_keys = dst_keys;
    in_idx = dst_idx;
    ld = ld_out;
    n = chunks * k;
    ping ^= 1;
  }
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
