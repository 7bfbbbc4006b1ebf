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
// Design, k <= 1024 (select): one block per (row, chunk of up to 4096 keys)
// loads the chunk into shared memory and reduces it bitonically on (key desc,
// index asc) to its top k (common.cuh bitonic_topk: sorted runs of k, then
// halving merges, not a full sort). The passes repeat over the per-chunk
// lists (k of every 4096 keys survive a pass) until one list is left.
// Design, k > 1024 (sort and merge): one block per (row, chunk of 4096 keys)
// sorts its chunk fully in shared memory and keeps its first min(k, 4096);
// then the sorted runs are merged pairwise in device memory, each merge
// keeping its first k, until one run is left. A merge gives each thread its
// own 8 outputs: a binary search on the thread's diagonal of the merge path
// finds where its segment starts, then it merges sequentially. Bound: the
// merge levels move the surviving keys log2(N / 4096) more times.
// Both paths keep the original column index (or the caller's ids) beside
// each key, so the order of equal keys is global and the result is exactly a
// stable descending sort's first k, for any 1 <= k <= N. Rows go to
// gridDim.y in groups of at most 65,535.
#include "common.cuh"

namespace {

constexpr int kMaxChunk = 4096;
static_assert(kMaxChunk <= 4 * 1024, "bitonic_topk holds at most two entries a thread");
constexpr int kSelectMaxK = 1024;  // the select path's bound (two entries a thread)
constexpr int kSortChunk = 4096;   // the run length the sort-and-merge path starts from
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;     // outputs a merging thread writes
constexpr int kMaxRows = 65535;    // gridDim.y

__device__ __forceinline__ void load_entry(const float* keys, const int* idx_in, int64_t row_in,
                                           int p, int n, float* sk, int* si, int e) {
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

__global__ void topk_chunk_kernel(const float* __restrict__ keys, const int* __restrict__ idx_in,
                                  int64_t ld_in, int n, int chunk, int kp, int k,
                                  float* __restrict__ out_keys, int* __restrict__ out_idx,
                                  int64_t ld_out) {
  extern __shared__ unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sk + chunk);
  const int64_t row_in = (int64_t)blockIdx.y * ld_in;
  const int start = blockIdx.x * chunk;
  for (int e = threadIdx.x; e < chunk; e += blockDim.x)
    load_entry(keys, idx_in, row_in, start + e, n, sk, si, e);
  __syncthreads();
  lt::bitonic_topk(sk, si, chunk, kp);
  const int64_t row_out = (int64_t)blockIdx.y * ld_out + (int64_t)blockIdx.x * k;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_keys[row_out + e] = sk[e];
    out_idx[row_out + e] = si[e];
  }
}

// Sorts chunk `blockIdx.x` of a row fully and writes its first min(cap,
// entries) at offset blockIdx.x * cap of the output row.
__global__ void sort_chunk_kernel(const float* __restrict__ keys, const int* __restrict__ idx_in,
                                  int n, int chunk, int cap, float* __restrict__ out_keys,
                                  int* __restrict__ out_idx, int64_t ld_out) {
  extern __shared__ unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sk + chunk);
  const int64_t row_in = (int64_t)blockIdx.y * n;
  const int start = blockIdx.x * chunk;
  for (int e = threadIdx.x; e < chunk; e += blockDim.x)
    load_entry(keys, idx_in, row_in, start + e, n, sk, si, e);
  __syncthreads();
  lt::bitonic_sort(sk, si, chunk);
  const int len = min(cap, min(chunk, n - start));
  const int64_t row_out = (int64_t)blockIdx.y * ld_out + (int64_t)blockIdx.x * cap;
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    out_keys[row_out + e] = sk[e];
    out_idx[row_out + e] = si[e];
  }
}

// Entries in run r of a level whose runs cover `span` columns each and hold
// at most `cap` entries (a run keeps the first cap of its span).
__device__ __forceinline__ int run_len(int64_t r, int64_t span, int cap, int n) {
  const int64_t left = (int64_t)n - r * span;
  return left <= 0 ? 0 : (int)min((int64_t)cap, min(span, left));
}

// Merges runs 2j and 2j+1 of one level (at offsets 2j * cap_in and
// (2j+1) * cap_in of the input row) into run j of the next (offset
// j * cap_out), keeping its first min(cap_out, la + lb) entries. Run a wins
// between equal entries; the binary search and the merge agree on that.
__global__ void __launch_bounds__(kMergeThreads)
    merge_runs_kernel(const float* __restrict__ in_keys, const int* __restrict__ in_idx,
                      int64_t ld_in, int n, int64_t span_in, int cap_in, int cap_out,
                      int tiles_per_run, float* __restrict__ out_keys,
                      int* __restrict__ out_idx, int64_t ld_out) {
  const int run = blockIdx.x / tiles_per_run;
  const int tile = blockIdx.x % tiles_per_run;
  const int la = run_len(2 * (int64_t)run, span_in, cap_in, n);
  const int lb = run_len(2 * (int64_t)run + 1, span_in, cap_in, n);
  const int out_len = min(cap_out, la + lb);
  const int d0 = (tile * kMergeThreads + threadIdx.x) * kMergeItems;
  if (d0 >= out_len) return;
  const int64_t a_off = (int64_t)blockIdx.y * ld_in + 2 * (int64_t)run * cap_in;
  const float* ak = in_keys + a_off;
  const int* ai = in_idx + a_off;
  const float* bk = ak + cap_in;
  const int* bi = ai + cap_in;
  // i = how many of the first d0 merged entries come from run a
  int lo = max(0, d0 - lb), hi = min(d0, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int jb = d0 - 1 - mid;
    if (!lt::better(bk[jb], bi[jb], ak[mid], ai[mid])) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = d0 - lo;
  const int64_t o_off = (int64_t)blockIdx.y * ld_out + (int64_t)run * cap_out;
  const int end = min(d0 + kMergeItems, out_len);
  for (int e = d0; e < end; ++e) {
    const bool take_b = j < lb && (i >= la || lt::better(bk[j], bi[j], ak[i], ai[i]));
    if (take_b) {
      out_keys[o_off + e] = bk[j];
      out_idx[o_off + e] = bi[j];
      ++j;
    } else {
      out_keys[o_off + e] = ak[i];
      out_idx[o_off + e] = ai[i];
      ++i;
    }
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

// Scratch entries one row needs in each of the two buffers (at most N: a
// level's runs lie at r * cap, and only its last run is short).
long long scratch_per_row(int n, int k) {
  if (k <= kSelectMaxK) {
    const int chunk = chunk_for(n, k);
    const long long chunks = (n + chunk - 1) / chunk;
    return chunks > 1 ? chunks * k : 0;
  }
  long long most = 0;
  long long runs = (n + kSortChunk - 1) / kSortChunk;
  long long span = kSortChunk;
  while (runs > 1) {  // every level but the last, which writes the output
    const long long cap = k < span ? k : span;
    const long long last = n - (runs - 1) * span;
    const long long used = (runs - 1) * cap + (last < cap ? last : cap);
    most = used > most ? used : most;
    runs = (runs + 1) / 2;
    span *= 2;
  }
  return most;
}

int select_rows(const float* keys, const int* idx_in, int B, int N, int k, float* out_keys,
                int* out_idx, float* scratch_keys0, int* scratch_idx0, float* scratch_keys1,
                int* scratch_idx1, cudaStream_t stream) {
  const int* in_idx = idx_in;
  const float* in_keys = keys;
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

int sort_merge_rows(const float* keys, const int* idx_in, int B, int N, int k, float* out_keys,
                    int* out_idx, float* scratch_keys[2], int* scratch_idx[2], int64_t ld_s,
                    cudaStream_t stream) {
  if (N <= kSortChunk) {  // one chunk: sort the row, keep its first k
    const int chunk = next_pow2(N);
    const int threads = chunk / 2 < 1024 ? chunk / 2 : 1024;
    const size_t smem = (size_t)chunk * (sizeof(float) + sizeof(int));
    sort_chunk_kernel<<<dim3(1, B), threads, smem, stream>>>(keys, idx_in, N, chunk, k, out_keys,
                                                            out_idx, k);
    return (int)cudaGetLastError();
  }
  int runs = (N + kSortChunk - 1) / kSortChunk;
  int cap = k < kSortChunk ? k : kSortChunk;
  const size_t smem = (size_t)kSortChunk * (sizeof(float) + sizeof(int));
  sort_chunk_kernel<<<dim3(runs, B), 1024, smem, stream>>>(keys, idx_in, N, kSortChunk, cap,
                                                          scratch_keys[0], scratch_idx[0], ld_s);
  cudaError_t err = cudaGetLastError();
  int64_t span = kSortChunk;
  int ping = 0;
  while (err == cudaSuccess && runs > 1) {
    const int runs_out = (runs + 1) / 2;
    const int cap_out = (int64_t)k < 2 * span ? k : (int)(2 * span);
    const bool last = runs_out == 1;
    const int tiles = (cap_out + kMergeThreads * kMergeItems - 1) / (kMergeThreads * kMergeItems);
    merge_runs_kernel<<<dim3(runs_out * tiles, B), kMergeThreads, 0, stream>>>(
        scratch_keys[ping], scratch_idx[ping], ld_s, N, span, cap, cap_out, tiles,
        last ? out_keys : scratch_keys[ping ^ 1], last ? out_idx : scratch_idx[ping ^ 1],
        last ? k : ld_s);
    err = cudaGetLastError();
    runs = runs_out;
    cap = cap_out;
    span *= 2;
    ping ^= 1;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Entries each of the two scratch buffers needs for a (B, N) selection of k
// (rows run in groups of at most 65,535 that reuse the buffers).
long long lt_topk_scratch(int B, int N, int k) {
  return (long long)(B < kMaxRows ? B : kMaxRows) * scratch_per_row(N, k);
}

// keys (B, N) f32 -> out_keys (B, k) f32, out_idx (B, k) int32. idx_in
// (B, N) int32, or null for the column index, is what is carried beside each
// key, breaks ties and comes out in out_idx. scratch_keys{0,1} /
// scratch_idx{0,1}: lt_topk_scratch(B, N, k) entries each (null when 0).
int lt_topk_select(const float* keys, const int* idx_in, int B, int N, int k, float* out_keys,
                   int* out_idx, float* scratch_keys0, int* scratch_idx0, float* scratch_keys1,
                   int* scratch_idx1, cudaStream_t stream) {
  if (k < 1 || k > N || B < 1) return (int)cudaErrorInvalidValue;
  float* sk[2] = {scratch_keys0, scratch_keys1};
  int* si[2] = {scratch_idx0, scratch_idx1};
  const int64_t ld_s = scratch_per_row(N, k);
  for (int g = 0; g < B; g += kMaxRows) {
    const int rows = B - g < kMaxRows ? B - g : kMaxRows;
    const int64_t in_off = (int64_t)g * N, out_off = (int64_t)g * k;
    const int* idx = idx_in ? idx_in + in_off : nullptr;
    const int err =
        k <= kSelectMaxK
            ? select_rows(keys + in_off, idx, rows, N, k, out_keys + out_off, out_idx + out_off,
                          sk[0], si[0], sk[1], si[1], stream)
            : sort_merge_rows(keys + in_off, idx, rows, N, k, out_keys + out_off,
                              out_idx + out_off, sk, si, ld_s, stream);
    if (err != 0) return err;
  }
  return 0;
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
