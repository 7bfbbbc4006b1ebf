// K5: top-k selection of a (B, N) f32 key matrix, best first, lower index
// first between equal keys, NaN as -inf.
//
// Replaces lynsedb_tpu/ops/topk.py masked_top_k / masked_top_c / merge_top_k
// (jax.lax.top_k and, on the TPU, approx_max_k; exact here).
//
// Bound: the key matrix is read once (4 bytes a key, and 4 more a caller id;
// 1 GB at B = 256, N = 1M), so the kernel is bound by device memory as long
// as the selection work per key stays small.
// Design, k <= 1,024 (select): one warp per (row, span of the row) reads
// its span once with 16-byte loads, two rounds ahead, and keeps a running
// top k (common.cuh WarpTopk, the selection K2's fused pass uses): a key
// joins the candidates only if it beats the k-th best kept so far, so past
// the first keys of a span almost every key costs one compare, and the warp
// merges its candidates by itself, with no block barrier. Spans are sized
// from B so the grid is one wave of the warps the card holds at once, each
// span at least 16 k long; the per-span lists (k of every span, with their ids) go through the
// same kernel again, in ids mode, until one span is left.
// Design, k > 1,024 (sort and merge): one block per (row, chunk of 4096 keys)
// sorts its chunk fully in shared memory and keeps its first min(k, 4096);
// then the sorted runs are merged pairwise in device memory, each merge
// keeping its first k, until one run is left. A merge gives each thread its
// own 8 outputs: a binary search on the thread's diagonal of the merge path
// finds where its segment starts, then it merges sequentially. Bound: the
// merge levels move the surviving keys log2(N / 4096) more times. (Past
// k = 1,024 a warp's list merges its candidates at a cost that grows with
// k while fewer spans fill the card, so this path is the faster one.)
// Both paths keep the original column index (or the caller's ids) beside
// each key, so the order of equal keys is global and the result is exactly a
// stable descending sort's first k, for any 1 <= k <= N. Rows go to
// gridDim.y in groups of at most 65,535.
#include "common.cuh"

namespace {

constexpr int kSelectMaxK = 1024;  // the select path's bound
constexpr int kSelectWarps = 8;    // warps (spans) a block
constexpr int kRound = 4 * 32;     // keys a warp offers a round
constexpr int kSortChunk = 4096;   // the run length the sort-and-merge path starts from
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;     // outputs a merging thread writes
constexpr int kMaxRows = 65535;    // gridDim.y
constexpr int kPend = lt::WarpTopk::kPend;

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

// Keys p0 .. p0 + 3 of a row and their ids (idx_in's, or the column); past
// `end`, (-inf, INT_MAX), which is never offered.
struct Four {
  float k[4];
  int i[4];
};

__device__ __forceinline__ Four load4(const float* __restrict__ keys,
                                      const int* __restrict__ idx_in, int64_t row, int p0,
                                      int end, bool vec) {
  Four f;
  if (vec && p0 + 3 < end) {
    const float4 k4 = __ldg(reinterpret_cast<const float4*>(keys + row + p0));
    f.k[0] = k4.x, f.k[1] = k4.y, f.k[2] = k4.z, f.k[3] = k4.w;
    if (idx_in) {
      const int4 i4 = __ldg(reinterpret_cast<const int4*>(idx_in + row + p0));
      f.i[0] = i4.x, f.i[1] = i4.y, f.i[2] = i4.z, f.i[3] = i4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f.i[e] = p0 + e;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + e;
      f.k[e] = p < end ? keys[row + p] : -INFINITY;
      f.i[e] = p < end ? (idx_in ? idx_in[row + p] : p) : INT_MAX;
    }
  }
  return f;
}

// Warp w of block b takes span (b * kSelectWarps + w) % spans of row
// (b * kSelectWarps + w) / spans: the best k of its keys [span * len, + len)
// (NaN as -inf; ids from idx_in, or the column), sorted, at offset
// span * k of the output row; a span with fewer entries pads with (-inf,
// INT_MAX), which the next level never keeps. `vec`: rows, spans and both
// pointers are 16-byte aligned, so every full group of 4 is one float4 (and
// int4) load.
__global__ void __launch_bounds__(kSelectWarps * 32)
    select_span_kernel(const float* __restrict__ keys, const int* __restrict__ idx_in,
                       int64_t ld_in, int rows, int n, int spans, int len, int k, int kp,
                       bool vec, float* __restrict__ out_keys, int* __restrict__ out_idx,
                       int64_t ld_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kSelectWarps + warp;
  if (item >= (int64_t)rows * spans) return;  // no block barrier follows
  const int r = (int)(item / spans), s = (int)(item % spans);
  uint64_t* list = reinterpret_cast<uint64_t*>(smem) + (int64_t)warp * (kp + kPend);
  lt::WarpTopk top;
  top.init(list, kp, lt::kPadEntry);
  const int64_t row = (int64_t)r * ld_in;
  const int start = s * len, end = min(n, start + len);
  Four cur = load4(keys, idx_in, row, start + 4 * lane, end, vec);
  Four nxt = load4(keys, idx_in, row, start + kRound + 4 * lane, end, vec);
  for (int base = start; base < end; base += kRound) {
    const Four ahead = load4(keys, idx_in, row, base + 2 * kRound + 4 * lane, end, vec);
    if (top.pend > kPend - kRound) top.flush(kp, k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      top.offer(kp, lt::pack_entry(isnan(cur.k[e]) ? -INFINITY : cur.k[e], cur.i[e]),
                base + 4 * lane + e < end);
    cur = nxt;
    nxt = ahead;
  }
  top.flush(kp, k);
  const int64_t o = (int64_t)r * ld_out + (int64_t)s * k;
  for (int e = lane; e < k; e += 32) {
    out_keys[o + e] = lt::entry_key(list[e]);
    out_idx[o + e] = lt::entry_id(list[e]);
  }
}

// The merge of sorted runs: row blockIdx.x of keys / ids holds `runs` runs
// of r <= 256 entries, each sorted best first (as the fused first pass's
// span lists and K8's state are); block (row, g) merges runs [g * per,
// + per) of its row into out[row * gridDim.y + g], the best r of them, so
// a few rows of many runs take two launches, the second over the first's
// gridDim.y runs a row. Runs merge pairwise, level by level, in the block:
// a warp holds the two runs, 8
// entries a lane (packed as common.cuh pack_entry, padded to rp = r rounded
// up to a power of two), keeps the larger of each entry and the other run's
// entry rp - 1 - its position (one shuffle) - the best rp as a bitonic
// sequence - and sorts it with log2(rp) compare-exchange steps; the levels
// alternate between two scratch buffers of (runs + 1) / 2 runs.
constexpr int kRunWarps = 32;

__device__ __forceinline__ void load_run(const float* keys, const int* ids,
                                         const uint64_t* packed, int64_t at, int r, int lanes,
                                         uint64_t (&v)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int p = lane * 8 + e;
    if (lane >= lanes || p >= r) {
      v[e] = lt::kPadEntry;
    } else if (packed) {
      v[e] = packed[at + p];
    } else {
      const float kv = keys[at + p];
      v[e] = lt::pack_entry(isnan(kv) ? -INFINITY : kv, ids[at + p]);
    }
  }
}

__global__ void __launch_bounds__(kRunWarps * 32)
    merge_runs_sorted_kernel(const float* __restrict__ keys, const int* __restrict__ ids,
                             int runs, int r, int per, uint64_t* __restrict__ scratch,
                             float* __restrict__ out_keys, int* __restrict__ out_idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rp = lt::list_kp(r), lanes = rp >> 3;
  const int64_t block = (int64_t)blockIdx.x * gridDim.y + blockIdx.y;
  const int first = blockIdx.y * per;
  const int64_t half = (int64_t)(per + 1) / 2 * rp;  // one scratch buffer of a block
  uint64_t* buf[2] = {scratch + block * 2 * half, scratch + block * 2 * half + half};
  const float* row_keys = keys + ((int64_t)blockIdx.x * runs + first) * r;
  const int* row_ids = ids + ((int64_t)blockIdx.x * runs + first) * r;
  const uint64_t* src = nullptr;  // null: the input, stride r; else a buffer, stride rp
  int ping = 0;
  for (int n = min(per, runs - first); n > 1 || src == nullptr; n = (n + 1) / 2) {
    const int pairs = n / 2, outs = (n + 1) / 2;
    const int64_t stride = src ? rp : r;
    uint64_t* dst = buf[ping];
    for (int o = warp; o < outs; o += kRunWarps) {
      uint64_t a[8], b[8];
      load_run(row_keys, row_ids, src, 2 * o * stride, r, lanes, a);
      if (o < pairs) {
        load_run(row_keys, row_ids, src, (2 * o + 1) * stride, r, lanes, b);
        // a[p] against b[rp - 1 - p]: lane ^ (lanes - 1), register 7 - e
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint64_t other = __shfl_xor_sync(0xffffffffu, b[7 - e], lanes - 1);
          a[e] = a[e] > other ? a[e] : other;
        }
        for (int m = lanes >> 1; m > 0; m >>= 1) {
          const bool lower = (lane & m) == 0;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint64_t other = __shfl_xor_sync(0xffffffffu, a[e], m);
            a[e] = lower == (other > a[e]) ? other : a[e];
          }
        }
#pragma unroll
        for (int stride2 = 4; stride2 > 0; stride2 >>= 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (e & stride2) continue;
            if (a[e + stride2] > a[e]) {
              const uint64_t t = a[e];
              a[e] = a[e + stride2];
              a[e + stride2] = t;
            }
          }
        }
      }
      if (outs == 1) {  // the last level writes the row's answer
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int p = lane * 8 + e;
          if (lane < lanes && p < r) {
            out_keys[block * r + p] = lt::entry_key(a[e]);
            out_idx[block * r + p] = lt::entry_id(a[e]);
          }
        }
      } else if (lane < lanes) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[(int64_t)o * rp + lane * 8 + e] = a[e];
      }
    }
    __syncthreads();
    if (outs == 1) break;
    src = dst;
    ping ^= 1;
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

struct Spans {
  int count, len;
};

size_t select_smem(int k) {
  return (size_t)kSelectWarps * (lt::list_kp(k) + kPend) * sizeof(uint64_t);
}

// The warps (spans) the card holds at once for a select of k.
int select_wave(int k) {
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(select_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)select_smem(kSelectMaxK));
    raised = true;
  }
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, select_span_kernel, kSelectWarps * 32,
                                                select_smem(k));
  return max(n, 1) * kSelectWarps * lt::sm_count();
}

// How a level of the select cuts rows of n entries: one wave of warps over
// `rows` rows, each span at least 16 k and 2,048 long (so a level keeps at
// most a sixteenth of its entries).
Spans select_spans(int rows, int n, int k) {
  const int min_len = max(16 * k, 2048);
  const int most = max(1, n / min_len);
  const int want = select_wave(k) / rows;
  const int count = max(1, min(most, want));
  const int len = ((n + count - 1) / count + 3) / 4 * 4;
  return {(n + len - 1) / len, len};
}

// Scratch entries one row needs in each of the two buffers: the first
// level's lists (the later levels' are smaller).
long long scratch_per_row(int rows, int n, int k) {
  if (k <= kSelectMaxK) {
    const Spans s = select_spans(rows, n, k);
    return s.count > 1 ? (long long)s.count * k : 0;
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

int select_rows(const float* keys, const int* idx_in, int B, int N, int k, int plan_rows,
                float* out_keys, int* out_idx, float* scratch_keys[2], int* scratch_idx[2],
                cudaStream_t stream) {
  const int kp = lt::list_kp(k);
  const size_t smem = select_smem(k);
  const float* in_keys = keys;
  const int* in_idx = idx_in;
  int64_t ld = N;
  int n = N;
  int ping = 0;
  while (true) {
    const Spans s = select_spans(plan_rows, n, k);
    const bool last = s.count == 1;
    float* dst_keys = last ? out_keys : scratch_keys[ping];
    int* dst_idx = last ? out_idx : scratch_idx[ping];
    const int64_t ld_out = last ? k : (int64_t)s.count * k;
    const bool vec = ld % 4 == 0 && lt::aligned16(in_keys) && (!in_idx || lt::aligned16(in_idx));
    const long long items = (long long)B * s.count;
    select_span_kernel<<<(unsigned)((items + kSelectWarps - 1) / kSelectWarps),
                         kSelectWarps * 32, smem, stream>>>(
        in_keys, in_idx, ld, B, n, s.count, s.len, k, kp, vec, dst_keys, dst_idx, ld_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return (int)err;
    in_keys = dst_keys;
    in_idx = dst_idx;
    ld = ld_out;
    n = s.count * k;
    ping ^= 1;
  }
}

int sort_merge_rows(const float* keys, const int* idx_in, int B, int N, int k, float* out_keys,
                    int* out_idx, float* scratch_keys[2], int* scratch_idx[2], int64_t ld_s,
                    cudaStream_t stream) {
  if (N <= kSortChunk) {  // one chunk: sort the row, keep its first k
    const int chunk = lt::next_pow2(N);
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
  const int rows = B < kMaxRows ? B : kMaxRows;
  return (long long)rows * scratch_per_row(rows, N, k);
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
  const int plan_rows = B < kMaxRows ? B : kMaxRows;  // every group cuts its rows alike
  const int64_t ld_s = scratch_per_row(plan_rows, N, k);
  for (int g = 0; g < B; g += kMaxRows) {
    const int rows = B - g < kMaxRows ? B - g : kMaxRows;
    const int64_t in_off = (int64_t)g * N, out_off = (int64_t)g * k;
    const int* idx = idx_in ? idx_in + in_off : nullptr;
    const int err =
        k <= kSelectMaxK
            ? select_rows(keys + in_off, idx, rows, N, k, plan_rows, out_keys + out_off,
                          out_idx + out_off, sk, si, stream)
            : sort_merge_rows(keys + in_off, idx, rows, N, k, out_keys + out_off,
                              out_idx + out_off, sk, si, ld_s, stream);
    if (err != 0) return err;
  }
  return 0;
}

// Scratch (uint64 entries) of lt_topk_merge_runs.
long long lt_topk_merge_scratch(int B, int runs, int r, int per) {
  const long long groups = (runs + per - 1) / per;
  return (long long)B * groups * 2 * ((per + 1) / 2) * lt::list_kp(r);
}

// keys / ids (B, runs * r), each run of r <= 256 entries sorted best first
// -> out_keys / out_idx (B, ceil(runs / per) * r): the best r of each
// group of `per` runs, in topk_select's order (per >= runs: the best r of
// the row, what lt_topk_select gives in ids mode). scratch:
// lt_topk_merge_scratch entries.
int lt_topk_merge_runs(const float* keys, const int* ids, int B, int runs, int r, int per,
                       float* out_keys, int* out_idx, uint64_t* scratch, cudaStream_t stream) {
  if (B < 1 || runs < 1 || r < 1 || r > 256 || per < 1) return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)((runs + per - 1) / per);
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  merge_runs_sorted_kernel<<<dim3((unsigned)B, groups), kRunWarps * 32, 0, stream>>>(
      keys, ids, runs, r, per, scratch, out_keys, out_idx);
  return (int)cudaGetLastError();
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
