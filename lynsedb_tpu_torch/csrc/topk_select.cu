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
// Design, 1,024 < k <= kRadixCap = 16,384 (radix select, then a sort of the
// survivors): each entry is a 64-bit value v = (the key's order-preserving
// code, NaN as -inf and -0 as +0) << 32 | (INT_MAX - its id), which orders
// as better() does. Up to three passes over the row (six in ids mode, the
// last three on the id's bits) narrow a prefix of v: blocks of a row count a
// digit of the entries that match the prefix (12, 12, 8 bits) in shared
// memory, add their counts to the row's histogram by integer atomics (exact
// in any order) and store their own suffix sums; the row's last block to
// finish finds the digit holding the k-th entry and either narrows the
// prefix or, once the entries at and above its bucket fit the survivor
// buffer (at most 2 kp of them) or every bit is resolved, ends the select and
// turns the blocks' suffix sums into each block's output offsets. Then one
// pass writes the survivors in column order (a stable per-block prefix
// count, no atomics): every entry above the bucket, and the bucket's (or,
// when all bits are resolved, the entries equal to the k-th value: the
// first of them in column order). One block a row then sorts the
// survivors (at most 2 kp) in shared memory by rank: it cuts the span of
// their values into 4,096 ranges, counts each, and ranks a survivor as the
// survivors of the ranges above its own plus those of its own that come
// first (a larger v, or an equal v at an earlier slot), compared one by one:
// where the values spread, a range holds a handful. The survivors of rank
// below k are written at their rank, each key read back from its slot (so
// -0.0 stays -0.0). A row of N <= kRadixCap is sorted whole the same way.
// The passes after the select ends exit at once.
// Design, k > kRadixCap (sort and merge): one block per (row, chunk of 4096
// keys) sorts its chunk fully in shared memory and keeps its first min(k,
// 4096); then the sorted runs are merged pairwise in device memory, each
// merge keeping its first k, until one run is left. A merge gives each
// thread its own 8 outputs: a binary search on the thread's diagonal of the
// merge path finds where its segment starts, then it merges sequentially.
// Every path keeps the original column index (or the caller's ids) beside
// each key, so the order of equal keys is global and the result is exactly a
// stable descending sort's first k, for any 1 <= k <= N. Rows go to
// gridDim.y in groups of at most 65,535.
#include <algorithm>

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

// ---- 1,024 < k <= kRadixCap: radix select, then a sort of the survivors ----

constexpr int kRadixCap = 16384;     // index/quantized.py SHORTLIST_MAX: a sort in shared memory
constexpr int kRadixThreads = 256;   // the select passes' blocks
constexpr int kRadixBins = 4096;     // the widest digit's bins (12 bits)
constexpr int kRadixMinSpan = 8192;  // keys a block of a pass reads at least
constexpr int kRadixPasses = 6;      // digits of v: the code's 32 bits, then the id's
constexpr int kQuads = 2;            // float4 loads a thread has in flight in a pass
constexpr int kCompactQuads = 4;     // consecutive float4s a thread takes a compaction round
constexpr int kSortThreads = 1024;   // the survivors' sort, a block a row
constexpr int kSortBucketBits = 12;  // its value ranges
constexpr int kSortBuckets = 1 << kSortBucketBits;
__constant__ int kDigitShift[kRadixPasses] = {52, 40, 32, 20, 8, 0};
__constant__ int kDigitBits[kRadixPasses] = {12, 12, 8, 12, 12, 8};
// A row's control block (ints, at the start of its share of scratch_keys0):
// the pass's histogram, the state, then each block's output offsets.
constexpr int kCtrlState = kRadixBins;
constexpr int kCtrlOffsets = kRadixBins + 32;
enum RadixState {
  kPreHi, kPreLo, kMskHi, kMskLo,  // the prefix narrowed so far and its mask
  kAbove,                          // entries above the prefix's class
  kDone,                           // 0 selecting, kFits or kExact
  kArrived,                        // blocks of the pass done
  kTotalA,                         // survivors above the tie class
  kCount,                          // survivors
};
enum RadixEnd { kFits = 1, kExact = 2 };
// A block's record (ints, in scratch_idx0): its entries above the prefix's
// class, then the suffix sums of its digit histogram.
constexpr int kBlockRecord = kRadixBins + 4;

struct RadixPlan {
  int blocks, span;  // blocks a row and the keys each reads (a multiple of 4)
  int fit_cap;       // survivors the select may end with: 2 kp, at most kRadixCap
  long long ctrl, record, survivors;  // ints a row needs of each
};

RadixPlan radix_plan(int rows, int n, int k) {
  RadixPlan p{};
  const int want = (2 * 4 * lt::sm_count() + rows - 1) / rows;  // about two waves of blocks
  p.blocks = max(1, min(want, n / kRadixMinSpan));
  p.span = ((n + p.blocks - 1) / p.blocks + 3) / 4 * 4;
  p.blocks = (n + p.span - 1) / p.span;
  p.fit_cap = min(kRadixCap, 2 * lt::list_kp(k));
  p.ctrl = kCtrlOffsets + 2LL * p.blocks;
  p.record = (long long)p.blocks * kBlockRecord;
  p.survivors = p.fit_cap;
  return p;
}

__device__ __forceinline__ uint32_t key_code(float key) {  // pack_entry's high word
  if (isnan(key)) key = -INFINITY;
  const uint32_t u = __float_as_uint(key + 0.f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ uint64_t entry_value(uint32_t code, int id) {
  return ((uint64_t)code << 32) | (uint32_t)((int64_t)INT_MAX - id);
}

// The keys (NaN as -inf) and ids of positions p0 .. p0 + 3 of a row; `ok`:
// the position lies in [p0's span, end).
__device__ __forceinline__ void load_quad(const float* __restrict__ keys,
                                          const int* __restrict__ ids, int64_t row, int p0,
                                          int end, bool vec, bool want_ids, float (&k)[4],
                                          int (&id)[4]) {
  if (vec && p0 + 3 < end) {
    const float4 k4 = __ldg(reinterpret_cast<const float4*>(keys + row + p0));
    k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
    if (want_ids && ids) {
      const int4 i4 = __ldg(reinterpret_cast<const int4*>(ids + row + p0));
      id[0] = i4.x, id[1] = i4.y, id[2] = i4.z, id[3] = i4.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      k[e] = p0 + e < end ? __ldg(keys + row + p0 + e) : -INFINITY;
      if (want_ids && ids) id[e] = p0 + e < end ? __ldg(ids + row + p0 + e) : 0;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (isnan(k[e])) k[e] = -INFINITY;
    if (!ids) id[e] = p0 + e;
  }
}

// x of every thread of the block -> the sum over the threads after this one
// (and `total`). `warp_tot`: kRadixThreads / 32 ints of shared memory.
__device__ __forceinline__ int suffix_after(int x, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_down_sync(0xffffffffu, s, o);
    if (lane + o < 32) s += t;
  }
  if (lane == 0) warp_tot[warp] = s;
  __syncthreads();
  int after = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kRadixThreads / 32; ++w) {
    const int v = warp_tot[w];
    tot += v;
    after += w > warp ? v : 0;
  }
  __syncthreads();
  total = tot;
  return s - x + after;
}

// x of every thread -> the sum over the threads before this one (and `total`).
__device__ __forceinline__ int prefix_before(int x, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) warp_tot[warp] = s;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kRadixThreads / 32; ++w) {
    const int v = warp_tot[w];
    tot += v;
    before += w < warp ? v : 0;
  }
  __syncthreads();
  total = tot;
  return s - x + before;
}

// h[d] = the sum of h[d'] for d' >= d, in place, over `bins` (256 or 4096).
__device__ __forceinline__ void suffix_in_place(int* h, int bins, int* warp_tot) {
  const int per = bins / kRadixThreads, d0 = threadIdx.x * per;
  int run = 0;
  for (int i = per - 1; i >= 0; --i) run += h[d0 + i];
  int total;
  int carry = suffix_after(run, warp_tot, total);
  for (int i = per - 1; i >= 0; --i) {
    carry += h[d0 + i];
    h[d0 + i] = carry;
  }
  __syncthreads();
}

// One pass of the select over block (blockIdx.x) of row (blockIdx.y): the
// digit `pass` of the entries whose v matches the row's prefix. The row's
// last block decides (see the note at the top).
__global__ void __launch_bounds__(kRadixThreads)
    radix_count_kernel(const float* __restrict__ keys, const int* __restrict__ ids, int n,
                       RadixPlan plan, int k, int64_t per_row, int* __restrict__ ctrl_all,
                       int* __restrict__ record_all, int pass, int last_pass, bool vec) {
  __shared__ int hist[kRadixBins];
  __shared__ int warp_tot[kRadixThreads / 32];
  __shared__ int flag;
  const int r = blockIdx.y, j = blockIdx.x;
  int* ctrl = ctrl_all + (int64_t)r * per_row;
  int* st = ctrl + kCtrlState;
  if (st[kDone] != 0) return;  // the select of this row has ended (uniform)
  const int shift = kDigitShift[pass], bits = kDigitBits[pass], bins = 1 << bits;
  const uint64_t pre = ((uint64_t)(uint32_t)st[kPreHi] << 32) | (uint32_t)st[kPreLo];
  const uint64_t msk = ((uint64_t)(uint32_t)st[kMskHi] << 32) | (uint32_t)st[kMskLo];
  const bool want_ids = shift < 32 || (uint32_t)msk != 0;
  for (int d = threadIdx.x; d < bins; d += kRadixThreads) hist[d] = 0;
  __syncthreads();
  const int64_t row = (int64_t)r * n;
  const int start = j * plan.span, end = min(n, start + plan.span);
  int above = 0;
  for (int base = start; base < end; base += kQuads * 4 * kRadixThreads) {
    float kv[kQuads][4];
    int id[kQuads][4] = {};
#pragma unroll
    for (int u = 0; u < kQuads; ++u)  // every load of the round in flight at once
      load_quad(keys, ids, row, base + (u * kRadixThreads + threadIdx.x) * 4, end, vec, want_ids,
                kv[u], id[u]);
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = base + (u * kRadixThreads + (int)threadIdx.x) * 4 + e < end;
        const uint64_t v = entry_value(key_code(kv[u][e]), id[u][e]);
        const uint64_t m = v & msk;
        const bool cand = in && m == pre;
        above += in && m > pre;
        // one shared add a candidate: aggregating a warp's equal digits
        // first (ballots) cost more than the conflicts it saves
        if (cand) atomicAdd(&hist[(uint32_t)(v >> shift) & (uint32_t)(bins - 1)], 1);
      }
    }
  }
  __syncthreads();
  int blk_above;
  suffix_after(above, warp_tot, blk_above);
  int* rec = record_all + ((int64_t)r * plan.blocks + j) * kBlockRecord;
  int* G = ctrl;
  for (int d = threadIdx.x; d < bins; d += kRadixThreads)
    if (hist[d]) atomicAdd(&G[d], hist[d]);
  suffix_in_place(hist, bins, warp_tot);
  for (int d = threadIdx.x; d < bins; d += kRadixThreads) rec[1 + d] = hist[d];
  if (threadIdx.x == 0) rec[0] = blk_above;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) flag = atomicAdd(&st[kArrived], 1) == plan.blocks - 1;
  __syncthreads();
  if (!flag) return;
  __threadfence();  // the row's last block: every block's counts are in
  for (int d = threadIdx.x; d < bins; d += kRadixThreads) hist[d] = __ldcg(&G[d]);
  __syncthreads();
  suffix_in_place(hist, bins, warp_tot);
  const int row_above = __ldcg(&st[kAbove]);
  const int need = k - row_above;  // the k-th entry is the need-th of the prefix's class
  for (int d = threadIdx.x; d < bins; d += kRadixThreads) {
    const int after = d + 1 < bins ? hist[d + 1] : 0;
    if (hist[d] >= need && after < need) flag = d;  // exactly one digit
  }
  __syncthreads();
  const int b = flag;
  const int above_b = b + 1 < bins ? hist[b + 1] : 0;
  const int new_above = row_above + above_b;
  const int in_bucket = hist[b] - above_b;
  const uint64_t pre2 = pre | ((uint64_t)b << shift);
  const uint64_t msk2 = msk | ((uint64_t)(bins - 1) << shift);
  const bool fits = new_above + in_bucket <= plan.fit_cap;
  if (!fits && pass < last_pass) {  // narrow the prefix; the next pass counts afresh
    for (int d = threadIdx.x; d < bins; d += kRadixThreads) G[d] = 0;
    if (threadIdx.x == 0) {
      st[kPreHi] = (int)(uint32_t)(pre2 >> 32);
      st[kPreLo] = (int)(uint32_t)pre2;
      st[kMskHi] = (int)(uint32_t)(msk2 >> 32);
      st[kMskLo] = (int)(uint32_t)msk2;
      st[kAbove] = new_above;
      st[kArrived] = 0;
    }
    return;
  }
  // the select ends: each block's survivors above the tie class (A) and in
  // it (E), from its record, and their offsets in block order
  int* off_a = ctrl + kCtrlOffsets;
  int* off_e = off_a + plan.blocks;
  int carry_a = 0, carry_e = 0;
  for (int j0 = 0; j0 < plan.blocks; j0 += kRadixThreads) {
    const int jj = j0 + threadIdx.x;
    int a = 0, e = 0;
    if (jj < plan.blocks) {
      const int* rj = record_all + ((int64_t)r * plan.blocks + jj) * kBlockRecord;
      const int s_b = __ldcg(&rj[1 + b]);
      const int s_after = b + 1 < bins ? __ldcg(&rj[2 + b]) : 0;
      a = __ldcg(&rj[0]) + (fits ? s_b : s_after);
      e = fits ? 0 : s_b - s_after;
    }
    int tot_a, tot_e;
    const int pa = prefix_before(a, warp_tot, tot_a);
    const int pe = prefix_before(e, warp_tot, tot_e);
    if (jj < plan.blocks) {
      off_a[jj] = carry_a + pa;
      off_e[jj] = carry_e + pe;
    }
    carry_a += tot_a;
    carry_e += tot_e;
  }
  if (threadIdx.x == 0) {
    st[kPreHi] = (int)(uint32_t)(pre2 >> 32);
    st[kPreLo] = (int)(uint32_t)pre2;
    st[kMskHi] = (int)(uint32_t)(msk2 >> 32);
    st[kMskLo] = (int)(uint32_t)msk2;
    st[kAbove] = new_above;
    st[kTotalA] = carry_a;
    st[kCount] = fits ? carry_a : k;
    st[kDone] = fits ? kFits : kExact;
  }
}

// Writes block (blockIdx.x)'s survivors of row (blockIdx.y) in column order:
// A (v & msk above pre, or at it when the select ended on kFits) at the
// block's offset, then E (v & msk equal to pre, kExact) by their rank in the
// row, the first k - above of them after every A. A thread takes
// kCompactQuads x 4 consecutive keys a round, so a round of the block is one
// run of columns; its warps' survivor counts go through shared memory (two
// buffers by the round's parity), one barrier a round.
__global__ void __launch_bounds__(kRadixThreads)
    radix_compact_kernel(const float* __restrict__ keys, const int* __restrict__ ids, int n,
                         RadixPlan plan, int k, int64_t per_row, const int* __restrict__ ctrl_all,
                         float* __restrict__ surv_keys, int* __restrict__ surv_ids,
                         int64_t surv_ld, bool vec) {
  __shared__ int warp_tot[2][kRadixThreads / 32];
  const int r = blockIdx.y, j = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* ctrl = ctrl_all + (int64_t)r * per_row;
  const int* st = ctrl + kCtrlState;
  const bool fits = st[kDone] == kFits;
  const uint64_t pre = ((uint64_t)(uint32_t)st[kPreHi] << 32) | (uint32_t)st[kPreLo];
  const uint64_t msk = ((uint64_t)(uint32_t)st[kMskHi] << 32) | (uint32_t)st[kMskLo];
  const int total_a = st[kTotalA], need = k - st[kAbove];
  int at_a = ctrl[kCtrlOffsets + j], at_e = ctrl[kCtrlOffsets + plan.blocks + j];
  const int64_t row = (int64_t)r * n;
  float* sk = surv_keys + (int64_t)r * surv_ld;
  int* si = surv_ids + (int64_t)r * surv_ld;
  const int start = j * plan.span, end = min(n, start + plan.span);
  constexpr int kPer = kCompactQuads * 4;  // keys a thread a round
  int parity = 0;
  for (int base = start; base < end; base += kPer * kRadixThreads, parity ^= 1) {
    const int p0 = base + threadIdx.x * kPer;
    float kv[kCompactQuads][4];
    int id[kCompactQuads][4];
#pragma unroll
    for (int u = 0; u < kCompactQuads; ++u)
      load_quad(keys, ids, row, p0 + 4 * u, end, vec, true, kv[u], id[u]);
    uint32_t a = 0, e = 0;  // bit q of the thread's keys: in class A, in class E
#pragma unroll
    for (int u = 0; u < kCompactQuads; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = p0 + 4 * u + q < end;
        const uint64_t m = entry_value(key_code(kv[u][q]), id[u][q]) & msk;
        a |= (uint32_t)(in && (m > pre || (fits && m == pre))) << (4 * u + q);
        e |= (uint32_t)(in && !fits && m == pre) << (4 * u + q);
      }
    }
    // counts (A low, E high) before this thread within its warp, then the
    // warps' totals: the block's round in column order
    const int mine = __popc(a) | (__popc(e) << 16);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_tot[parity][warp] = incl;
    __syncthreads();
    int before = incl - mine, tot = 0;
#pragma unroll
    for (int w = 0; w < kRadixThreads / 32; ++w) {
      const int v = warp_tot[parity][w];
      tot += v;
      before += w < warp ? v : 0;
    }
    int pa = at_a + (before & 0xffff), pe = at_e + (before >> 16);
#pragma unroll
    for (int u = 0; u < kCompactQuads; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((a >> (4 * u + q)) & 1) {
          sk[pa] = kv[u][q];
          si[pa] = id[u][q];
          ++pa;
        }
        if ((e >> (4 * u + q)) & 1) {
          if (pe < need) {
            sk[total_a + pe] = kv[u][q];
            si[total_a + pe] = id[u][q];
          }
          ++pe;
        }
      }
    }
    at_a += tot & 0xffff;
    at_e += tot >> 16;
  }
}

// x of every thread of a kSortThreads block -> the sum over the threads
// after this one (and `total`); warp_tot: kSortThreads / 32 ints.
__device__ __forceinline__ int sort_suffix_after(int x, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_down_sync(0xffffffffu, s, o);
    if (lane + o < 32) s += t;
  }
  if (lane == 0) warp_tot[warp] = s;
  __syncthreads();
  int after = 0, tot = 0;
  for (int w = 0; w < kSortThreads / 32; ++w) {
    const int v = warp_tot[w];
    tot += v;
    after += w > warp ? v : 0;
  }
  __syncthreads();
  total = tot;
  return s - x + after;
}

// Sorts row (blockIdx.x)'s survivors - the kCount entries of the survivor
// buffer, or with `direct` the whole row of n - and writes the first k. A
// survivor's rank is the number of survivors before it: a larger value v, or
// an equal one at a lower slot (an earlier column). The block cuts the span
// of the survivors' values into kSortBuckets ranges ((v - min) >> shift,
// monotone in v), counts each range, and ranks each survivor as the
// survivors of the ranges above its own plus those before it in its own,
// compared one by one (a range holds a handful where the values spread; t
// survivors of one key code and nearly one id span cost t^2 compares). Each
// key is read back from its slot (-0.0 stays -0.0), each id from its value.
__global__ void __launch_bounds__(kSortThreads)
    radix_sort_kernel(const float* __restrict__ src_keys, const int* __restrict__ src_ids,
                      int64_t src_ld, int n, bool direct, const int* __restrict__ ctrl_all,
                      int64_t per_row, int k, float* __restrict__ out_keys,
                      int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[kSortThreads / 32];
  __shared__ uint64_t lo_hi[2][kSortThreads / 32];
  __shared__ int shift;
  int* above = reinterpret_cast<int*>(smem);      // survivors in the ranges above
  int* cursor = above + kSortBuckets;             // the fill of each range's list
  uint64_t* val = reinterpret_cast<uint64_t*>(cursor + kSortBuckets);
  const int r = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = direct ? n : ctrl_all[(int64_t)r * per_row + kCtrlState + kCount];
  uint16_t* by_range = reinterpret_cast<uint16_t*>(val + count);  // slots, range by range
  const float* sk = src_keys + (int64_t)r * src_ld;
  const int* si = src_ids ? src_ids + (int64_t)r * src_ld : nullptr;
  uint64_t lo = ~0ull, hi = 0;
  for (int i = threadIdx.x; i < count; i += kSortThreads) {
    const uint64_t v = entry_value(key_code(sk[i]), si ? si[i] : i);
    val[i] = v;
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
  }
  for (int b = threadIdx.x; b < kSortBuckets; b += kSortThreads) above[b] = 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t l = __shfl_xor_sync(0xffffffffu, lo, o), h = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
  if (lane == 0) lo_hi[0][warp] = lo, lo_hi[1][warp] = hi;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kSortThreads / 32; ++w) {
      lo = lo_hi[0][w] < lo ? lo_hi[0][w] : lo;
      hi = lo_hi[1][w] > hi ? lo_hi[1][w] : hi;
    }
    lo_hi[0][0] = lo;
    const uint64_t span = hi - lo;  // the ranges' shift: span >> shift < kSortBuckets
    shift = span == 0 ? 0 : max(0, 64 - __clzll((long long)span) - kSortBucketBits);
  }
  __syncthreads();
  lo = lo_hi[0][0];
  const int sh = shift;
  for (int i = threadIdx.x; i < count; i += kSortThreads)
    atomicAdd(&above[(int)((val[i] - lo) >> sh)], 1);
  __syncthreads();
  // above[b] = the survivors of the ranges past b; cursor[b] starts there
  constexpr int kPer = kSortBuckets / kSortThreads;
  int mine[kPer], run = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    mine[e] = above[threadIdx.x * kPer + e];
    run += mine[e];
  }
  int total;
  int carry = sort_suffix_after(run, warp_tot, total);
#pragma unroll
  for (int e = kPer - 1; e >= 0; --e) {
    above[threadIdx.x * kPer + e] = carry;
    cursor[threadIdx.x * kPer + e] = carry;
    carry += mine[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kSortThreads)
    by_range[atomicAdd(&cursor[(int)((val[i] - lo) >> sh)], 1)] = (uint16_t)i;
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kSortThreads) {
    const uint64_t v = val[i];
    const int b = (int)((v - lo) >> sh);
    int rank = above[b];
    for (int q = above[b], end = cursor[b]; q < end; ++q) {
      const int j = by_range[q];
      const uint64_t w = val[j];
      rank += w > v || (w == v && j < i);
    }
    if (rank < k) {
      const float kv = sk[i];
      out_keys[(int64_t)r * k + rank] = isnan(kv) ? -INFINITY : kv;
      out_idx[(int64_t)r * k + rank] = lt::entry_id(v);
    }
  }
}

size_t radix_sort_smem(int cap) {
  return (size_t)2 * kSortBuckets * sizeof(int) + (size_t)cap * (sizeof(uint64_t) + sizeof(uint16_t));
}

// Sorts the survivors (count at most `cap`) into the first k of each row.
int radix_sort_launch(const float* src_keys, const int* src_ids, int64_t src_ld, int n,
                      bool direct, const int* ctrl, int64_t per_row, int rows, int k, int cap,
                      float* out_keys, int* out_idx, cudaStream_t stream) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(radix_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)radix_sort_smem(kRadixCap));
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  radix_sort_kernel<<<rows, kSortThreads, radix_sort_smem(cap), stream>>>(
      src_keys, src_ids, src_ld, n, direct, ctrl, per_row, k, out_keys, out_idx);
  return (int)cudaGetLastError();
}

// A group of rows through the select: the control blocks zeroed, the passes,
// the compaction and the sort. N > kRadixCap >= k.
int radix_rows(const float* keys, const int* idx_in, int B, int N, int k, const RadixPlan& plan,
               int64_t per_row, float* out_keys, int* out_idx, float* scratch_keys[2],
               int* scratch_idx[2], cudaStream_t stream) {
  int* ctrl = reinterpret_cast<int*>(scratch_keys[0]);
  int* record = scratch_idx[0];
  cudaError_t err = cudaMemset2DAsync(ctrl, (size_t)per_row * sizeof(int), 0,
                                      (size_t)kCtrlOffsets * sizeof(int), B, stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec = N % 4 == 0 && lt::aligned16(keys) && (!idx_in || lt::aligned16(idx_in));
  const int last_pass = idx_in ? kRadixPasses - 1 : 2;  // column mode: the code's bits
  const dim3 grid(plan.blocks, B);
  for (int pass = 0; pass <= last_pass; ++pass) {
    radix_count_kernel<<<grid, kRadixThreads, 0, stream>>>(keys, idx_in, N, plan, k, per_row, ctrl,
                                                           record, pass, last_pass, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  radix_compact_kernel<<<grid, kRadixThreads, 0, stream>>>(keys, idx_in, N, plan, k, per_row, ctrl,
                                                           scratch_keys[1], scratch_idx[1], per_row,
                                                           vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return radix_sort_launch(scratch_keys[1], scratch_idx[1], per_row, N, false, ctrl, per_row, B,
                           k, plan.fit_cap, out_keys, out_idx, stream);
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
  if (k <= kRadixCap) {  // a row of n <= kRadixCap is sorted whole, with no scratch
    if (n <= kRadixCap) return 0;
    const RadixPlan p = radix_plan(rows, n, k);
    return std::max(p.ctrl, std::max(p.record, p.survivors));
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

// k > kRadixCap (so N > kRadixCap too).
int sort_merge_rows(const float* keys, const int* idx_in, int B, int N, int k, float* out_keys,
                    int* out_idx, float* scratch_keys[2], int* scratch_idx[2], int64_t ld_s,
                    cudaStream_t stream) {
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
    int err;
    if (k <= kSelectMaxK) {
      err = select_rows(keys + in_off, idx, rows, N, k, plan_rows, out_keys + out_off,
                        out_idx + out_off, sk, si, stream);
    } else if (k <= kRadixCap && N <= kRadixCap) {  // the row is the survivors
      err = radix_sort_launch(keys + in_off, idx, N, N, true, nullptr, 0, rows, k, N,
                              out_keys + out_off, out_idx + out_off, stream);
    } else if (k <= kRadixCap) {
      err = radix_rows(keys + in_off, idx, rows, N, k, radix_plan(plan_rows, N, k), ld_s,
                       out_keys + out_off, out_idx + out_off, sk, si, stream);
    } else {
      err = sort_merge_rows(keys + in_off, idx, rows, N, k, out_keys + out_off,
                            out_idx + out_off, sk, si, ld_s, stream);
    }
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
