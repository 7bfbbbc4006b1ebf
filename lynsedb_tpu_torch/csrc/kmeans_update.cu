// kmeans_update (K15b): one Lloyd update from an assignment. Per centroid:
// the sum and count of its valid rows, the new centroid (the mean, or the old
// centroid where no row is assigned) and its squared move.
//
// Replaces lynsedb_tpu/ops/kmeans.py _lloyd_step's one-hot segment sum
// (:92-98) and its epilogue (:106-109). The JAX step is deterministic and
// 100 Lloyd steps amplify any reordering, so this kernel is too: no float
// atomics; each centroid's sum is taken over its valid rows in increasing
// row order, one rounded add at a time, and its move in a fixed tree (below).
//
// Bound (tools/roofline.py kmeans_update_bound): bytes. Each valid row is read
// once (131 MB at N = 256,000, D = 128: 0.039 ms at 3.35 TB/s), every row's
// assignment and valid byte once; the N * D adds are far below the f32 rate.
//
// Design: a stable counting sort of the rows by centroid, then a walk of each
// centroid's list. Four launches:
//   count    a block a chunk of rows: a histogram of its valid rows'
//            centroids with integer atomics (order-free), in shared memory
//            (K <= 12,288) or in its own column of the device histogram,
//            written centroid-major: hist[c * chunks + chunk].
//   scan     one block: the exclusive prefix of hist in that order, in place,
//            which gives every (centroid, chunk) its base offset, and each
//            centroid the start of its list (starts[c], starts[K] = total).
//   scatter  a warp a chunk, 32 rows at a time in row order: __match_any_sync
//            groups the lanes of one centroid; a row's slot is its rank among
//            them plus the chunk's running count for that centroid (shared
//            memory), so each centroid's list holds its rows in row order.
//   sum      a warp a (centroid, slab of 32 dimensions), a centroid's slabs
//            the fastest grid index (on different SMs): the warp copies its
//            centroid's rows' slab 32 rows a stage by cp.async (16 bytes a
//            copy where D % 4 == 0 and the base is aligned, else 4) into a
//            ring of four stages in shared memory, the list's row ids loaded
//            four stages ahead, and each lane adds its dimension of the
//            landed rows in row order. The epilogue: the mean, or the old
//            centroid where the count is 0. The centroid's last slab to
//            finish (an integer counter) forms the move in a fixed tree, the
//            move tree (256 threads' fmaf sums over d = t, t + 256, ..., a
//            butterfly within each warp of 32, the eight warp sums added in
//            order), so the moves, and _lloyd's stop test, are the same bits
//            at any grid.
// The chunks are sized so the histogram holds at most 2^18 entries (one
// block scans it), with at most one chunk a 2,048 rows (a warp ranks a chunk
// 32 rows at a time) and each a multiple of 32 rows.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kSmemK = 12 * 1024;  // centroids a shared histogram holds (48 KB)
constexpr int kChunkMin = 2048;
constexpr long long kMaxHist = 1 << 18;
// the sum: a warp a slab of kSlab dimensions; its ring of kRing stages of
// kStageRows rows (16 KB); its list entries loaded kAhead stages before their
// copies are issued; kSumThreads threads in the move tree
constexpr int kSlab = 32, kStageRows = 32, kRing = 4, kAhead = 4;
constexpr int kStageFloats = kStageRows * kSlab;
static_assert(kStageRows == 32 && kSlab == 32, "a lane a row of a stage, a lane a dimension");
constexpr int kSumThreads = 256;

struct Plan {
  int chunks, chunk_rows;
};

Plan plan_of(int N, int K) {
  const long long by_rows = (N + kChunkMin - 1) / kChunkMin;
  const long long chunks = std::max(1LL, std::min(by_rows, kMaxHist / K));
  int rows = (int)((N + chunks - 1) / chunks);
  rows = (rows + 31) / 32 * 32;
  return Plan{(N + rows - 1) / rows, rows};
}

// The rows' histogram: column `chunk` of hist (K x chunks), zeroed here.
__global__ void __launch_bounds__(kCountThreads)
    count_kernel(const int* __restrict__ assign, const uint8_t* __restrict__ valid, int N, int K,
                 Plan p, int* __restrict__ hist) {
  extern __shared__ int h_smem[];
  const int chunk = blockIdx.x;
  const bool in_smem = K <= kSmemK;
  int* col = in_smem ? h_smem : hist + chunk;
  const int stride = in_smem ? 1 : p.chunks;
  for (int c = threadIdx.x; c < K; c += kCountThreads) col[(int64_t)c * stride] = 0;
  __syncthreads();
  const int r0 = chunk * p.chunk_rows, r1 = min(N, r0 + p.chunk_rows);
  for (int r = r0 + threadIdx.x; r < r1; r += kCountThreads) {
    const int a = assign[r];
    if (valid[r] && a >= 0 && a < K) atomicAdd(col + (int64_t)a * stride, 1);
  }
  if (!in_smem) return;
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += kCountThreads)
    hist[(int64_t)c * p.chunks + chunk] = h_smem[c];
}

// Exclusive prefix of the T = K * chunks counts in place, in tiles of
// kScanThreads x 4 consecutive entries (thread t the 4 from 4 t: one 16-byte
// load and store, so a warp's accesses are contiguous), each tile's loads
// issued while the last one scans: a thread's sum, a warp scan, the warps'
// totals scanned by warp 0, the tiles' totals carried. Also zeroes the sum's
// done counts.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ hist, int K, int chunks, int* __restrict__ starts,
                int* __restrict__ done) {
  constexpr int kPer = 4, kTileEntries = kScanThreads * kPer, kWarps = kScanThreads / 32;
  __shared__ int warp_off[2][kWarps + 1];  // two sets: two barriers a tile
  for (int c = threadIdx.x; c < K; c += kScanThreads) done[c] = 0;
  const int T = K * chunks;  // at most max(2^18, K) entries
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto load = [&](int base, int (&v)[kPer]) {
    const int i = base + kPer * threadIdx.x;
    if (i + kPer <= T) {
      const int4 w = *reinterpret_cast<const int4*>(hist + i);
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[e] = i + e < T ? hist[i + e] : 0;
    }
  };
  int carry = 0;
  // one tile: entries [base, base + kTileEntries) held kPer a thread in cur
  auto scan_tile = [&](int base, int tile, const int (&cur)[kPer]) {
    int sum = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) sum += cur[e];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int* off = warp_off[tile & 1];
    if (lane == 31) off[warp + 1] = incl;
    __syncthreads();
    if (warp == 0) {  // the warps' totals to exclusive offsets, off[kWarps] the tile's
      int w = lane < kWarps ? off[lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += v;
      }
      __syncwarp();
      if (lane < kWarps) off[lane + 1] = w;
      if (lane == 0) off[0] = 0;
    }
    __syncthreads();
    int run = carry + off[warp] + incl - sum;
    // the thread's first entry as (centroid, chunk), then stepped
    const int first = base + kPer * threadIdx.x;
    int c = first / chunks, chunk = first - c * chunks;
    int out[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      out[e] = run;
      if (first + e < T && chunk == 0) starts[c] = run;
      run += cur[e];
      if (++chunk == chunks) {
        chunk = 0;
        ++c;
      }
    }
    if (first + kPer <= T) {
      *reinterpret_cast<int4*>(hist + first) = make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (first + e < T) hist[first + e] = out[e];
    }
    carry += off[kWarps];
  };
  // two named buffers, each loaded a tile before it is scanned (no copy
  // between them, which would wait for the newer load)
  int even[kPer], odd[kPer];
  load(0, even);
  for (int base = 0, tile = 0; base < T; base += 2 * kTileEntries, tile += 2) {
    if (base + kTileEntries < T) load(base + kTileEntries, odd);
    scan_tile(base, tile, even);
    if (base + kTileEntries >= T) break;
    if (base + 2 * kTileEntries < T) load(base + 2 * kTileEntries, even);
    scan_tile(base + kTileEntries, tile + 1, odd);
  }
  if (threadIdx.x == 0) starts[K] = carry;
}

// A warp a chunk: each valid row's index into its centroid's list, in row
// order. The chunk's running counts start at its column of offsets. The
// assignments of the next kAhead pieces are loaded while a piece ranks.
__global__ void __launch_bounds__(32)
    scatter_kernel(const int* __restrict__ assign, const uint8_t* __restrict__ valid, int N,
                   int K, Plan p, int* __restrict__ offsets, int* __restrict__ list) {
  constexpr int kAhead = 4;
  extern __shared__ int run_smem[];
  const int chunk = blockIdx.x, lane = threadIdx.x;
  const bool in_smem = K <= kSmemK;
  int* run = in_smem ? run_smem : offsets + chunk;
  const int stride = in_smem ? 1 : p.chunks;
  if (in_smem) {
#pragma unroll 8
    for (int c = lane; c < K; c += 32) run_smem[c] = offsets[(int64_t)c * p.chunks + chunk];
    __syncwarp();
  }
  const int r0 = chunk * p.chunk_rows, r1 = min(N, r0 + p.chunk_rows);
  auto centroid = [&](int r) {
    if (r >= r1) return -1;
    const int a = assign[r];
    return (valid[r] && a >= 0 && a < K) ? a : -1;
  };
  // ahead[i]: piece p = i (mod kAhead), read and refilled in place (the
  // loop unrolled by kAhead, so no register rotation waits on a load)
  int ahead[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ahead[i] = centroid(r0 + 32 * i + lane);
  for (int base0 = r0; base0 < r1; base0 += 32 * kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int base = base0 + 32 * i;
      if (base >= r1) break;
      const int a = ahead[i];
      ahead[i] = centroid(base + 32 * kAhead + lane);
      const unsigned peers = __match_any_sync(0xffffffffu, a);
      const int leader = __ffs(peers) - 1;
      int slot = 0;
      if (a >= 0 && lane == leader) {
        slot = run[(int64_t)a * stride];
        run[(int64_t)a * stride] = slot + __popc(peers);
      }
      slot = __shfl_sync(0xffffffffu, slot, leader);
      if (a >= 0) list[slot + __popc(peers & ((1u << lane) - 1))] = base + lane;
      __syncwarp();  // the leaders' counts are read by the next piece's leaders
    }
  }
}

// A block (one warp) a (centroid, slab of kSlab dimensions), the slabs of a
// centroid the fastest grid index so they land on different SMs: the warp
// walks the centroid's list through its ring of kRing stages of kStageRows
// rows, copied by cp.async (16 bytes a copy where kVec, else 4), a lane
// adding its dimension of each landed row in row order; then the slab's
// sums and new centroid. The centroid's last slab to finish (a counter in
// `done`, zeroed by the scan) forms the move in the move tree.
template <bool kVec>
__global__ void __launch_bounds__(32)
    sum_kernel(const float* __restrict__ x, const float* __restrict__ old_c, int D, int slabs,
               const int* __restrict__ starts, const int* __restrict__ list,
               float* __restrict__ sums, float* __restrict__ counts, float* new_c,
               float* __restrict__ moves, int* __restrict__ done) {
  extern __shared__ __align__(16) float ring[];
  const int c = blockIdx.x / slabs, slab = blockIdx.x % slabs, lane = threadIdx.x;
  const int d0 = slab * kSlab;
  const int begin = starts[c], end = starts[c + 1];
  const float cnt = (float)(end - begin);
  const float denom = cnt > 1.f ? cnt : 1.f;
  const int stages = (end - begin + kStageRows - 1) / kStageRows;
  // this lane's row of stage t (0 past the list)
  auto entry = [&](int t) {
    const int i = begin + kStageRows * t + lane;
    return i < end ? __ldg(list + i) : 0;
  };
  // stage t into its ring slot, zeros past the list and past D
  auto issue = [&](int t, int row_of_lane) {
    float* dst = ring + (t % kRing) * kStageFloats;
    const int rows = end - begin - kStageRows * t;
    if constexpr (kVec) {
      constexpr int kPieces = kSlab / 4;  // 16-byte copies a row
#pragma unroll
      for (int i = 0; i < kStageRows * kPieces / 32; ++i) {
        const int r = lane / kPieces + i * (32 / kPieces), col = 4 * (lane % kPieces);
        const int row = __shfl_sync(0xffffffffu, row_of_lane, r);
        const bool ok = r < rows && d0 + col < D;
        lt::cp_async16(dst + r * kSlab + col, ok ? x + (int64_t)row * D + d0 + col : x,
                       ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < kStageRows; ++r) {
        const int row = __shfl_sync(0xffffffffu, row_of_lane, r);
        const bool ok = r < rows && d0 + lane < D;
        lt::cp_async4(dst + r * kSlab + lane, ok ? x + (int64_t)row * D + d0 + lane : x,
                      ok ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < stages) issue(t, entry(t));
    lt::cp_async_commit();
  }
  // ahead[i]: the rows of the next stage t = i (mod kAhead) issues. The loop
  // is unrolled by kAhead so each slot is read and refilled in place: a
  // register rotation would wait for the newest load at every stage.
  int ahead[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ahead[i] = entry(kRing - 1 + i);
  float acc = 0.f;
  for (int t0 = 0; t0 < stages; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t >= stages) break;
      lt::cp_async_wait<kRing - 2>();
      __syncwarp();  // stage t landed; every lane is done with stage t - 1's slot
      if (t + kRing - 1 < stages) issue(t + kRing - 1, ahead[i]);
      lt::cp_async_commit();
      ahead[i] = entry(t + kRing - 1 + kAhead);
      // this lane's dimension of the stage's rows, added in row order; a
      // whole stage's reads are issued before its adds
      const float* st = ring + (t % kRing) * kStageFloats + lane;
      const int n = min(kStageRows, end - begin - kStageRows * t);
      if (n == kStageRows) {
        float v[kStageRows];
#pragma unroll
        for (int r = 0; r < kStageRows; ++r) v[r] = st[r * kSlab];
#pragma unroll
        for (int r = 0; r < kStageRows; ++r) acc += v[r];
      } else {
        for (int r = 0; r < n; ++r) acc += st[r * kSlab];
      }
    }
  }
  lt::cp_async_wait<0>();
  const int d = d0 + lane;
  if (d < D) {
    const int64_t at = (int64_t)c * D + d;
    const float old = old_c[at];
    sums[at] = acc;
    new_c[at] = cnt > 0.f ? acc / denom : old;
  }
  __threadfence();  // this slab's new centroid, before the count says so
  int last = 0;
  if (lane == 0) last = atomicAdd(done + c, 1) == slabs - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  // the move: virtual thread t = 32 vw + lane of the move tree's 256 sums over
  // d = t, t + 256, ..., each virtual warp's butterfly, the eight in order
  float total = 0.f;
  for (int vw = 0; vw < kSumThreads / 32; ++vw) {
    float mv = 0.f;
    for (int e = 32 * vw + lane; e < D; e += kSumThreads) {
      const int64_t at = (int64_t)c * D + e;
      const float diff = __ldcg(new_c + at) - old_c[at];  // other slabs' too: past L1
      mv = fmaf(diff, diff, mv);
    }
    total += lt::warp_sum(mv);
  }
  if (lane == 0) {
    moves[c] = total;
    counts[c] = cnt;
  }
}

}  // namespace

extern "C" {

// Bytes of device scratch lt_kmeans_update needs for N rows and K centroids
// (-1: refused): the histogram, the list starts, the slabs' done counts and
// the row lists.
long long lt_kmeans_update_scratch(int N, int K) {
  if (N < 1 || K < 1) return -1;
  const Plan p = plan_of(N, K);
  return ((long long)K * p.chunks + 2LL * K + 1 + N) * (long long)sizeof(int);
}

// x (N, D) f32, assign (N,) int32 centroid ids, valid (N,) uint8, old_c
// (K, D) f32 -> sums (K, D), counts (K,), new_c (K, D), moves (K,) f32
// (moves[c] = |new_c[c] - old_c[c]|^2); scratch: lt_kmeans_update_scratch
// bytes. Rows whose assignment lies outside [0, K) count nowhere.
int lt_kmeans_update(const float* x, const int* assign, const uint8_t* valid, const float* old_c,
                     int N, int K, int D, float* sums, float* counts, float* new_c, float* moves,
                     void* scratch, cudaStream_t stream) {
  if (N < 1 || K < 1 || D < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(N, K);
  int* hist = static_cast<int*>(scratch);
  int* starts = hist + (int64_t)K * p.chunks;
  int* done = starts + K + 1;
  int* list = done + K;
  const size_t smem = K <= kSmemK ? (size_t)K * sizeof(int) : 0;
  count_kernel<<<p.chunks, kCountThreads, smem, stream>>>(assign, valid, N, K, p, hist);
  scan_kernel<<<1, kScanThreads, 0, stream>>>(hist, K, p.chunks, starts, done);
  scatter_kernel<<<p.chunks, 32, smem, stream>>>(assign, valid, N, K, p, hist, list);
  const int slabs = (D + kSlab - 1) / kSlab;
  if ((int64_t)K * slabs > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)kRing * kStageFloats * sizeof(float);
  if (D % 4 == 0 && lt::aligned16(x)) {
    sum_kernel<true><<<K * slabs, 32, ring, stream>>>(x, old_c, D, slabs, starts, list, sums,
                                                      counts, new_c, moves, done);
  } else {
    sum_kernel<false><<<K * slabs, 32, ring, stream>>>(x, old_c, D, slabs, starts, list, sums,
                                                       counts, new_c, moves, done);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
