// K11: bf16 scores of gathered rows. Scores the bf16-rounded centred query
// against rows gathered from the mean-centred bf16 corpus copy, accumulating
// in f32, and restores each metric with K2's per-row rank-1 corrections; K5
// then takes the top C that K3 rescores exactly in f32.
//
// Replaces the gather and rescore of lynsedb_tpu/ops/scan.py
// shortlist_device_rescore_ids (:416; rows = take(x16, cand), the einsum and
// the epilogue at :443-458) and the first pass of the gather route,
// bf16_gather_pass_ids (:385):
//   IP      ip_c + xm
//   L2      max(qc_sq + xc_sq - 2 ip_c, 0), qc_sq from the f32 centred query
//   cosine  1 - (ip_c + xm + q.m) / sqrt(q_sq * xsq_true), 1.0 below 1e-30
// then the orientation; an empty slot (a negative id, or a slot key of -inf)
// and a NaN score give -inf.
//
// The index list has a batch stride, and the route follows it:
//   idx_stride = S  one list a query (a quantized index's shortlist): the
//                   rows differ by query, so nothing is shared. One block per
//                   (query, 64 slots); a warp takes one slot at a time, its
//                   lanes read the row with 16-byte loads (8 bf16) where D is
//                   a multiple of 8, dot them with the query held in f32 in
//                   shared memory, and reduce by shuffles.
//   idx_stride = 0  one list shared by every query (the gather route of a
//                   selective filter, K4): K2's tensor-core tile over
//                   gathered rows. A block takes 128 slots x a group of up
//                   to 32 queries, reads the tile's row ids once into shared
//                   memory, and fills a 3-deep cp.async ring of 64-dimension
//                   stages, each 16-byte copy taking its source row from the
//                   id (an empty slot zero-filled; a D that is not a multiple
//                   of 8, or an unaligned base, takes scalar loads); 8 warps
//                   of 16 rows run mma.sync m16n8k16 (mma_bf16.cuh), rows on
//                   M and queries on N, so B = 1 pads to 8 queries, not 128.
//                   The epilogue writes the keys through a shared score tile
//                   (the ring's memory), so the (B, S) stores coalesce. Query
//                   groups are the fastest grid index, so the groups that
//                   share a row tile re-read it from L2.
//
// lt_bf16_gather_topc fuses the per-query mode with the top C that K5 took
// after it: a quantized search's second stage after its top S (the gather,
// the einsum, the epilogue and masked_top_k of shortlist_device_rescore_ids,
// lynsedb_tpu/ops/scan.py:442-461) in one launch
// of a thread block cluster a query (1, 2, 4 or 8 blocks over disjoint slot
// ranges), the query's terms formed in the block, the slots listed once,
// each row streamed through its warp's cp.async ring and scored in the
// per-query mode's sum order, each block's best C ranked by count in shared
// memory, the leader merging the blocks' lists through distributed shared
// memory. The (B, S) keys never reach device memory. Under IP its keys and
// rows are the two-launch chain's bit for bit but for the sign of an exact
// zero (a 16-lane butterfly at D <= 128 skips the xor-16 step that adds the
// other half-warp's zeros).
//
// Bound: bytes, the gathered rows (2 * D bytes each, 256 B at D = 128) plus
// their aux word, the ids and slot keys read and the (B, S) keys written; the
// 2 * B * S * D flops take the tensor cores a fraction of that in the shared
// mode. The gathers are random 256-byte reads.
#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 64;  // shortlist slots a block (per-query mode)
constexpr int kTM = lt::kMmaRows;  // slots a tile (shared mode)
constexpr int kKC = lt::kMmaDims;
constexpr int kStride = lt::kMmaStride;
constexpr int kStages = lt::kMmaStages;
constexpr int kMaxQN = 32;         // queries a block (4 n-tiles of 8)
constexpr int kSRow = kTM + 4;     // floats a query of the score tile

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

// acc plus the dot product of 8 bf16 values (dimensions 8 v to 8 v + 7 of a
// row, one 16-byte word) with the query's f32 values there, one fmaf a
// dimension in order: the per-query mode's and the fused stage's sum.
__device__ __forceinline__ float dot8(const uint4 w, const float* qs, int v, float acc) {
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
  return acc;
}

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
        for (int v = lane; v < D / 8; v += 32)
          acc = dot8(__ldg(reinterpret_cast<const uint4*>(xr) + v), qs, v, acc);
      } else {
        for (int d = lane; d < D; d += 32) acc = fmaf(__bfloat162float(xr[d]), qs[d], acc);
      }
      acc = lt::warp_sum(acc);
      key = epi(b, n, acc);
    }
    if (lane == 0) keys[(int64_t)b * S + s] = key;
  }
}

struct SharedArgs {
  const __nv_bfloat16* q;  // (B, D) bf16(q - m)
  const __nv_bfloat16* x;  // (N, D) centred bf16 corpus
  const int* idx;          // (S,) row ids, negative = empty
  const float* slot_keys;  // (S,) or null, -inf = empty
  int B, S, D;
  bool vec;
  int groups, ql;
  GatherEpilogue epi;
  float* keys;             // (B, S)
};

// Stage `chunk` (dimensions from chunk * kKC) of the tile's gathered rows and
// the group's queries into dst: rows first, then queries, kStride bf16 each;
// zeros for an empty slot, past D and past the group.
template <int QN>
__device__ __forceinline__ void load_gathered(const SharedArgs& a, const int* ids,
                                              __nv_bfloat16* dst, int chunk, int q0, int nq) {
  const int k0 = chunk * kKC;
  if (a.vec) {
    constexpr int kChunks = kKC / 8;  // 16-byte copies a row
    for (int c = threadIdx.x; c < (kTM + QN) * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, d = k0 + col;
      const __nv_bfloat16* src = a.x;
      bool ok;
      if (r < kTM) {
        const int n = ids[r];
        ok = n >= 0 && d < a.D;
        if (ok) src = a.x + (int64_t)n * a.D + d;
      } else {
        ok = r - kTM < nq && d < a.D;
        if (ok) src = a.q + (int64_t)(q0 + r - kTM) * a.D + d;
      }
      lt::cp_async16(dst + r * kStride + col, src, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < (kTM + QN) * kKC; e += kThreads) {
      const int r = e / kKC, col = e % kKC, d = k0 + col;
      __nv_bfloat16 v = zero;
      if (r < kTM) {
        const int n = ids[r];
        if (n >= 0 && d < a.D) v = a.x[(int64_t)n * a.D + d];
      } else if (r - kTM < nq && d < a.D) {
        v = a.q[(int64_t)(q0 + r - kTM) * a.D + d];
      }
      dst[r * kStride + col] = v;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) shared_list_kernel(const SharedArgs a) {
  constexpr int QN = 8 * NT;
  constexpr int kStageElems = (kTM + QN) * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* score = reinterpret_cast<float*>(smem);  // QN x kSRow, after the last stage
  __shared__ int ids[kTM];
  const int group = blockIdx.x % a.groups, tile = blockIdx.x / a.groups;
  const int q0 = group * a.ql, nq = min(a.ql, a.B - q0);
  const int s0 = tile * kTM;
  for (int r = threadIdx.x; r < kTM; r += kThreads) {
    const int s = s0 + r;
    int n = -1;
    if (s < a.S) {
      n = a.idx[s];
      if (a.slot_keys && !(a.slot_keys[s] > -INFINITY)) n = -1;
    }
    ids[r] = n < 0 ? -1 : n;
  }
  __syncthreads();
  const int kchunks = (a.D + kKC - 1) / kKC;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < kchunks) load_gathered<QN>(a, ids, ring + c * kStageElems, c, q0, nq);
    lt::cp_async_commit();
  }
  float acc[NT][4] = {};
  for (int c = 0; c < kchunks; ++c) {
    lt::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage c has landed; every warp is done with stage c - 1
    const int next = c + kStages - 1;
    if (next < kchunks)
      load_gathered<QN>(a, ids, ring + (next % kStages) * kStageElems, next, q0, nq);
    lt::cp_async_commit();
    lt::mma_stage<NT>(ring + (c % kStages) * kStageElems, acc);
  }
  lt::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the score tile now
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    const int n = ids[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * (lane & 3) + e;
        score[j * kSRow + r] =
            n >= 0 && j < nq ? a.epi(q0 + j, n, acc[nt][2 * h + e]) : -INFINITY;
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * kTM; e += kThreads) {
    const int j = e / kTM, r = e % kTM;
    if (s0 + r < a.S) a.keys[(int64_t)(q0 + j) * a.S + s0 + r] = score[j * kSRow + r];
  }
}

template <int NT>
int launch_shared(const SharedArgs& a, int tiles, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * (kTM + 8 * NT) * kStride * sizeof(__nv_bfloat16);
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(shared_list_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    raised = true;
  }
  shared_list_kernel<NT><<<(unsigned)(a.groups * tiles), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ── The fused second stage: K11's per-query keys and their top C ─────────

constexpr int kTopcThreads = 512;                      // 16 warps: latency hidden by warps
constexpr int kTopcWarps = kTopcThreads / 32;
constexpr int kTopcChunk = 1024;                       // slots a block lists at a time
constexpr int kTopcRounds = kTopcChunk / kTopcThreads;  // a thread's slots a chunk
constexpr int kTopcStages = 4;                         // depth of a warp's cp.async ring
constexpr int kTopcRows = 2;                           // rows a lane group scores at once
// dynamic shared memory a block may take: 227 KiB less 1 KiB for the static
// arrays (ops/scan.py TOPC_SMEM_BYTES plans the ring by the same sum)
constexpr size_t kTopcSmemMax = 227 * 1024 - 1024;
static_assert((kTopcRounds * kTopcWarps + kTopcWarps + 8 + 3) * 4 <= 1024,
              "gather_topc_kernel's static arrays outgrow the 1 KiB kept for them");

struct TopcArgs {
  const float* q;           // (B, D) f32 queries
  const float* mean;        // (D,) the corpus mean
  const __nv_bfloat16* x;   // (N, D) centred bf16 corpus
  const float* xm;          // (N,) per-row terms, as GatherEpilogue's
  const float* xc_sq;
  const float* xsq_true;
  const float* top;         // (B, S) K5's slot keys, -inf = empty
  const int* cand;          // (B, S) K5's row ids, negative = empty
  int S, D, C, kp;          // C outputs a query (<= S, <= 256), kp = list_kp(C)
  int cs;                   // blocks a query: the cluster's size
  int rw;                   // rows a stage of a warp's ring; 0: the direct route
  int metric;
  bool ascending;
  float* keys;              // (B, C) out
  int* ids;                 // (B, C) out
};

// A slot's key from its row's centred dot product and the row's aux words
// (a0: xm, or xc_sq under L2; a1: xsq_true under cosine), with
// GatherEpilogue's operations in its order.
__device__ __forceinline__ float topc_key(const TopcArgs& a, float ip_c, float a0, float a1,
                                          float qc_sq, float qm, float q_sq) {
  float s;
  if (a.metric == lt::kIP) {
    s = ip_c + a0;
  } else if (a.metric == lt::kL2) {
    s = lt::clamp_nonneg(qc_sq + a0 - 2.f * ip_c);
  } else {
    s = lt::cosine_distance(ip_c + a0 + qm, sqrtf(q_sq * a1));
  }
  return lt::to_key(s, a.ascending, true);
}

// The entry of a listed slot: its key over the slot index (the order of
// K5's select: the bigger key, then the lower slot), 0 for a -inf key (it
// never ranks).
__device__ __forceinline__ uint64_t topc_entry(float key, int slot) {
  return key > -INFINITY ? lt::pack_entry(key, slot) : 0;
}

// The ring route (D a multiple of 8, 16-byte rows): the warp streams its
// listed rows [p0, p1) through its own ring of kTopcStages stages of rw rows
// (16-byte cp.async copies; each row's aux words beside it, 4 bytes each),
// G lanes a row, kTopcRows rows a group at once: lane t sums the 16-byte
// words t, t + 32, ... of each row (dot8), then a butterfly over the group's
// G lanes. G = 16 serves D <= 128 (lane t's word t alone: the per-query
// mode's warp sum but for its first step, which adds the other half-warp's
// zeros), G = 32 the rest. Each row's entry goes to ent[p]; returns the
// live entries the lane wrote.
template <int G>
__device__ __forceinline__ int topc_ring_part(const TopcArgs& a, const float* qs,
                                              const int2* live, int p0, int p1,
                                              unsigned char* ring, float* ring_aux,
                                              uint64_t* ent, float qc_sq, float qm, float q_sq) {
  const int lane = threadIdx.x & 31;
  const int rb = 2 * a.D, words = a.D / 8, rw = a.rw;
  const int naux = a.metric == lt::kCosine ? 2 : 1;
  const float* aux0 = a.metric == lt::kL2 ? a.xc_sq : a.xm;
  const char* xb = reinterpret_cast<const char*>(a.x);
  const int stages = (p1 - p0 + rw - 1) / rw;
  auto issue = [&](int st) {
    if (st < stages) {
      unsigned char* buf = ring + (st % kTopcStages) * rw * rb;
      float* abuf = ring_aux + (st % kTopcStages) * rw * 2;
      const int r0 = p0 + st * rw, nr = min(rw, p1 - r0);
      int r = lane / words, col = lane - r * words;  // copy c = lane + 32 i: row r, word col
      for (int c = lane; c < nr * words; c += 32) {
        lt::cp_async16(buf + r * rb + col * 16, xb + (int64_t)live[r0 + r].y * rb + col * 16, 16);
        col += 32;
        if (col >= words) {
          const int up = col / words;
          r += up;
          col -= up * words;
        }
      }
      for (int c = lane; c < nr * naux; c += 32) {
        const int r = c / naux, w = c - r * naux;
        lt::cp_async4(abuf + r * 2 + w, (w ? a.xsq_true : aux0) + live[r0 + r].y, 4);
      }
    }
    lt::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kTopcStages - 1; ++st) issue(st);
  constexpr int kGroups = 32 / G;
  const int g = lane / G, t = lane % G;
  int written = 0;
  for (int st = 0; st < stages; ++st) {
    lt::cp_async_wait<kTopcStages - 2>();
    __syncwarp();  // stage st has landed; every lane is done with stage st - 1
    issue(st + kTopcStages - 1);
    const unsigned char* buf = ring + (st % kTopcStages) * rw * rb;
    const float* abuf = ring_aux + (st % kTopcStages) * rw * 2;
    const int r0 = p0 + st * rw, nr = min(rw, p1 - r0);
    for (int rr = 0; rr < nr; rr += kGroups * kTopcRows) {  // the same count on every lane
      int r[kTopcRows];
      float acc[kTopcRows];
#pragma unroll
      for (int j = 0; j < kTopcRows; ++j) {
        r[j] = min(rr + j * kGroups + g, nr - 1);  // past the stage's rows: its last again
        acc[j] = 0.f;
      }
      for (int v = t; v < words; v += 32) {
        uint4 w[kTopcRows];
#pragma unroll
        for (int j = 0; j < kTopcRows; ++j)
          w[j] = reinterpret_cast<const uint4*>(buf + r[j] * rb)[v];
#pragma unroll
        for (int j = 0; j < kTopcRows; ++j) acc[j] = dot8(w[j], qs, v, acc[j]);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < kTopcRows; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      // every lane of a group holds each row's sum: lane t keys row j = t
      if (t < kTopcRows && rr + t * kGroups + g < nr) {
        float mine = acc[0];
        int row = r[0];
#pragma unroll
        for (int j = 1; j < kTopcRows; ++j)
          if (t == j) {
            mine = acc[j];
            row = r[j];
          }
        const uint64_t e = topc_entry(
            topc_key(a, mine, abuf[row * 2], abuf[row * 2 + 1], qc_sq, qm, q_sq),
            live[r0 + row].x);
        ent[r0 + row] = e;
        written += e != 0;
      }
    }
  }
  lt::cp_async_wait<0>();
  __syncwarp();
  return written;
}

// The direct route (D not a multiple of 8, an unaligned corpus, or rows too
// wide for the ring): a warp a row, each lane's loads straight from device
// memory in the per-query mode's order (16-byte words when D is a multiple
// of 8, else d = lane, lane + 32, ...), then the warp sum.
__device__ __forceinline__ int topc_direct_part(const TopcArgs& a, const float* qs,
                                                const int2* live, int p0, int p1, uint64_t* ent,
                                                float qc_sq, float qm, float q_sq) {
  const int lane = threadIdx.x & 31;
  const float* aux0 = a.metric == lt::kL2 ? a.xc_sq : a.xm;
  int written = 0;
  for (int p = p0; p < p1; ++p) {
    const int2 sl = live[p];
    const __nv_bfloat16* xr = a.x + (int64_t)sl.y * a.D;
    float acc = 0.f;
    if ((a.D & 7) == 0) {
      for (int v = lane; v < a.D / 8; v += 32)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = fmaf(__bfloat162float(xr[8 * v + j]), qs[8 * v + j], acc);
    } else {
      for (int d = lane; d < a.D; d += 32) acc = fmaf(__bfloat162float(xr[d]), qs[d], acc);
    }
    acc = lt::warp_sum(acc);
    if (lane == 0) {
      const uint64_t e = topc_entry(
          topc_key(a, acc, aux0[sl.y], a.metric == lt::kCosine ? a.xsq_true[sl.y] : 0.f, qc_sq,
                   qm, q_sq),
          sl.x);
      ent[p] = e;
      written += e != 0;
    }
  }
  return written;
}

// The count of a sorted list's first n entries (the largest first) above e.
__device__ __forceinline__ int topc_above(const uint64_t* list, int n, uint64_t e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] > e) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The best C of the block's running list (best: kept entries, sorted, the
// largest first) and a chunk's entries (ent: nl, 0 for none), placed by
// count into next (padded beforehand): an entry's rank is the entries above
// it, in best by a binary search and in the chunk by a scan of 8 at a time
// that ends once the rank reaches C (K5's top S lists the slots in the
// first pass's order, so most entries meet C better ones early). Entries are
// distinct (a slot each), so the ranks are too.
__device__ __forceinline__ void topc_rank(const uint64_t* best, int kept, const uint64_t* ent,
                                          int nl, uint64_t* next, int C) {
  for (int i = threadIdx.x; i < kept + nl; i += kTopcThreads) {
    const bool old = i < kept;
    const uint64_t e = old ? best[i] : ent[i - kept];
    if (e == 0) continue;
    int rank = i;
    if (!old) rank = topc_above(best, kept, e);
    for (int j0 = 0; j0 < nl && rank < C; j0 += 8) {
      uint64_t o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = j0 + k < nl ? ent[j0 + k] : 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) rank += o[k] > e;
    }
    if (rank < C) next[rank] = e;
  }
}

// A thread's slots of a chunk (slot c0 + round * kTopcThreads + thread), read
// once, coalesced; each warp's count of live slots a round into wcount.
struct TopcSlots {
  int n[kTopcRounds];  // the row id, -1 where the slot is empty
};

__device__ __forceinline__ void topc_read_slots(const TopcArgs& a, int64_t row0, int c0, int c1,
                                                TopcSlots& sl, int* wcount) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTopcRounds; ++k) {
    const int s = c0 + k * kTopcThreads + threadIdx.x;
    int n = -1;
    float key = -INFINITY;
    if (s < c1) {
      n = a.cand[row0 + s];
      key = a.top[row0 + s];
    }
    sl.n[k] = n >= 0 && key > -INFINITY ? n : -1;
    const unsigned mask = __ballot_sync(0xffffffffu, sl.n[k] >= 0);
    if ((threadIdx.x & 31) == 0) wcount[k * kTopcWarps + warp] = __popc(mask);
  }
}

// Lists the live slots in slot order (live[p] = (slot, row)): a thread's
// place is the live slots of the rounds and warps before its own, then of
// its warp's lanes before it. Returns the count. wcount holds every warp's
// counts (a barrier after topc_read_slots).
__device__ __forceinline__ int topc_list_slots(int c0, const TopcSlots& sl, const int* wcount,
                                               int2* live) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int total = 0;
  for (int i = 0; i < kTopcRounds * kTopcWarps; ++i) total += wcount[i];
#pragma unroll
  for (int k = 0; k < kTopcRounds; ++k) {
    int before = 0;
    for (int i = 0; i < k * kTopcWarps + warp; ++i) before += wcount[i];
    const unsigned mask = __ballot_sync(0xffffffffu, sl.n[k] >= 0);
    if (sl.n[k] >= 0)
      live[before + __popc(mask & ((1u << lane) - 1))] =
          make_int2(c0 + k * kTopcThreads + threadIdx.x, sl.n[k]);
  }
  return total;
}

// One cluster of cs blocks a query; block `rank` takes slots [rank * per,
// (rank + 1) * per) of the query's S, kTopcChunk at a time: its threads read
// the chunk's slot keys and ids once, coalesced, and list the live slots (a
// non-negative id and a key above -inf) in slot order; its 8 warps split
// the list and score their rows (ring or direct route) into the chunk's
// entries in shared memory; then every thread ranks entries against the
// block's running best C (topc_rank). The leader (rank 0) copies the other
// blocks' lists through distributed shared memory and places each entry of
// them by rank (its place in its own list and its count above in the
// others, by binary searches), writing the query's C keys and row ids (-inf
// / -1 past the live ones).
template <int G>
__global__ void __launch_bounds__(kTopcThreads) gather_topc_kernel(const TopcArgs a) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wcount[kTopcRounds * kTopcWarps], s_wvalid[kTopcWarps], s_kept[8];
  __shared__ float s_terms[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / a.cs;
  const int kp = a.kp;
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem);  // 8 lists of kp: the cluster's merge
  uint64_t* next = lists + 8 * kp;
  uint64_t* ent = next + kp;
  float* qs = reinterpret_cast<float*>(ent + kTopcChunk);
  int2* live = reinterpret_cast<int2*>(qs + ((a.D + 3) & ~3));
  unsigned char* ring_base = reinterpret_cast<unsigned char*>(live + kTopcChunk);
  const size_t ring_warp = (size_t)kTopcStages * a.rw * 2 * a.D;
  unsigned char* ring = ring_base + warp * ring_warp;
  float* ring_aux = reinterpret_cast<float*>(ring_base + kTopcWarps * ring_warp) +
                    warp * kTopcStages * a.rw * 2;

  const int per = (a.S + a.cs - 1) / a.cs;
  const int lo = min(a.S, rank * per), hi = min(a.S, lo + per);
  const int64_t row0 = (int64_t)b * a.S;
  TopcSlots sl;
  topc_read_slots(a, row0, lo, min(hi, lo + kTopcChunk), sl, s_wcount);  // in flight with the query
  // the query: bf16(q - m) upcast (K11's operand), and the metric's terms
  // |q - m|^2, q . m, |q|^2 from the f32 values
  const float* qb = a.q + (int64_t)b * a.D;
  for (int d = threadIdx.x; d < a.D; d += kTopcThreads)
    qs[d] = __bfloat162float(__float2bfloat16(qb[d] - a.mean[d]));
  if (warp == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < a.D; d += 32) {
      const float qv = qb[d], mv = a.mean[d], c = qv - mv;
      s0 = fmaf(c, c, s0);
      s1 = fmaf(qv, mv, s1);
      s2 = fmaf(qv, qv, s2);
    }
    s0 = lt::warp_sum(s0);
    s1 = lt::warp_sum(s1);
    s2 = lt::warp_sum(s2);
    if (lane == 0) {
      s_terms[0] = s0;
      s_terms[1] = s1;
      s_terms[2] = s2;
    }
  }
  uint64_t* best = lists;  // the block's running best C
  for (int e = threadIdx.x; e < kp; e += kTopcThreads) best[e] = lt::kPadEntry;
  __syncthreads();
  const float qc_sq = s_terms[0], qm = s_terms[1], q_sq = s_terms[2];
  int kept = 0;
  for (int c0 = lo; c0 < hi; c0 += kTopcChunk) {
    const int nl = topc_list_slots(c0, sl, s_wcount, live);
    for (int e = threadIdx.x; e < kp; e += kTopcThreads) next[e] = lt::kPadEntry;
    __syncthreads();  // the list is whole
    const int p0 = nl * warp / kTopcWarps, p1 = nl * (warp + 1) / kTopcWarps;
    int written;
    if constexpr (G > 0) {
      written = topc_ring_part<G>(a, qs, live, p0, p1, ring, ring_aux, ent, qc_sq, qm, q_sq);
    } else {
      written = topc_direct_part(a, qs, live, p0, p1, ent, qc_sq, qm, q_sq);
    }
    written = __reduce_add_sync(0xffffffffu, written);
    if (lane == 0) s_wvalid[warp] = written;
    __syncthreads();  // the chunk's entries are in
    int valid = 0;
    for (int w = 0; w < kTopcWarps; ++w) valid += s_wvalid[w];
    topc_rank(best, kept, ent, nl, next, a.C);
    kept = min(a.C, kept + valid);
    if (c0 + kTopcChunk < hi)  // the next chunk's slots, in flight with the barrier
      topc_read_slots(a, row0, c0 + kTopcChunk, min(hi, c0 + 2 * kTopcChunk), sl, s_wcount);
    __syncthreads();  // next is whole; the chunk's list and entries are free
    uint64_t* t = best;
    best = next;
    next = t;
  }
  if (best != lists) {  // the block's list to list 0, which the leader reads
    for (int e = threadIdx.x; e < kp; e += kTopcThreads) lists[e] = best[e];
    __syncthreads();
  }
  if (threadIdx.x == 0) s_kept[0] = kept;

  if (a.cs > 1) {
    cluster.sync();  // every block's best C is in its list 0
    if (rank == 0 && warp > 0 && warp < a.cs) {
      const uint64_t* remote = cluster.map_shared_rank(lists, (unsigned)warp);
      for (int e = lane; e < kp; e += 32) lists[warp * kp + e] = remote[e];
      if (lane == 0) s_kept[warp] = *cluster.map_shared_rank(s_kept, (unsigned)warp);
    }
    cluster.sync();  // the leader holds every block's list: the others may leave
    if (rank != 0) return;
  } else {
    __syncthreads();
  }
  int total = 0;
  for (int w = 0; w < a.cs; ++w) total += s_kept[w];
  for (int i = threadIdx.x; i < a.cs * kp; i += kTopcThreads) {
    const int w = i / kp, p = i - w * kp;
    if (p >= s_kept[w]) continue;
    const uint64_t e = lists[i];
    int at = p;
    for (int o = 0; o < a.cs; ++o)
      if (o != w) at += topc_above(lists + o * kp, s_kept[o], e);
    if (at < a.C) {
      a.keys[(int64_t)b * a.C + at] = lt::entry_key(e);
      a.ids[(int64_t)b * a.C + at] = a.cand[row0 + lt::entry_id(e)];
    }
  }
  for (int p = min(total, a.C) + threadIdx.x; p < a.C; p += kTopcThreads) {
    a.keys[(int64_t)b * a.C + p] = -INFINITY;
    a.ids[(int64_t)b * a.C + p] = -1;
  }
}

template <int G>
int launch_topc(const TopcArgs& a, int B, size_t smem, cudaStream_t stream) {
  static size_t raised = 0;
  if (smem > 48 * 1024 && smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_topc_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((int64_t)B * a.cs));
  cfg.blockDim = dim3(kTopcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gather_topc_kernel<G>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  if (B < 1 || S < 1 || D < 1 || (idx_stride != 0 && idx_stride != S))
    return (int)cudaErrorInvalidValue;
  const GatherEpilogue epi{qc_sq, qm, q_sq, xm, xc_sq, xsq_true, metric, ascending != 0};
  if (idx_stride == 0) {
    // groups of at most 32 queries, as even as B allows
    const int groups = (B + kMaxQN - 1) / kMaxQN, ql = (B + groups - 1) / groups;
    const int tiles = (S + kTM - 1) / kTM;
    if ((int64_t)groups * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool vec = D % 8 == 0 && lt::aligned16(qc16) && lt::aligned16(x16);
    const SharedArgs a{qc16, x16, idx, slot_keys, B, S, D, vec, groups, ql, epi, keys};
    switch ((ql + 7) / 8) {
      case 1: return launch_shared<1>(a, tiles, stream);
      case 2: return launch_shared<2>(a, tiles, stream);
      case 3: return launch_shared<3>(a, tiles, stream);
      default: return launch_shared<4>(a, tiles, stream);
    }
  }
  if (B > 65535 || (size_t)D * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kSlots - 1) / kSlots), (unsigned)B);
  bf16_gather_kernel<<<grid, kThreads, D * sizeof(float), stream>>>(qc16, x16, idx, idx_stride,
                                                                     slot_keys, S, D, epi, keys);
  return (int)cudaGetLastError();
}


// The fused second stage of a quantized search, after K5's top S: q (B, D)
// f32 queries, mean (D,), x16 (N, D) the centred bf16 corpus and its
// xm / xc_sq / xsq_true (N,), top (B, S) K5's keys and cand (B, S) its int32
// row ids -> keys (B, C) in K5's order (key descending, then slot index
// ascending) and ids (B, C) int32, -inf / -1 past the live slots. cs blocks
// a query (a cluster: 1, 2, 4 or 8); rw rows a stage of each warp's ring
// (D a multiple of 8, x16 16-byte aligned, at most 16), or 0 for the direct
// route. C <= min(S, 256). A launch the card refuses (a cluster it cannot
// place, too much shared memory) returns its error; nothing falls back.
extern "C" int lt_bf16_gather_topc(const float* q, const float* mean, const __nv_bfloat16* x16,
                                   const float* xm, const float* xc_sq, const float* xsq_true,
                                   const float* top, const int* cand, int B, int S, int D, int C,
                                   int cs, int rw, int metric, int ascending, float* keys,
                                   int* ids, cudaStream_t stream) {
  if (B < 1 || S < 1 || D < 1 || C < 1 || C > S || C > 256 || rw < 0 || rw > 16 ||
      (cs != 1 && cs != 2 && cs != 4 && cs != 8) || (int64_t)B * cs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (rw > 0 && (D % 8 != 0 || !lt::aligned16(x16))) return (int)cudaErrorInvalidValue;
  const int kp = lt::list_kp(C);
  size_t smem = (size_t)(9 * kp + kTopcChunk) * sizeof(uint64_t) +
                (size_t)((D + 3) & ~3) * sizeof(float) + (size_t)kTopcChunk * sizeof(int2);
  smem += (size_t)kTopcWarps * kTopcStages * rw * (2 * D + 2 * sizeof(float));
  if (smem > kTopcSmemMax) return (int)cudaErrorInvalidValue;
  const TopcArgs a{q, mean, x16, xm, xc_sq, xsq_true, top, cand, S, D, C, kp, cs, rw, metric,
                   ascending != 0, keys, ids};
  if (rw == 0) return launch_topc<0>(a, B, smem, stream);
  return D <= 128 ? launch_topc<16>(a, B, smem, stream) : launch_topc<32>(a, B, smem, stream);
}
