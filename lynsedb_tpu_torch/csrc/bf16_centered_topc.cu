// K2: the two-pass search's first pass, fused with its top-C selection.
// Scores a bf16-rounded centred query block against the mean-centred bf16
// corpus copy on the tensor cores (f32 accumulation), restores each metric
// with the per-row rank-1 corrections, orients and masks the key, and keeps
// each query's exact top C of every span of rows in shared memory; the
// (B, N) key matrix never reaches device memory. K5 (topk_select.cu, ids
// mode) then merges the per-span lists into the (B, C) shortlist that K3
// rescores.
//
// Replaces lynsedb_tpu/ops/scan.py _bf16_scores followed by
// lynsedb_tpu/ops/topk.py masked_top_c (inside bf16_pass_ids and
// bf16_exact_pass_packed): ip_c = bf16(q - m) . (x - m) with
// preferred_element_type=f32, then
//   IP      ip_c + xm
//   L2      max(qc_sq + xc_sq - 2 ip_c, 0)
//   cosine  1 - (ip_c + xm + q.m) / sqrt(q_sq * xsq_true), 1.0 below 1e-30
// term for term, then orientation and the mask (NaN and masked rows -inf).
// The selection is exact (approx_max_k is exact on the CPU too): key
// descending, the lower row id first between equal keys; slots nothing
// filled hold (-inf, -1).
//
// Bound: the corpus read, 2 * N * D bytes plus 5 to 13 bytes a row of aux
// and mask (261 MB at 1M x 128 under IP, 0.078 ms at 3.35 TB/s); the
// product is 2 * B * N * D flops (0.068 ms at B = 256 at the bf16 peak), so
// the pass is bound by bytes at every B <= 256 and the read must not be
// repeated.
// Design: mma.sync m16n8k16 (bf16 in, f32 accumulate), corpus rows on the M
// side and queries on the N side, so a single query pads to 8, not to 64
// (the stage and its MMAs are mma_bf16.cuh's, shared with K11's shared-list
// tile).
// A block takes a span of rows x a group of up to 32 queries (at most 8
// groups; the query group is the fastest grid index, so the groups that
// share a span re-read it from L2); 8 warps, 16 rows each, make a 128-row
// tile. Each stage of a 3-deep cp.async ring holds 64 dimensions of the
// tile's rows and of the group's queries (16-byte copies, zero-filled past
// D and past the span; a D that is not a multiple of 8, or an unaligned
// base, takes scalar loads: a route by shape); the epilogue's row terms are
// loaded a tile ahead. After a tile's last stage the epilogue applies the
// correction, orientation and mask to the accumulators and writes the
// tile's keys to a shared (queries x 128) score tile; then each warp offers
// the keys of the queries it owns (query j belongs to warp j % 8) to their
// candidate lists (common.cuh WarpTopk): an entry joins only if it beats
// the C-th best key of the span seen so far. When one list could not take
// another tile, every warp merges its lists' pending entries at that
// barrier, so the warps' merges overlap. Rows are visited in
// ascending id order, so that test is a strict `key > threshold`: a later
// row equal to the C-th key loses the tie to it.
// Spans are sized from B so the grid is one wave of the blocks the card
// holds at once, and spans x C stays at most an eighth of N. A list takes
// 8 * (next_pow2(C) + 256) bytes; where a group's lists do not fit in shared
// memory even at one query, they live in a device scratch buffer (a route
// by C).
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = lt::kMmaThreads;
constexpr int kTM = lt::kMmaRows;       // corpus rows a tile: 16 a warp
constexpr int kKC = lt::kMmaDims;       // dimensions a stage
constexpr int kStride = lt::kMmaStride;
constexpr int kStages = lt::kMmaStages;
constexpr int kMaxQN = 32;            // queries a block (4 n-tiles of 8)
constexpr int kSRow = kTM + 4;        // floats a query of the score tile (stores without conflicts)
constexpr int kSmemLimit = 225 * 1024;  // dynamic, below the 227 KB a block may use
constexpr int kPend = lt::WarpTopk::kPend;

struct Args {
  const __nv_bfloat16* q;  // (B, D) bf16(q - m)
  const __nv_bfloat16* x;  // (N, D) centred bf16 corpus
  const float* qc_sq;      // (B,) |q - m|^2 from the f32 centred query
  const float* qm;         // (B,) q . m
  const float* q_sq;       // (B,) |q|^2
  const float* xm;         // (N,) m . (x - m) of the rounded rows
  const float* xc_sq;      // (N,) |x - m|^2 of the rounded rows
  const float* xsq_true;   // (N,) |x|^2 of the f32 rows
  const uint8_t* valid;    // (N,) 1 = live row
  int B, N, D, C, metric;
  bool ascending, vec;
  int groups, ql, span_rows, kp;
  uint64_t* lists;         // device lists (null: shared memory)
  float* out_keys;         // (B, spans * C)
  int* out_idx;
};

// Stage `step` (tile step / kchunks, dimensions from (step % kchunks) * kKC)
// of the tile's rows and the group's queries into `dst`: rows first, then
// queries, kStride bf16 each; zeros past D, past the span and past the group.
template <int QN>
__device__ __forceinline__ void load_stage(const Args& a, __nv_bfloat16* dst, int step,
                                           int kchunks, int64_t row0, int64_t row_end, int q0,
                                           int nq) {
  const int64_t r0 = row0 + (int64_t)(step / kchunks) * kTM;
  const int k0 = (step % kchunks) * kKC;
  if (a.vec) {
    constexpr int kChunks = kKC / 8;  // 16-byte copies a row
    for (int c = threadIdx.x; c < (kTM + QN) * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, d = k0 + col;
      const __nv_bfloat16* src = a.x;
      bool ok;
      if (r < kTM) {
        ok = r0 + r < row_end && d < a.D;
        if (ok) src = a.x + (r0 + r) * a.D + d;
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
        if (r0 + r < row_end && d < a.D) v = a.x[(r0 + r) * a.D + d];
      } else if (r - kTM < nq && d < a.D) {
        v = a.q[(int64_t)(q0 + r - kTM) * a.D + d];
      }
      dst[r * kStride + col] = v;
    }
  }
}

// The epilogue's per-row terms of this thread's two rows of a tile (rows
// r and r + 8 of the warp's 16), loaded a tile ahead of their use.
struct RowTerms {
  float xm[2], xc_sq[2], xsq_true[2];
  bool live[2];
};

__device__ __forceinline__ RowTerms load_terms(const Args& a, int64_t tile_row, int64_t row_end) {
  RowTerms t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = tile_row + warp * 16 + (lane >> 2) + 8 * h;
    const bool in = row < row_end;
    t.live[h] = in && a.valid[row];
    t.xm[h] = in && a.metric != lt::kL2 ? __ldg(a.xm + row) : 0.f;
    t.xc_sq[h] = in && a.metric == lt::kL2 ? __ldg(a.xc_sq + row) : 0.f;
    t.xsq_true[h] = in && a.metric == lt::kCosine ? __ldg(a.xsq_true + row) : 0.f;
  }
  return t;
}

template <int NT>
__global__ void __launch_bounds__(kThreads) topc_kernel(const Args a) {
  constexpr int QN = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int kStageElems = (kTM + QN) * kStride;
  float* score = reinterpret_cast<float*>(ring + kStages * kStageElems);  // QN x kSRow
  __shared__ float s_qc_sq[kMaxQN], s_qm[kMaxQN], s_q_sq[kMaxQN];
  const int group = blockIdx.x % a.groups, span = blockIdx.x / a.groups;
  const int q0 = group * a.ql, nq = min(a.ql, a.B - q0);
  const int64_t row0 = (int64_t)span * a.span_rows;
  const int64_t row_end = min((int64_t)a.N, row0 + a.span_rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int list_len = a.kp + kPend;

  // the lists of this warp's queries j = warp + 8 m
  uint64_t* entries = a.lists ? a.lists + (int64_t)blockIdx.x * a.ql * list_len
                              : reinterpret_cast<uint64_t*>(score + QN * kSRow);
  lt::WarpTopk lists[NT];
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const int j = warp + 8 * m;
    if (j < nq)  // -inf keys (masked rows, NaN) never join
      lists[m].init(entries + (int64_t)j * list_len, a.kp, lt::kNoRowEntry);
  }

  // the group's query terms (read by the epilogue after the loop's first barrier)
  for (int j = threadIdx.x; j < QN; j += kThreads) {
    s_qc_sq[j] = j < nq ? a.qc_sq[q0 + j] : 0.f;
    s_qm[j] = j < nq ? a.qm[q0 + j] : 0.f;
    s_q_sq[j] = j < nq ? a.q_sq[q0 + j] : 0.f;
  }

  const int kchunks = (a.D + kKC - 1) / kKC;
  const int tiles = (int)((row_end - row0 + kTM - 1) / kTM);
  const int steps = tiles * kchunks;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage<QN>(a, ring + s * kStageElems, s, kchunks, row0, row_end, q0, nq);
    lt::cp_async_commit();
  }
  float acc[NT][4] = {};
  RowTerms terms = load_terms(a, row0, row_end);
  RowTerms next_terms = load_terms(a, row0 + kTM, row_end);
  for (int s = 0; s < steps; ++s) {
    lt::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; every warp is done with stage s - 1 and the scores
    const int next = s + kStages - 1;
    if (next < steps)
      load_stage<QN>(a, ring + (next % kStages) * kStageElems, next, kchunks, row0, row_end, q0,
                     nq);
    lt::cp_async_commit();
    lt::mma_stage<NT>(ring + (s % kStages) * kStageElems, acc);
    if (s % kchunks != kchunks - 1) continue;
    // epilogue of tile s / kchunks: the keys of rows r (h = 0) and r + 8
    // (h = 1) into the score tile, -inf where the row is masked or missing
    const int64_t tile_row = row0 + (int64_t)(s / kchunks) * kTM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * (lane & 3) + e;
          const float ip_c = acc[nt][2 * h + e];
          float sc;
          if (a.metric == lt::kIP) {
            sc = ip_c + terms.xm[h];
          } else if (a.metric == lt::kL2) {
            sc = lt::clamp_nonneg(s_qc_sq[j] + terms.xc_sq[h] - 2.f * ip_c);
          } else {
            sc = lt::cosine_distance(ip_c + terms.xm[h] + s_qm[j], sqrtf(s_q_sq[j] * terms.xsq_true[h]));
          }
          score[j * kSRow + r] = lt::to_key(sc, a.ascending, terms.live[h]);
          acc[nt][2 * h + e] = 0.f;
        }
    }
    terms = next_terms;
    next_terms = load_terms(a, tile_row + 2 * kTM, row_end);
    // when one list could not take a tile's keys, every list is flushed:
    // the warps then flush at the same barriers instead of each stalling
    // the block at its own
    bool full = false;
#pragma unroll
    for (int m = 0; m < NT; ++m) full |= warp + 8 * m < nq && lists[m].pend > kPend - kTM;
    const bool flush_all = __syncthreads_or(full);
    // each warp offers its queries' keys, rows in ascending order
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      const int j = warp + 8 * m;
      if (j >= nq) continue;
      if (flush_all) lists[m].flush(a.kp, a.C);
#pragma unroll
      for (int i = 0; i < kTM / 32; ++i) {
        const int r = 32 * i + lane;
        lists[m].offer(a.kp, lt::pack_entry(score[j * kSRow + r], (int)(tile_row + r)),
                       tile_row + r < row_end);
      }
    }
  }
  lt::cp_async_wait<0>();
  const int64_t ld = (int64_t)gridDim.x / a.groups * a.C;
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const int j = warp + 8 * m;
    if (j >= nq) continue;
    lists[m].flush(a.kp, a.C);
    const int64_t o = (int64_t)(q0 + j) * ld + (int64_t)span * a.C;
    for (int c = lane; c < a.C; c += 32) {
      const bool kept = c < lists[m].kept;
      a.out_keys[o + c] = kept ? lt::entry_key(lists[m].list[c]) : -INFINITY;
      a.out_idx[o + c] = kept ? lt::entry_id(lists[m].list[c]) : -1;
    }
  }
}

struct Plan {
  int nt, ql, groups, spans, span_rows, kp;
  size_t smem;
  bool device_lists;
};

template <int NT>
int blocks_per_sm(size_t smem) {
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(topc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    raised = true;
  }
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, topc_kernel<NT>, kThreads, smem);
  return n > 0 ? n : 1;
}

int resident(int nt, size_t smem) {
  switch (nt) {
    case 1: return blocks_per_sm<1>(smem);
    case 2: return blocks_per_sm<2>(smem);
    case 3: return blocks_per_sm<3>(smem);
    default: return blocks_per_sm<4>(smem);
  }
}

// ring, score tile and, in shared memory, the lists of ql queries
size_t smem_bytes(int ql, int kp, bool device_lists) {
  const int qn = (ql + 7) / 8 * 8;
  const size_t lists = device_lists ? 0 : (size_t)ql * (kp + kPend) * 8;
  return (size_t)kStages * (kTM + qn) * kStride * 2 + (size_t)qn * kSRow * 4 + lists;
}

// Queries a block, spans and where the lists live, from the shapes alone
// (the wrapper asks for the spans and the scratch with the same call).
Plan plan_for(int B, int N, int C) {
  Plan p{};
  p.kp = lt::list_kp(C);
  // up to 8 query groups share a span (their re-reads hit L2); fewer
  // queries a block leave room for two blocks an SM
  int ql = min(B, min(kMaxQN, max(8, ((B + 7) / 8 + 7) / 8 * 8)));
  while (ql > 0 && smem_bytes(ql, p.kp, false) > (size_t)kSmemLimit) --ql;
  p.device_lists = ql == 0;
  if (p.device_lists) ql = min(B, 8);
  p.ql = ql;
  p.nt = (ql + 7) / 8;
  p.groups = (B + ql - 1) / ql;
  p.smem = smem_bytes(ql, p.kp, p.device_lists);
  // one wave of the blocks the card holds at once: a partial second wave
  // would cost a whole one, and longer spans keep fewer candidates a row
  const int wave = resident(p.nt, p.smem) * lt::sm_count();
  const int most = max(1, N / (8 * C));
  const int spans = max(1, min(most, wave / p.groups));
  p.span_rows = ((N + spans - 1) / spans + kTM - 1) / kTM * kTM;  // at most `spans` spans
  p.spans = (N + p.span_rows - 1) / p.span_rows;
  return p;
}

template <int NT>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  topc_kernel<NT><<<(unsigned)(p.groups * p.spans), kThreads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Spans of the per-span lists: the output is (B, spans * C).
long long lt_topc_spans(int B, int N, int D, int C) { return plan_for(B, N, C).spans; }

// Entries (uint64) the device list buffer needs (0: the lists fit in shared
// memory).
long long lt_topc_scratch(int B, int N, int D, int C) {
  const Plan p = plan_for(B, N, C);
  return p.device_lists ? (long long)p.groups * p.spans * p.ql * (p.kp + kPend) : 0;
}

// Per-span top C of the first-pass keys: out_keys / out_idx (B, spans * C),
// list s of query b at b * spans * C + s * C, best first, (-inf, -1) where
// the span has fewer than C live rows. lists: lt_topc_scratch entries
// (null when 0). 1 <= C <= N.
int lt_bf16_centered_topc(const __nv_bfloat16* qc16, const __nv_bfloat16* x16, const float* qc_sq,
                          const float* qm, const float* q_sq, const float* xm, const float* xc_sq,
                          const float* xsq_true, const uint8_t* valid, int B, int N, int D, int C,
                          int metric, int ascending, float* out_keys, int* out_idx,
                          uint64_t* lists, cudaStream_t stream) {
  if (B < 1 || N < 1 || D < 1 || C < 1 || C > N) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(B, N, C);
  if (p.device_lists && !lists) return (int)cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && lt::aligned16(qc16) && lt::aligned16(x16);
  const Args a{qc16, x16, qc_sq, qm, q_sq, xm, xc_sq, xsq_true, valid, B, N, D, C, metric,
               ascending != 0, vec, p.groups, p.ql, p.span_rows, p.kp,
               p.device_lists ? lists : nullptr, out_keys, out_idx};
  switch (p.nt) {
    case 1: return launch<1>(a, p, stream);
    case 2: return launch<2>(a, p, stream);
    case 3: return launch<3>(a, p, stream);
    default: return launch<4>(a, p, stream);
  }
}

}  // extern "C"
