// The integer tensor-core tile shared by K6b's tile mode (binary_scores.cu:
// the popcount of ANDed bits, mma.sync m16n8k256 .b1 .and.popc) and K12
// (int8_code_scores.cu: the int8 dot of code rows, mma.sync m16n8k32 .s8).
// A b1 fragment of 256 bits has the register layout of an s8 fragment of 32
// bytes, so one stage layout and one ldmatrix addressing (mma_bf16.cuh's:
// 16-byte row segments as b16 matrices) feed both: a k-step is 32 bytes of
// a row, 256 bits or 32 codes. Both products are exact in int32, so the
// kernels' keys follow from the same integers as their plain versions'.
//
// Bound: bytes at the main path's shapes (the rows read once, the (B, N) f32
// keys written once); the products take a few percent of that time on the
// integer tensor cores. Design:
// - A block holds its group of up to 256 queries at full width in shared
//   memory, read once, and streams its span of corpus rows through a 3-deep
//   cp.async ring, ROWS rows x 128 bytes a stage (at most 128 registers a
//   thread, so two or three blocks an SM keep six or more stages in
//   flight), so the rows are read once at every B up to the group cap (128
//   KB of queries: 256 at 1,024 bits or 128 codes). Past the cap a batch takes more groups, adjacent in the grid
//   so their re-reads of a span hit L2.
// - 8 warps in a WR x WQ grid, each MT m-tiles of 16 rows x NT n-tiles of 8
//   queries, accumulate in registers; rows on M, queries on N, so one query
//   pads to 8, not to 16. The configuration follows the group's size.
// - Copies are 16 bytes where the row stride and the bases allow, else 4
//   bytes (a width of 4 * W bytes with W % 4 != 0); bytes past the row are
//   zero-filled up to the 32-byte k-step, and a zero adds nothing to either
//   product.
// - A tile's per-row epilogue terms (bit counts, or the quantizer's row
//   terms, and the valid bytes) ride in its last stage, so no load waits in
//   the epilogue. After that stage each warp stages its int32 products, 8
//   queries at a time, in its own shared buffer; then each lane keys 4
//   consecutive rows of one query (the queries' terms in shared memory) and
//   stores them row-contiguous: one 16-byte store (4-byte stores where
//   N % 4 != 0).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace lt {

constexpr int kIntThreads = 256;                // 8 warps
constexpr int kIntChunk = 128;                  // bytes of a row a stage: 4 k-steps
constexpr int kIntStride = kIntChunk + 16;      // a staged row (144 B: ldmatrix without conflicts)
constexpr int kIntStages = 3;                   // depth of the cp.async ring
constexpr int kIntMaxQueries = 256;             // queries a group
constexpr int kIntQueryBytes = 128 * 1024;      // shared memory for a group's queries
constexpr int kIntSmemLimit = 227 * 1024;       // what a block may use

struct IntTileArgs {
  const uint8_t* q;  // (B, row_bytes) query rows: bits or int8 codes
  const uint8_t* x;  // (N, row_bytes) corpus rows
  int B, N, row_bytes;
  int kbytes;        // row_bytes rounded up to a 32-byte k-step
  bool vec;          // 16-byte copies, else 4-byte
  bool vec_out;      // 16-byte key stores
  int qcap;          // queries a group
  int ql8;           // query rows in shared memory: min(B, qcap) rounded up to 8
  int groups, span_rows;
  float* keys;       // (B, N)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// Bytes [k0, k0 + kc) of rows first .. first + rows - 1 of src (row_bytes a
// row) into dst (dst_stride a row): zero past row_bytes and for rows at or
// past `live`. Every thread of the block calls it.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int dst_stride, const uint8_t* src,
                                           int64_t first, int64_t live, int rows, int row_bytes,
                                           int k0, int kc, bool vec) {
  const int seg = vec ? 16 : 4;
  const int per_row = kc / seg;
  for (int e = threadIdx.x; e < rows * per_row; e += kIntThreads) {
    const int r = per_row == 8 ? e >> 3 : e / per_row;  // 8: a full stage of 16-byte copies
    const int off = k0 + (e - r * per_row) * seg;
    const int64_t n = first + r;
    const int bytes = n < live ? max(0, min(seg, row_bytes - off)) : 0;
    const uint8_t* s = bytes ? src + n * row_bytes + off : src;
    uint8_t* d = dst + r * dst_stride + (off - k0);
    if (vec) {
      cp_async16(d, s, bytes);
    } else {
      cp_async4(d, s, bytes);
    }
  }
}

// c += the 16 x 8 product of one k-step: popcount(a AND b) for bits, the
// int8 dot for codes. Fragments as mma_bf16.cuh's, bytes for bf16 pairs.
template <bool BITS>
__device__ __forceinline__ void mma_int(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if constexpr (BITS) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Bytes [0, n_bytes) of src into dst in 16-byte copies where both allow it
// (src 16-byte aligned), else 4-byte ones (src 4-byte aligned); zero past
// n_bytes, up to `bytes` (a multiple of 16). Every thread of the block calls it.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int64_t n_bytes,
                                            int bytes) {
  const int seg = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? 16 : 4;
  for (int o = threadIdx.x * seg; o < bytes; o += kIntThreads * seg) {
    const int got = (int)max((int64_t)0, min((int64_t)seg, n_bytes - o));
    if (seg == 16) {
      cp_async16(dst + o, got ? src + o : src, got);
    } else {
      cp_async4(dst + o, got ? src + o : src, got);
    }
  }
}

// The per-row terms of a tile's epilogue: Epi::kTerms f32 arrays (null
// where the epilogue does not read one) and the valid bytes, copied with the
// tile's last stage into that stage's slot, so they land with the codes.
template <int ROWS, class Epi>
__device__ __forceinline__ void stage_terms(uint8_t* dst, const Epi& epi, int64_t first,
                                            int64_t end) {
  const int64_t live = end - first;  // rows of the tile that exist
#pragma unroll
  for (int i = 0; i < Epi::kTerms; ++i)
    if (epi.term[i] != nullptr)
      stage_bytes(dst + i * ROWS * 4, reinterpret_cast<const uint8_t*>(epi.term[i] + first),
                  live * 4, ROWS * 4);
  uint8_t* valid = dst + Epi::kTerms * ROWS * 4;
  if ((reinterpret_cast<uintptr_t>(epi.valid + first) & 3) == 0) {
    stage_bytes(valid, epi.valid + first, live, ROWS);
  } else {  // a mask at an odd address: plain loads (read after the next barrier)
    for (int r = threadIdx.x; r < ROWS; r += kIntThreads)
      valid[r] = r < live ? epi.valid[first + r] : 0;
  }
}

// The kernel. Epi (the caller's epilogue) has
//   kTerms, term[kTerms], valid             the per-row f32 arrays it reads
//                                           (at most 3; null: unread) and
//                                           the mask;
//   Query query(int b)                      a query's terms (staged once, in
//                                           shared memory);
//   float key(const Query&, float t0, float t1, float t2, bool live,
//             int acc)                      a row's key from its int32
//                                           product and its terms (t1, t2
//                                           zero past kTerms).
// acc[m][nt][2 h + e] holds row m * 16 + lane / 4 + 8 h of the warp's rows
// and query nt * 8 + 2 (lane % 4) + e of its queries (mma.sync's layout).
// In the epilogue each lane takes 4 consecutive rows of the warp, the same
// ones for every query.
template <int WR, int MT, int NT, bool BITS, class Epi>
__global__ void __launch_bounds__(kIntThreads, 2) int_tile_kernel(const IntTileArgs a, const Epi epi) {
  constexpr int ROWS = WR * MT * 16;
  constexpr int BS = MT * 16 + 4;  // ints a query of a warp's buffer (stores without conflicts)
  constexpr int VS = MT * 4;       // groups of 4 rows a warp
  constexpr int NTERM = Epi::kTerms;
  constexpr int SLOT = ROWS * kIntStride + ROWS * (4 * NTERM + 1);  // a stage and its row terms
  static_assert(SLOT % 16 == 0 && NTERM >= 1 && NTERM <= 3, "16-byte slots, 1-3 term arrays");
  using Query = typename Epi::Query;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* ring = smem;
  const int qstride = a.kbytes + 16;
  uint8_t* qs = ring + kIntStages * SLOT;
  int* bufs = reinterpret_cast<int*>(qs + (size_t)a.ql8 * qstride);
  Query* qterm = reinterpret_cast<Query*>(bufs + 8 * 8 * BS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % WR, wq = warp / WR;
  const int g = lane >> 2, t = lane & 3, v = lane % VS;
  int* buf = bufs + warp * 8 * BS;
  const int group = blockIdx.x % a.groups, span = blockIdx.x / a.groups;
  const int q0 = group * a.qcap, nq = min(a.qcap, a.B - q0);
  const int64_t row0 = (int64_t)span * a.span_rows;
  const int64_t row_end = min((int64_t)a.N, row0 + a.span_rows);
  const int kchunks = (a.kbytes + kIntChunk - 1) / kIntChunk;
  const int steps = (int)((row_end - row0 + ROWS - 1) / ROWS) * kchunks;
  const int qb = wq * NT * 8;  // the warp's first query of the group
  const int nt_live = max(0, min(NT, (nq - qb + 7) / 8));
  const int lrow = wr * MT * 16 + 4 * v;  // this lane's first epilogue row in a tile

  auto load_step = [&](int s) {
    uint8_t* slot = ring + (s % kIntStages) * SLOT;
    const int k0 = (s % kchunks) * kIntChunk;
    const int64_t first = row0 + (int64_t)(s / kchunks) * ROWS;
    stage_rows(slot, kIntStride, a.x, first, row_end, ROWS, a.row_bytes, k0,
               min(kIntChunk, a.kbytes - k0), a.vec);
    if (s % kchunks == kchunks - 1) stage_terms<ROWS>(slot + ROWS * kIntStride, epi, first, row_end);
  };

  // the group's queries at full width travel with the first stage; their
  // terms go to shared memory (read after the loop's first barrier)
  stage_rows(qs, qstride, a.q, q0, q0 + nq, (nq + 7) & ~7, a.row_bytes, 0, a.kbytes, a.vec);
  for (int j = threadIdx.x; j < nq; j += kIntThreads) qterm[j] = epi.query(q0 + j);
#pragma unroll
  for (int s = 0; s < kIntStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  int acc[MT][NT][4] = {};
  const uint8_t* brow = qs + (qb + (lane & 7)) * qstride + ((lane >> 3) & 1) * 16;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kIntStages - 2>();
    __syncthreads();  // stage s has landed; every warp is done with stage s - 1
    if (s + kIntStages - 1 < steps) load_step(s + kIntStages - 1);
    cp_async_commit();
    if (nt_live == 0) continue;
    const int c = s % kchunks, k0 = c * kIntChunk;
    const int ksteps = min(kIntChunk, a.kbytes - k0) / 32;
    const uint8_t* slot = ring + (s % kIntStages) * SLOT;
    const uint8_t* arow = slot + (wr * MT * 16 + (lane & 15)) * kIntStride + (lane >> 4) * 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt_live)
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                       : "=r"(b[nt][0]), "=r"(b[nt][1])
                       : "r"(smem_addr(brow + nt * 8 * qstride + k0 + ks * 32)));
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
                     : "r"(smem_addr(arow + m * 16 * kIntStride + ks * 32)));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < nt_live) mma_int<BITS>(acc[m][nt], af, b[nt]);
      }
    }
    if (c != kchunks - 1) continue;
    // epilogue of the tile, 8 queries at a time: the products through the
    // warp's buffer, then each lane keys its 4 rows for one query a pass
    // and stores them row-contiguous
    const int64_t rbase = row0 + (int64_t)(s / kchunks) * ROWS + wr * MT * 16;
    const int nrows = (int)min((int64_t)(MT * 16), row_end - rbase);  // <= 0: none
    // this lane's 4 rows' terms (ta, tb, tc: up to three arrays), from the slot
    const float* terms = reinterpret_cast<const float*>(slot + ROWS * kIntStride);
    const float4 ta = *reinterpret_cast<const float4*>(terms + lrow);
    const float4 tb = NTERM > 1 ? *reinterpret_cast<const float4*>(terms + ROWS + lrow)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 tc = NTERM > 2 ? *reinterpret_cast<const float4*>(terms + 2 * ROWS + lrow)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    const uint32_t live4 = *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const uint8_t*>(terms + NTERM * ROWS) + lrow);
    // rolled loops: one copy of the key arithmetic (the register tile is
    // read by an unrolled selection, so it stays in registers)
#pragma unroll 1
    for (int nt = 0; nt < nt_live; ++nt) {
#pragma unroll
      for (int n2 = 0; n2 < NT; ++n2) {
        if (n2 == nt) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                buf[(2 * t + e) * BS + m * 16 + g + 8 * h] = acc[m][n2][2 * h + e];
        }
      }
      __syncwarp();
#pragma unroll 2
      for (int it = 0; it < MT; ++it) {  // 8 queries x VS groups over 32 lanes
        const int jj = lane / VS + it * (32 / VS);
        const int j = qb + nt * 8 + jj;
        if (j < nq && 4 * v < nrows) {
          const int4 p = *reinterpret_cast<const int4*>(buf + jj * BS + 4 * v);
          const Query qv = qterm[j];
          const float4 k =
              make_float4(epi.key(qv, ta.x, tb.x, tc.x, live4 & 0xffu, p.x),
                          epi.key(qv, ta.y, tb.y, tc.y, (live4 >> 8) & 0xffu, p.y),
                          epi.key(qv, ta.z, tb.z, tc.z, (live4 >> 16) & 0xffu, p.z),
                          epi.key(qv, ta.w, tb.w, tc.w, live4 >> 24, p.w));
          float* dst = a.keys + (int64_t)(q0 + j) * a.N + rbase + 4 * v;
          if (a.vec_out) {
            *reinterpret_cast<float4*>(dst) = k;
          } else {
            dst[0] = k.x;
            if (4 * v + 1 < nrows) dst[1] = k.y;
            if (4 * v + 2 < nrows) dst[2] = k.z;
            if (4 * v + 3 < nrows) dst[3] = k.w;
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0;
  }
  cp_async_wait<0>();
}

// Plans and launches one configuration: spans sized so the grid is one wave
// of the blocks the card holds at once.
template <int WR, int MT, int NT, bool BITS, class Epi>
int int_tile_run(IntTileArgs a, const Epi& epi, cudaStream_t stream) {
  constexpr int ROWS = WR * MT * 16;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(int_tile_kernel<WR, MT, NT, BITS, Epi>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kIntSmemLimit);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const size_t smem = (size_t)kIntStages * (ROWS * kIntStride + ROWS * (4 * Epi::kTerms + 1)) +
                      (size_t)a.ql8 * (a.kbytes + 16) +
                      (size_t)8 * 8 * (MT * 16 + 4) * sizeof(int) +
                      (size_t)a.ql8 * sizeof(typename Epi::Query);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int_tile_kernel<WR, MT, NT, BITS, Epi>,
                                                kIntThreads, smem);
  const int64_t tiles = ((int64_t)a.N + ROWS - 1) / ROWS;
  const int64_t wave = (int64_t)std::max(per_sm, 1) * sm_count();
  const int64_t spans = std::max<int64_t>(1, std::min<int64_t>(tiles, wave / a.groups));
  a.span_rows = (int)((((int64_t)a.N + spans - 1) / spans + ROWS - 1) / ROWS * ROWS);
  const int64_t n_spans = ((int64_t)a.N + a.span_rows - 1) / a.span_rows;
  int_tile_kernel<WR, MT, NT, BITS, Epi>
      <<<(unsigned)(n_spans * a.groups), kIntThreads, smem, stream>>>(a, epi);
  return (int)cudaGetLastError();
}

// keys (B, N) = epi's keys of the int32 products of every query row of q
// against every corpus row of x, both row_bytes a row (a multiple of 4, at
// most 16,368: a group of 8 queries must fit in its 128 KB).
template <bool BITS, class Epi>
int int_tile_scores(const uint8_t* q, const uint8_t* x, int B, int N, int row_bytes,
                    const Epi& epi, float* keys, cudaStream_t stream) {
  if (B < 1 || N < 1 || row_bytes < 1 || row_bytes % 4 != 0) return (int)cudaErrorInvalidValue;
  IntTileArgs a{};
  a.q = q;
  a.x = x;
  a.B = B;
  a.N = N;
  a.row_bytes = row_bytes;
  a.kbytes = (row_bytes + 31) / 32 * 32;
  a.qcap = std::min(kIntMaxQueries, kIntQueryBytes / (a.kbytes + 16) / 8 * 8);
  if (a.qcap < 8) return (int)cudaErrorInvalidValue;
  const int ql = std::min(B, a.qcap);
  a.ql8 = (ql + 7) / 8 * 8;
  a.groups = (B + a.qcap - 1) / a.qcap;
  a.vec = row_bytes % 16 == 0 && aligned16(q) && aligned16(x);
  a.vec_out = N % 4 == 0 && aligned16(keys);
  a.keys = keys;
  if (ql <= 8) return int_tile_run<8, 1, 1, BITS>(a, epi, stream);
  if (ql <= 32) return int_tile_run<8, 1, 4, BITS>(a, epi, stream);
  if (ql <= 64) return int_tile_run<4, 2, 4, BITS>(a, epi, stream);
  if (ql <= 128) return int_tile_run<2, 4, 4, BITS>(a, epi, stream);
  return int_tile_run<1, 4, 4, BITS>(a, epi, stream);
}

}  // namespace lt
