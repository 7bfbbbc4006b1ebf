// The bf16 tensor-core stage shared by K2 (bf16_centered_topc.cu, over a span
// of corpus rows) and K11's shared-list tile (bf16_gather_scores.cu, over
// gathered rows): a stage of the cp.async ring holds 64 dimensions of a
// 128-row tile and of a group of up to 32 queries, rows first, then queries,
// kMmaStride bf16 each; 8 warps of 16 rows run mma.sync m16n8k16 (bf16 in,
// f32 accumulate) over it, rows on M and queries on N.
#pragma once

#include "common.cuh"

namespace lt {

constexpr int kMmaRows = 128;     // rows a tile: 16 a warp
constexpr int kMmaDims = 64;      // dimensions a stage
constexpr int kMmaStride = kMmaDims + 8;  // bf16 a staged row (144 B: ldmatrix without conflicts)
constexpr int kMmaStages = 3;     // depth of the cp.async ring
constexpr int kMmaThreads = 256;  // 8 warps

// acc[nt] += the warp's 16 rows x n-tile nt's 8 queries over one stage.
// The accumulator layout is mma.sync's: acc[nt][2 h + e] holds row
// warp * 16 + lane / 4 + 8 h and query nt * 8 + 2 (lane % 4) + e.
template <int NT>
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* st, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* rows = st + (warp * 16 + (lane & 15)) * kMmaStride + (lane >> 4) * 8;
  const __nv_bfloat16* qs = st + (kMmaRows + (lane & 7)) * kMmaStride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < kMmaDims; ks += 16) {
    uint32_t a0, a1, a2, a3;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                 : "r"(smem_addr(rows + ks)));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                   : "=r"(b0), "=r"(b1)
                   : "r"(smem_addr(qs + nt * 8 * kMmaStride + ks)));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]), "+f"(acc[nt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

}  // namespace lt
