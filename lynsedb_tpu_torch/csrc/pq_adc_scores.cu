// K13: the PQ code scan (asymmetric distance computation). For one query the
// lookup table LUT[m][c] = <q_m, codebook[m][c]> holds the partial inner
// product of each subspace m with each of its 256 codewords; a row's
// approximate inner product is the sum over m of LUT[m][code_m]. The
// epilogue turns it into the metric's score; the oriented, masked keys go to
// K5, which takes the top-S shortlist that K11 rescores.
//
// Replaces lynsedb_tpu/ops/quantize.py pq_scores (:391). The JAX package
// evaluates the lookups as a nibble one-hot matrix product only because the
// TPU has no vector gather (quantize.py:398-409); here they are gathers from
// shared memory. Epilogue: IP ip, L2 max(|q|^2 + row_sq - 2 ip, 0), cosine
// 1 - ip / sqrt(|q|^2 row_sq) (1.0 below 1e-30); then the orientation and the
// mask (NaN and invalid rows -> -inf).
//
// Bound: bytes. The codes are N * M bytes (16 MB at 1M rows, M = 16) and the
// keys 4 * B * N (256 MB at B = 64); the B * N * M additions are far below the
// f32 rate. What limits this kernel is the shared-memory gather: M lookups a
// row at random banks.
// Design: a block serves one query and 4,096 rows (16 a thread). It builds
// the query's (M, 256) f32 table in dynamic shared memory (16 KB at M = 16;
// the kernel opts in above 48 KB), then each thread reads its rows' codes
// with 16-byte loads where M is a multiple of 16 and sums the table entries
// in subspace order. A table larger than the block's shared memory is built
// and summed in groups of subspaces.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kRows = kThreads * kRowsPerThread;  // rows a block
constexpr size_t kSmemMax = 232448;               // the most a block may opt in to

struct PqEpilogue {
  const float* q_sq;     // (B,) |q|^2 (L2, cosine)
  const float* row_sq;   // (N,) reconstructed squared norms (L2, cosine)
  const uint8_t* valid;  // (N,) 1 = live row
  int metric;
  bool ascending;

  __device__ __forceinline__ float operator()(int b, int64_t n, float ip) const {
    float s;
    if (metric == lt::kIP) {
      s = ip;
    } else if (metric == lt::kL2) {
      s = lt::clamp_nonneg(q_sq[b] + row_sq[n] - 2.f * ip);
    } else {
      s = lt::cosine_distance(ip, sqrtf(__fmul_rn(q_sq[b], row_sq[n])));
    }
    return lt::to_key(s, ascending, valid[n] != 0);
  }
};

// smem: lut [G][256] then the query row [M * Ds].
__global__ void __launch_bounds__(kThreads)
    pq_adc_kernel(const float* __restrict__ q, const uint8_t* __restrict__ codes,
                  const float* __restrict__ books, int N, int M, int Ds, int G, bool vec16,
                  PqEpilogue epi, float* __restrict__ keys) {
  extern __shared__ float smem[];
  float* lut = smem;
  float* qrow = smem + (size_t)G * 256;
  const int b = blockIdx.y;
  const int D = M * Ds;
  const int64_t n0 = (int64_t)blockIdx.x * kRows;
  for (int d = threadIdx.x; d < D; d += kThreads) qrow[d] = q[(int64_t)b * D + d];
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int g0 = 0; g0 < M; g0 += G) {
    const int gm = min(G, M - g0);
    __syncthreads();  // the query row is in; the previous group's lookups are done
    for (int e = threadIdx.x; e < gm * 256; e += kThreads) {
      const int m = e >> 8;
      const float* cb = books + ((int64_t)(g0 + m) * 256 + (e & 255)) * Ds;
      const float* qm = qrow + (g0 + m) * Ds;
      float s = 0.f;
      for (int t = 0; t < Ds; ++t) s = fmaf(qm[t], cb[t], s);
      lut[e] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t n = n0 + threadIdx.x + i * kThreads;
      if (n < N) {
        const uint8_t* cr = codes + n * M + g0;
        float s = acc[i];
        if (vec16) {
          for (int v = 0; v < gm; v += 16) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(cr + v));
            const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 16; ++j)
              s += lut[(v + j) * 256 + ((words[j >> 2] >> (8 * (j & 3))) & 255u)];
          }
        } else {
          for (int m = 0; m < gm; ++m) s += lut[m * 256 + cr[m]];
        }
        acc[i] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t n = n0 + threadIdx.x + i * kThreads;
    if (n < N) keys[(int64_t)b * N + n] = epi(b, n, acc[i]);
  }
}

}  // namespace

// q (B, M * Ds) f32, codes (N, M) uint8, books (M, 256, Ds) f32, q_sq (B,) and
// row_sq (N,) f32 (read for L2 and cosine; may be null for IP), valid (N,)
// -> keys (B, N) f32.
extern "C" int lt_pq_adc_scores(const float* q, const uint8_t* codes, const float* books,
                                const float* q_sq, const float* row_sq, const uint8_t* valid, int B,
                                int N, int M, int Ds, int metric, int ascending, float* keys,
                                cudaStream_t stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || Ds < 1) return (int)cudaErrorInvalidValue;
  const size_t qbytes = (size_t)M * Ds * sizeof(float);
  if (qbytes + 16 * 256 * sizeof(float) > kSmemMax) return (int)cudaErrorInvalidValue;
  // subspaces whose tables fit beside the query row, a multiple of 16 when
  // the table is split
  int G = M;
  if (qbytes + (size_t)G * 256 * sizeof(float) > kSmemMax)
    G = (int)((kSmemMax - qbytes) / (256 * sizeof(float))) & ~15;
  const size_t smem = (size_t)G * 256 * sizeof(float) + qbytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec16 = M % 16 == 0 && G % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const PqEpilogue epi{q_sq, row_sq, valid, metric, ascending != 0};
  const dim3 grid((unsigned)((N + kRows - 1) / kRows), (unsigned)B);
  pq_adc_kernel<<<grid, kThreads, smem, stream>>>(q, codes, books, N, M, Ds, G, vec16, epi, keys);
  return (int)cudaGetLastError();
}
