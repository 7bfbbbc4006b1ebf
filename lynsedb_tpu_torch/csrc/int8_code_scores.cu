// K12: the code scan of the SQ8, RaBitQ and PolarVec indexes. Each query row
// is quantized to int8 as the JAX package's _int8_dot does, dotted with every
// row of int8 codes in exact int32 arithmetic, and turned into an
// approximate score by the quantizer's epilogue; the oriented, masked keys go
// to K5, which takes the top-S shortlist that K11 rescores.
//
// Replaces lynsedb_tpu/ops/quantize.py _int8_dot (:90), sq8_scores (:167),
// rabitq_scores (:223) and polarvec_scores (:278):
//   prologue  amax = max |a|, scale = amax / 127 (1 where amax is 0),
//             code = clip(rint(a / scale), -127, 127); a = q * scale_d for
//             SQ8, the rotated query (K14) for RaBitQ and PolarVec
//   body      acc = sum code_q * code_x (int32, exact: the same integer as
//             JAX's int8 dot with an int32 result); dot = float(acc) * scale
//   SQ8       ip = q.(lo + 128 scale) + dot
//   RaBitQ    ip = alpha_n * dot
//   PolarVec  ip = lo_n * sum(q_rot) + scale_n * dot
//   then IP ip, L2 max(|q|^2 + row_sq - 2 ip, 0), cosine 1 - ip / sqrt(|q|^2
//   row_sq) (1.0 below 1e-30), with |q|^2 of the unrotated query; then the
//   orientation and the mask (NaN and invalid rows -> -inf).
//
// Bound: bytes. The codes are N * Dp bytes (128 MB at 1M x 128) and the keys
// 4 * B * N (256 MB at B = 64); the 2 * B * N * Dp integer operations take a
// tenth of that time at the int8 tensor-core rate. The kernel does not use the
// tensor cores: __dp4a (four int8 products into an int32 a lane) on the CUDA
// cores.
// Design: a prologue kernel quantizes the B query rows into a (B, Dp) int8
// scratch. The scan kernel's block holds a tile of code rows (256 rows at
// B <= 16, else 64) and up to 64 queries; it stages 128-code chunks of the
// rows with 16-byte loads and the queries' chunks into shared memory, and
// each thread accumulates one row against its queries with __dp4a, the row's
// word kept in a register and the queries' words read four at a time.
#include "common.cuh"

namespace {

enum Kind : int { kSQ8 = 0, kRaBitQ = 1, kPolarVec = 2 };

constexpr int kThreads = 256;
constexpr int kWords = 32;  // 4-byte code words a shared-memory chunk (128 codes)

// One block a query row: codes (B, Dp) int8 of a[b] (times dim_scale where
// given) over its D columns, zero beyond them, and each row's scale.
__global__ void __launch_bounds__(kThreads)
    quantize_queries_kernel(const float* __restrict__ a, const float* __restrict__ dim_scale, int D,
                            int Dp, int8_t* __restrict__ q_i8, float* __restrict__ q_scale) {
  __shared__ float red[kThreads / 32];
  const float* ab = a + (int64_t)blockIdx.x * D;
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = dim_scale ? ab[d] * dim_scale[d] : ab[d];
    amax = fmaxf(amax, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax > 0.f ? amax / 127.f : 1.f;  // a true division, as JAX's
  int8_t* out = q_i8 + (int64_t)blockIdx.x * Dp;
  for (int d = threadIdx.x; d < Dp; d += kThreads) {
    float c = 0.f;
    if (d < D) {
      const float v = dim_scale ? ab[d] * dim_scale[d] : ab[d];
      c = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
    }
    out[d] = (int8_t)c;
  }
  if (threadIdx.x == 0) q_scale[blockIdx.x] = scale;
}

struct CodeEpilogue {
  const float* q_base;  // (B,) SQ8: q . (lo + 128 scale)
  const float* q_sq;    // (B,) |q|^2 of the unrotated query (L2, cosine)
  const float* q_sum;   // (B,) PolarVec: sum of the rotated query
  const float* row_a;   // (N,) RaBitQ alpha, PolarVec scale
  const float* row_b;   // (N,) PolarVec lo
  const float* row_sq;  // (N,) the rows' squared norms (L2, cosine)
  const uint8_t* valid; // (N,) 1 = live row
  int kind;
  int metric;
  bool ascending;

  // the products and the sum stay separate roundings (no FMA contraction),
  // as in the JAX expressions
  __device__ __forceinline__ float operator()(int b, int64_t n, float dot) const {
    float ip;
    if (kind == kSQ8) {
      ip = __fadd_rn(q_base[b], dot);
    } else if (kind == kRaBitQ) {
      ip = __fmul_rn(row_a[n], dot);
    } else {
      ip = __fadd_rn(__fmul_rn(row_b[n], q_sum[b]), __fmul_rn(row_a[n], dot));
    }
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

// Block: ROWS code rows x TQ queries; thread (r, lane) accumulates row r
// against queries lane, lane + LANES, ... of the tile.
template <int ROWS, int TQ>
__global__ void __launch_bounds__(kThreads)
    int8_scores_kernel(const int8_t* __restrict__ q_i8, const float* __restrict__ q_scale,
                       const int8_t* __restrict__ codes, int B, int N, int Dp, CodeEpilogue epi,
                       float* __restrict__ keys) {
  constexpr int LANES = kThreads / ROWS < TQ ? kThreads / ROWS : TQ;
  constexpr int QPT = TQ / LANES;  // queries a thread accumulates
  __shared__ int rows_s[ROWS][kWords + 1];
  __shared__ __align__(16) int qs[TQ][kWords];
  const int r = threadIdx.x % ROWS, lane = threadIdx.x / ROWS;
  const int64_t n0 = (int64_t)blockIdx.x * ROWS;
  const int b0 = blockIdx.y * TQ;
  const int words = Dp / 4;
  int acc[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) acc[j] = 0;
  for (int w0 = 0; w0 < words; w0 += kWords) {
    const int cw = min(kWords, words - w0);  // a multiple of 4: Dp % 16 == 0
    const int vecs = cw / 4;
    for (int e = threadIdx.x; e < ROWS * vecs; e += kThreads) {
      const int rr = e / vecs, v = e % vecs;
      int4 val = make_int4(0, 0, 0, 0);
      if (n0 + rr < N) val = __ldg(reinterpret_cast<const int4*>(codes + (n0 + rr) * Dp) + w0 / 4 + v);
      rows_s[rr][4 * v] = val.x;
      rows_s[rr][4 * v + 1] = val.y;
      rows_s[rr][4 * v + 2] = val.z;
      rows_s[rr][4 * v + 3] = val.w;
    }
    for (int e = threadIdx.x; e < TQ * cw; e += kThreads) {
      const int qq = e / cw, w = e % cw;
      qs[qq][w] = b0 + qq < B
                      ? reinterpret_cast<const int*>(q_i8 + (int64_t)(b0 + qq) * Dp)[w0 + w]
                      : 0;
    }
    __syncthreads();
    if (lane < LANES) {
      for (int w = 0; w < cw; w += 4) {
        const int x0 = rows_s[r][w], x1 = rows_s[r][w + 1], x2 = rows_s[r][w + 2],
                  x3 = rows_s[r][w + 3];
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int4 qv = *reinterpret_cast<const int4*>(&qs[lane + j * LANES][w]);
          acc[j] = __dp4a(x0, qv.x, acc[j]);
          acc[j] = __dp4a(x1, qv.y, acc[j]);
          acc[j] = __dp4a(x2, qv.z, acc[j]);
          acc[j] = __dp4a(x3, qv.w, acc[j]);
        }
      }
    }
    __syncthreads();
  }
  const int64_t n = n0 + r;
  if (n >= N || lane >= LANES) return;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int b = b0 + lane + j * LANES;
    if (b < B) keys[(int64_t)b * N + n] = epi(b, n, __fmul_rn((float)acc[j], q_scale[b]));
  }
}

template <int ROWS, int TQ>
void launch_scan(const int8_t* q_i8, const float* q_scale, const int8_t* codes, int B, int N,
                 int Dp, const CodeEpilogue& epi, float* keys, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + ROWS - 1) / ROWS), (unsigned)((B + TQ - 1) / TQ));
  int8_scores_kernel<ROWS, TQ><<<grid, kThreads, 0, stream>>>(q_i8, q_scale, codes, B, N, Dp, epi,
                                                              keys);
}

}  // namespace

// a (B, D) f32 rows to quantize (SQ8: the query, multiplied by dim_scale (D,)
// first; RaBitQ / PolarVec: the rotated query, dim_scale null); codes (N, Dp)
// int8, Dp a multiple of 16 and >= D, the columns past D zero; q_i8 (B, Dp)
// int8 and q_scale (B,) f32 scratch -> keys (B, N) f32. Per-query and per-row
// arrays as CodeEpilogue; those the kind and metric do not read may be null.
extern "C" int lt_int8_code_scores(const float* a, const float* dim_scale, const int8_t* codes,
                                   const float* q_base, const float* q_sq, const float* q_sum,
                                   const float* row_a, const float* row_b, const float* row_sq,
                                   const uint8_t* valid, int B, int N, int D, int Dp, int kind,
                                   int metric, int ascending, int8_t* q_i8, float* q_scale,
                                   float* keys, cudaStream_t stream) {
  if (B < 1 || B > 65535 * 16 || N < 1 || D < 1 || Dp < D || Dp % 16 != 0 || kind < 0 || kind > 2 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  quantize_queries_kernel<<<B, kThreads, 0, stream>>>(a, dim_scale, D, Dp, q_i8, q_scale);
  const CodeEpilogue epi{q_base, q_sq, q_sum, row_a, row_b, row_sq, valid, kind, metric,
                         ascending != 0};
  if (B == 1) {
    launch_scan<256, 1>(q_i8, q_scale, codes, B, N, Dp, epi, keys, stream);
  } else if (B <= 4) {
    launch_scan<256, 4>(q_i8, q_scale, codes, B, N, Dp, epi, keys, stream);
  } else if (B <= 16) {
    launch_scan<256, 16>(q_i8, q_scale, codes, B, N, Dp, epi, keys, stream);
  } else {
    launch_scan<64, 64>(q_i8, q_scale, codes, B, N, Dp, epi, keys, stream);
  }
  return (int)cudaGetLastError();
}
