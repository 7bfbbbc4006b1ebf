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
// tenth of that time at the int8 tensor-core rate.
// Design: a prologue kernel, a block a query, quantizes the B query rows into
// a (B, Dp) int8 scratch and their scales. The per-query terms the epilogue
// reads (|q|^2, SQ8's q . (lo + 128 scale), PolarVec's sum of the rotated
// query) come from the caller's PyTorch ops, the plain version's own: formed
// here as f32 block sums in another order, they moved near-cancelling L2
// keys by up to 3e-5 (four ulps of |q|^2 ~ 100), past the kernel's 1e-5
// tolerance against the plain version. The scan is mma_int.cuh's tile with
// mma.sync m16n8k32 .s8 .s8 .s32 (code rows on M, queries on N): the batch's
// quantized queries held in shared memory, the codes streamed once through a
// cp.async ring of 16-byte copies (a Dp with Dp % 32 == 16 zero-filled to
// the k-step), the keys staged through shared memory into row-contiguous
// 16-byte stores.
#include "mma_int.cuh"

namespace {

enum Kind : int { kSQ8 = 0, kRaBitQ = 1, kPolarVec = 2 };

constexpr int kThreads = 256;

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

// The tile's epilogue: dot = float(acc) * scale, the quantizer's inner
// product, the metric, the orientation and the mask.
struct CodeEpilogue {
  static constexpr int kTerms = 3;
  const float* term[kTerms];  // (N,) RaBitQ alpha / PolarVec scale, PolarVec lo,
                              // the rows' squared norms (L2, cosine); null: unread
  const uint8_t* valid;       // (N,) 1 = live row
  const float* q_scale;       // (B,) the quantized queries' scales
  const float* q_base;        // (B,) SQ8: q . (lo + 128 scale)
  const float* q_sq;          // (B,) |q|^2 of the unrotated query (L2, cosine)
  const float* q_sum;         // (B,) PolarVec: sum of the rotated query
  int kind;
  int metric;
  bool ascending;

  struct Query {
    float scale = 1.f, base = 0.f, sq = 0.f, sum = 0.f;
  };
  __device__ __forceinline__ Query query(int b) const {
    Query q;
    q.scale = __ldg(q_scale + b);
    if (kind == kSQ8) q.base = __ldg(q_base + b);
    if (metric != lt::kIP) q.sq = __ldg(q_sq + b);
    if (kind == kPolarVec) q.sum = __ldg(q_sum + b);
    return q;
  }
  // the products and the sum stay separate roundings (no FMA contraction),
  // as in the JAX expressions
  __device__ __forceinline__ float key(const Query& q, float ta, float tb, float row_sq,
                                       bool live, int acc) const {
    const float dot = __fmul_rn((float)acc, q.scale);
    float ip;
    if (kind == kSQ8) {
      ip = __fadd_rn(q.base, dot);
    } else if (kind == kRaBitQ) {
      ip = __fmul_rn(ta, dot);
    } else {
      ip = __fadd_rn(__fmul_rn(tb, q.sum), __fmul_rn(ta, dot));
    }
    float s;
    if (metric == lt::kIP) {
      s = ip;
    } else if (metric == lt::kL2) {
      s = lt::clamp_nonneg(q.sq + row_sq - 2.f * ip);
    } else {
      s = lt::cosine_distance(ip, sqrtf(__fmul_rn(q.sq, row_sq)));
    }
    return lt::to_key(s, ascending, live);
  }
};

}  // namespace

// a (B, D) f32 rows to quantize (SQ8: the query, multiplied by dim_scale (D,)
// first; RaBitQ / PolarVec: the rotated query, dim_scale null); codes (N, Dp)
// int8, Dp a multiple of 16 and >= D (at most 16,368), the columns past D
// zero; q_i8 (B, Dp) int8 and q_scale (B,) f32 scratch -> keys (B, N) f32.
// Per-query and per-row arrays as CodeEpilogue; those the kind and metric do
// not read may be null.
extern "C" int lt_int8_code_scores(const float* a, const float* dim_scale, const int8_t* codes,
                                   const float* q_base, const float* q_sq, const float* q_sum,
                                   const float* row_a, const float* row_b, const float* row_sq,
                                   const uint8_t* valid, int B, int N, int D, int Dp, int kind,
                                   int metric, int ascending, int8_t* q_i8, float* q_scale,
                                   float* keys, cudaStream_t stream) {
  if (B < 1 || N < 1 || D < 1 || Dp < D || Dp % 16 != 0 || kind < 0 || kind > 2 ||
      !lt::aligned16(codes) || !lt::aligned16(q_i8))
    return (int)cudaErrorInvalidValue;
  quantize_queries_kernel<<<B, kThreads, 0, stream>>>(a, dim_scale, D, Dp, q_i8, q_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CodeEpilogue epi{{kind != kSQ8 ? row_a : nullptr, kind == kPolarVec ? row_b : nullptr,
                          metric != lt::kIP ? row_sq : nullptr},
                         valid, q_scale, q_base, q_sq, q_sum, kind, metric, ascending != 0};
  return lt::int_tile_scores<false>(reinterpret_cast<const uint8_t*>(q_i8),
                                    reinterpret_cast<const uint8_t*>(codes), B, N, Dp, epi, keys,
                                    stream);
}
