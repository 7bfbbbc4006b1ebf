// K20: the alpha robust prune of a node chunk, one block a node; or, in its
// keys mode, only the keys the host prune reads.
//
// Replaces lynsedb_tpu/ops/graph.py _prune_chunk_kernel (:609: the gather,
// the point and pair keys in f32 and _robust_prune_dev's fori_loop over ranks,
// :554) and candidate_pair_keys (:446: the (BS, L, L) keys of
// _link_points_batch, _reprune_nodes and repair_deleted_edges), under IP, L2
// and cosine and, over the lead rows and per-row terms of a metric's
// transform, under the graph indexes' domain metrics (_keyed_pairwise, :99;
// metrics.cuh's formulas).
//
// Bound: the pair table. A node's M = L + 1 rows (M = L without node ids)
// give M (M + 1) / 2 distinct entries, each a chain over the D dimensions of
// separately rounded operations: a multiply and an add for the Gram (no FMA,
// so two f32 instructions), the elementwise term of L1, Chebyshev,
// Wasserstein (two) or Jensen-Shannon (three and a logarithm on the
// special-function units). At L = 72, D = 128 that is 2.83 G instructions
// for 4,096 nodes, 0.085 ms at the f32 instruction rate; the gathers, M rows
// of D f32 a node, 0.046 ms at 3.35 TB/s (tools/roofline.py prune_bound).
// What holds it back (tools/tile_times.py on an H100, and clock64 marks
// between the phases of an instrumented copy): the fill takes about half of
// a block's life, short of the f32 rate, as each 4 x 4 tile's two 16-byte
// shared loads a dimension keep the shared-memory pipe nearly as busy as the
// f32 one; the ranks, masks and walk after it take the other half: chains of
// few dependent instructions, made parallel where they can be and short
// where they cannot.
//
// Design:
//  * The table is filled as its upper triangle of 4 x 4 tiles (M padded to a
//    multiple of 4), one tile a thread; a round of tiles takes the whole
//    block (rounds: tiles / 256 rounded up; the block has as many threads as
//    a round's tiles, rounded up to a warp). A thread keeps its 16 entries in
//    registers across all of D and writes each to (i, j) and (j, i) once.
//  * The rows are staged k-major (a dimension's M values contiguous, the row
//    stride S with S / 4 odd), so a thread reads its 4 row values and 4
//    column values of one dimension as two 16-byte loads for 16 entries; the
//    stages are gathered by 4-byte cp.async copies (a warp's copies: 4 rows x
//    8 dimensions, 32-byte pieces of rows in global memory, 32 banks apart in
//    the transposed stage) in a two-deep ring, the next stage in flight while
//    this one accumulates. A large M streams the stages again each round.
//  * Haversine (D = 2) fills the whole M x M table of keys in one pass, each
//    row's radians and cos(lat) formed once (metrics.cuh GeoRow): its
//    symmetry would rest on sinf being odd to the bit, which is not shown.
//  * key(i, j), row i on the query side, follows from the entry, the
//    diagonal and the rows' terms. The keys mode writes them out, a warp a
//    row. The prune mode forms the point keys, the ranks (a stable
//    descending sort of the point keys, the lower index first between equal
//    keys, as JAX's argsort gives them; a thread a candidate), then every
//    candidate's dominance mask in rank space: bit b of word w is set where
//    keeping the candidate drops the one of rank 32 w + b (point < alpha *
//    key for ascending metrics, point < key - ln(alpha) for inner product),
//    a warp's ballot a word. The walk is then one warp: lane w holds word w
//    of the dropped ranks, a ballot finds the next rank not dropped, which is
//    kept while fewer than r are and ORs in its mask. A walk step is a few
//    shuffles and one shared load, not a row of keys.
//
// Why half the table is enough, to the bit: the parent kernel and the plain
// version (ops/graph.py _table_seq) form entry (i, j) as a chain over the
// dimensions in order of one commutative, separately rounded step of the two
// rows' values u_i, u_j: fl(u_i * u_j) for the Gram (IP, L2, cosine,
// correlation, Hellinger), fabsf(fl(u_i - u_j)) for L1, Chebyshev and
// Wasserstein (round to nearest is symmetric under negation, so fl(a - b) =
// -fl(b - a), and a NaN result is the same canonical NaN), and fl(u_i + u_j)
// before Jensen-Shannon's m log m. The chain's additions (or Chebyshev's max)
// then see the same operands in the same order, so entry (j, i) equals entry
// (i, j), and every entry equals the plain version's and the parent's.
#include "metrics.cuh"

namespace {

constexpr int kMaxThreads = 256;        // a block's threads, at most
constexpr int kTile = 4;                // a thread's tile: kTile x kTile entries
constexpr int kSmemLimit = 227 * 1024;  // what a block may use
constexpr int kWords = 32;              // the walk's dropped words, a lane each: L <= 1024

using lt::pairwise_key;

// Blocks an SM the register budget allows: four (64 registers a thread),
// but the Gram's and Wasserstein's keys need more without spilling
// (-Xptxas -v), so three (at most 85) for them.
constexpr int min_blocks(int met) { return met == lt::kIP || met == lt::kWasserstein ? 3 : 4; }

// The block's plan and its shared memory, the same on host and device.
struct Plan {
  int M, L, Mp, S, T, tiles, rounds, fill, DS, W;
  __host__ __device__ Plan(int L_, bool node, int DS_)
      : M(L_ + node), L(L_), DS(DS_), W((L_ + 31) / 32) {
    Mp = (M + kTile - 1) / kTile * kTile;
    S = (Mp / 4) % 2 ? Mp : Mp + 4;  // S / 4 odd: a warp's transposed copies hit 32 banks
    T = Mp / kTile;
    tiles = T * (T + 1) / 2;
    rounds = (tiles + kMaxThreads - 1) / kMaxThreads;
    fill = ((tiles + rounds - 1) / rounds + 31) / 32 * 32;
  }
  // the stage ring [2][DS][S], point keys [L rounded up to 4], the table
  // [M][M], the rows' ids [Mp], terms [4][M] and diagonal [M], the ranks'
  // candidates [L] and the candidates' ranks [L], dominance masks [L][W],
  // dropped flags [L]
  __host__ __device__ int bytes() const {
    return (2 * DS * S + (L + 3) / 4 * 4 + M * M + Mp + 5 * M + 2 * L + L * W) * 4 + L;
  }
};

// tile q of the upper triangle, row by row: (ti, tj) with ti <= tj < T
__device__ __forceinline__ void tile_of(int q, int T, int& ti, int& tj) {
  ti = 0;
  while (q >= T - ti) q -= T - ti++;
  tj = ti + q;
}

// One node's rows' ids and terms, then its table g: the upper triangle's
// tiles mirrored (Haversine: the whole table of keys). Every thread calls it.
template <int MET>
__device__ __forceinline__ void fill_table(const Plan& p, const float* __restrict__ x, int N, int D,
                                           const float* __restrict__ terms, const int* cand,
                                           int node, float* ring, float* g, int* ids, float* ta) {
  const int M = p.M, L = p.L, S = p.S, DS = p.DS, tid = threadIdx.x, F = blockDim.x;
  for (int i = tid; i < p.Mp; i += F) {
    const int id = min(max(i < L ? cand[i] : node, 0), N - 1);
    ids[i] = i < M ? id : 0;  // the padding rows read as zeros
    if (i >= M) continue;
    if constexpr (MET == lt::kHaversine) {
      const float* xy = x + 2 * (int64_t)id;
      const lt::GeoRow geo = lt::geo_row(__ldg(xy), __ldg(xy + 1));
      ta[i] = geo.lon;
      ta[M + i] = geo.lat;
      ta[2 * M + i] = geo.cos_lat;
      ta[3 * M + i] = geo.ok ? 1.f : 0.f;
    } else {
      const lt::RowTerm t = lt::row_term(terms, N, id);
      ta[i] = t.a;
      ta[M + i] = t.b;
      ta[2 * M + i] = t.inv ? 1.f : 0.f;
    }
  }
  __syncthreads();

  if constexpr (MET == lt::kHaversine) {  // D = 2: the whole table in one pass
    for (int e = tid; e < M * M; e += F) {
      const int i = e / M, j = e % M;
      const lt::GeoRow a{ta[i], ta[M + i], ta[2 * M + i], ta[3 * M + i] != 0.f};
      const lt::GeoRow b{ta[j], ta[M + j], ta[2 * M + j], ta[3 * M + j] != 0.f};
      g[e] = -lt::haversine(a, b);
    }
    __syncthreads();
  } else {
    // the flattened sequence of (round, stage): stage s into ring[s & 1];
    // a warp copies 4 rows x 8 dimensions at a time, its lanes' rows fixed
    const int nst = max((D + DS - 1) / DS, 1), total = p.rounds * nst, quads = p.Mp / 4;
    const int warp = tid >> 5, nwarps = F >> 5, ri = (tid & 31) >> 3, ci = tid & 7;
    auto load_stage = [&](int s) {
      const int d0 = (s % nst) * DS;
      float* dst = ring + (s & 1) * DS * S;
      for (int q4 = warp; q4 < quads; q4 += nwarps) {
        const int i = q4 * 4 + ri;
        const float* src = x + (int64_t)ids[i] * D + d0;
        for (int c = ci; c < DS; c += 8) {
          if (i < M && d0 + c < D) {
            lt::cp_async4(dst + c * S + i, src + c, 4);
          } else {
            dst[c * S + i] = 0.f;  // the padding rows and dimensions
          }
        }
      }
      lt::cp_async_commit();
    };
    using Acc = std::conditional_t<MET == lt::kIP, float, lt::Acc>;
    Acc acc[kTile][kTile];
    int ti = 0, tj = 0;
    bool live = false;
    load_stage(0);
    for (int s = 0; s < total; ++s) {
      if (s + 1 < total) {
        load_stage(s + 1);
        lt::cp_async_wait<1>();
      } else {
        lt::cp_async_wait<0>();
      }
      __syncthreads();
      const int st = s % nst;
      if (st == 0) {  // a round's first stage: its tile, from zero
        const int q = (s / nst) * F + tid;
        live = q < p.tiles;
        if (live) tile_of(q, p.T, ti, tj);
#pragma unroll
        for (int a = 0; a < kTile; ++a)
#pragma unroll
          for (int b = 0; b < kTile; ++b) acc[a][b] = Acc{};
      }
      if (live) {
        const float* rs = ring + (s & 1) * DS * S;
        const int dn = min(DS, D - st * DS);
        // Jensen-Shannon's logarithm rolled: unrolled, the stage outgrows the
        // instruction cache (K19's finding)
#pragma unroll (MET == lt::kJensenShannon ? 1 : 4)
        for (int c = 0; c < dn; ++c) {
          const float4 u4 = *reinterpret_cast<const float4*>(rs + c * S + ti * kTile);
          const float4 v4 = *reinterpret_cast<const float4*>(rs + c * S + tj * kTile);
          const float u[4] = {u4.x, u4.y, u4.z, u4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int b = 0; b < kTile; ++b) {
              if constexpr (MET == lt::kIP) {
                acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(u[a], v[b]));
              } else {
                lt::accumulate<MET>(acc[a][b], u[a], v[b]);
              }
            }
        }
        if (st == nst - 1) {  // the round's last stage: the tile into both halves
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int b = 0; b < kTile; ++b) {
              const int i = ti * kTile + a, j = tj * kTile + b;
              float v;
              if constexpr (MET == lt::kIP) {
                v = acc[a][b];
              } else {
                v = acc[a][b].a;
              }
              if (i <= j && j < M) g[i * M + j] = g[j * M + i] = v;
            }
        }
      }
      __syncthreads();  // ring[s & 1] is refilled by stage s + 2
    }
  }
}

// MET is how the table is filled: lt::kIP the Gram (IP, L2, cosine,
// correlation, Hellinger), an elementwise metric its accumulation,
// lt::kHaversine each pair's key. terms (3, N) [a; b; inv] are the domain
// metrics' per-row terms (null for L1, Chebyshev and Haversine).
template <int MET>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(MET))
    prune_kernel(const float* __restrict__ x, int N, int D, const float* __restrict__ terms,
                 const int* __restrict__ node_ids, const int* __restrict__ cand_ids, int L,
                 int DS, int metric, int r, float alpha, float ln_alpha, int descending,
                 int keys_only, int* __restrict__ out, float* __restrict__ point_out,
                 float* __restrict__ pair_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p(L, node_ids != nullptr, DS);
  const int M = p.M, W = p.W;
  const int L4 = (L + 3) / 4 * 4;
  float* ring = reinterpret_cast<float*>(smem);  // [2][DS][S]
  float* pk = ring + 2 * DS * p.S;               // [L4] (16-byte aligned)
  float* g = pk + L4;                            // [M][M]
  int* ids = reinterpret_cast<int*>(g + M * M);  // [Mp]
  float* ta = reinterpret_cast<float*>(ids + p.Mp);  // [4][M]
  float* dg = ta + 4 * M;                            // [M]
  int* order = reinterpret_cast<int*>(dg + M);       // [L]
  int* rank_of = order + L;                          // [L]
  unsigned* masks = reinterpret_cast<unsigned*>(rank_of + L);  // [L][W]
  uint8_t* pruned = reinterpret_cast<uint8_t*>(masks + L * W);  // [L]
  const int64_t bs = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int* cand = cand_ids + bs * L;
  const int node = node_ids ? node_ids[bs] : -1;
  fill_table<MET>(p, x, N, D, terms, cand, node, ring, g, ids, ta);
  if constexpr (MET != lt::kHaversine) {
    for (int i = tid; i < M; i += blockDim.x) dg[i] = g[i * M + i];
    __syncthreads();
  }
  // key(i, j) of row i (the query side) against row j, from the table
  auto key = [&](int i, int j) -> float {
    const float v = g[i * M + j];
    if constexpr (MET == lt::kHaversine) return v;
    if constexpr (MET == lt::kIP) {
      if (metric <= lt::kCosine) return pairwise_key(v, dg[i], dg[j], metric);
    }
    const lt::RowTerm qi{ta[i], ta[M + i], ta[2 * M + i] != 0.f};
    const lt::RowTerm xj{ta[j], ta[M + j], ta[2 * M + j] != 0.f};
    if constexpr (MET == lt::kIP) {
      return -lt::gemm_distance(metric, v, qi, xj);
    } else {
      return -lt::elem_distance<MET>(lt::Acc{v, 0.f}, qi, xj);
    }
  };

  if (keys_only) {  // a warp a row
    for (int i = warp; i < L; i += nwarps)
      for (int j = lane; j < L; j += 32) pair_out[(bs * L + i) * L + j] = key(i, j);
    if (node_ids)
      for (int j = tid; j < L; j += blockDim.x) point_out[bs * L + j] = key(L, j);
    return;
  }

  for (int j = tid; j < L4; j += blockDim.x) {
    const bool pad = j >= L, bad = pad || cand[j] < 0 || cand[j] == node;
    const float v = bad ? -INFINITY : key(L, j);
    if (!pad) pruned[j] = bad || !isfinite(v);
    pk[j] = isnan(v) ? -INFINITY : v;  // the padding never outranks a candidate
  }
  __syncthreads();
  for (int j = tid; j < L; j += blockDim.x) {  // a stable descending sort: ranks
    const float v = pk[j];
    int rank = 0;
    for (int u = 0; u < L; u += 4) {
      const float4 w = *reinterpret_cast<const float4*>(pk + u);
      rank += (w.x > v || (w.x == v && u < j)) + (w.y > v || (w.y == v && u + 1 < j)) +
              (w.z > v || (w.z == v && u + 2 < j)) + (w.w > v || (w.w == v && u + 3 < j));
    }
    order[rank] = j;
    rank_of[j] = rank;
  }
  __syncthreads();
  // the dominance masks in rank space, a warp a row: bit b of word w of the
  // mask of rank rank_of[i] is set where keeping candidate i drops the
  // candidate of rank 32 w + b
  for (int i = warp; i < L; i += nwarps) {
    unsigned* mi = masks + rank_of[i] * W;
    for (int w = 0; w < W; ++w) {
      const int rho = 32 * w + lane;
      bool dom = false;
      if (rho < L) {
        const int j = order[rho];
        const float pair = key(i, j);
        dom = descending ? pk[j] < __fsub_rn(pair, ln_alpha) : pk[j] < __fmul_rn(alpha, pair);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, dom);
      if (lane == 0) mi[w] = bits;
    }
  }
  __syncthreads();
  // the walk, one warp: lane w < W holds word w of the dropped ranks; a
  // ballot finds the first rank past the last decided one that is not
  // dropped, which is kept (while fewer than r are) and ORs in its mask
  if (warp == 0) {
    unsigned dropped = 0;
    for (int w = 0; w < W; ++w) {
      const int rho = 32 * w + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, rho >= L || pruned[order[rho]]);
      if (lane == w) dropped = bits;
    }
    int* kept_at = reinterpret_cast<int*>(pk);  // pk is read no more: the kept ranks
    int kept = 0, next = 0;                     // the ranks below `next` are decided
    while (kept < r) {
      const int lo = next - 32 * lane;  // this word's bits below lo are decided
      const unsigned open =
          lane < W ? ~dropped & (lo <= 0 ? ~0u : lo >= 32 ? 0u : ~0u << lo) : 0u;
      const unsigned words = __ballot_sync(0xffffffffu, open != 0);
      if (!words) break;
      const int w = __ffs(words) - 1;
      const int rho = 32 * w + __ffs(__shfl_sync(0xffffffffu, open, w)) - 1;
      if (lane == 0) kept_at[kept] = rho;
      ++kept;
      if (lane < W) dropped |= masks[rho * W + lane];
      next = rho + 1;
    }
    __syncwarp();
    int* o = out + bs * r;
    for (int k = lane; k < r; k += 32) o[k] = k < kept ? cand[order[kept_at[k]]] : -1;
  }
}

template <int MET>
int launch(const float* x, int N, int D, const float* terms, const int* node_ids,
           const int* cand_ids, int BS, int L, int metric, int r, float alpha, float ln_alpha,
           int descending, int keys_only, int* out, float* point_out, float* pair_out,
           cudaStream_t stream) {
  // the deepest stage that fits: 32 dimensions, fewer for a large M
  Plan p(L, node_ids != nullptr, MET == lt::kHaversine ? 0 : 32);
  while (p.bytes() > kSmemLimit && p.DS > 8) p = Plan(L, node_ids != nullptr, p.DS / 2);
  if (p.bytes() > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int threads = MET == lt::kHaversine ? kMaxThreads : p.fill;
  cudaError_t err = cudaFuncSetAttribute(prune_kernel<MET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes());
  if (err != cudaSuccess) return (int)err;
  prune_kernel<MET><<<BS, threads, p.bytes(), stream>>>(
      x, N, D, terms, node_ids, cand_ids, L, p.DS, metric, r, alpha, ln_alpha, descending,
      keys_only, out, point_out, pair_out);
  return (int)cudaGetLastError();
}

}  // namespace
// x (N, D) f32 rows (under a domain metric the lead rows of its transform),
// terms (3, N) its per-row terms or null; node_ids (BS,) and cand_ids (BS, L)
// int32; metric IP / L2 / cosine (0-2) or a domain metric's lt code. Prune
// mode: out (BS, r) int32. Keys mode: pair_out (BS, L, L) and, with node ids,
// point_out (BS, L).
extern "C" int lt_robust_prune(const float* x, int N, int D, const float* terms,
                               const int* node_ids, const int* cand_ids, int BS, int L,
                               int metric, int r, float alpha, float ln_alpha, int descending,
                               int keys_only, int* out, float* point_out, float* pair_out,
                               cudaStream_t stream) {
  if (N < 1 || D < 0 || BS < 1 || L < 1 ||
      (!keys_only && (r < 1 || L > 32 * kWords || !node_ids || !out)) ||
      (keys_only && !pair_out) || (keys_only && node_ids && !point_out))
    return (int)cudaErrorInvalidValue;
#define LT_PRUNE(MET)                                                                        \
  launch<MET>(x, N, D, terms, node_ids, cand_ids, BS, L, metric, r, alpha, ln_alpha,         \
              descending, keys_only, out, point_out, pair_out, stream)
  switch (metric) {
    case lt::kIP:
    case lt::kL2:
    case lt::kCosine:
    case lt::kCorrelation:
    case lt::kHellinger: return LT_PRUNE(lt::kIP);
    case lt::kL1: return LT_PRUNE(lt::kL1);
    case lt::kChebyshev: return LT_PRUNE(lt::kChebyshev);
    case lt::kWasserstein: return LT_PRUNE(lt::kWasserstein);
    case lt::kJensenShannon: return LT_PRUNE(lt::kJensenShannon);
    case lt::kHaversine: return D == 2 ? LT_PRUNE(lt::kHaversine) : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LT_PRUNE
}
