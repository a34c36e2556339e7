// Flash-attention backward for Hopper (sm_90a), fp32: the gradients of
// out = softmax(q k^T * scale) v with respect to q, k and v. Replaces the two
// TPU kernels of jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0)
// that jax.grad reaches through the spot tower with attn_backend="flash"
// (mclstexp_tpu/core/layers.py:201-219):
//   _flash_attention_bwd_dkv (pallas_call :1121, kernel :796) -> flash_bwd_dkv
//   _flash_attention_bwd_dq  (pallas_call :1456, kernel :1146) -> flash_bwd_dq
//
// Both recompute the probabilities from the forward's residuals, the row max
// m and row sum l (csrc/flash_attention.cu), so no (n, n) matrix reaches
// device memory, and take di = rowsum(out * dout) from the caller (the JAX
// library computes it outside its kernels too, :273-275):
//   p  = exp(s - m) / l,    s = q k^T * scale
//   dp = dout v^T,          ds = p * (dp - di) * scale
//   dv = p^T dout,  dk = ds^T q,  dq = ds k
//
// Bound: at the training shape (b=1, h=8, n=128, d=64) dK/dV moves 6*b*h*n*d
// floats (1.6 MB) and does 8*b*h*n^2*d flops (67 MFLOP); dQ 5*b*h*n*d floats
// and 6*b*h*n^2*d flops. Each is about a microsecond at 3.35 TB/s or at the
// fp32 rate of 67 TFLOP/s, so at n <= 300 the kernels are bound by latency
// and the launch: how many CTAs share the walk, and how long each waits for
// its loads. At n = 4,096 the products rule.
//
// Design. The TPU kernels carry their sums across a sequential grid
// dimension in VMEM scratch. Here that dimension is split among `split`
// CTAs, which form one thread-block cluster:
//   flash_bwd_dkv: one cluster per (batch*head, block of 32 keys); rank r of
//     the cluster walks its share of the query tiles, tiles [r*T/split,
//     (r+1)*T/split) of T = ceil(n/32), and keeps partial dk, dv sums.
//   flash_bwd_dq: one cluster per (batch*head, block of 32 queries), the
//     same with the key tiles walked and dq summed.
// At the end each rank writes its partial sums to its own shared memory,
// the cluster syncs, and rank r adds up rows [r*32/split, (r+1)*32/split)
// of the block over the ranks' shared memory (distributed shared memory) in
// rank order 0, 1, ..., split-1, and writes them once. The reduction order
// is fixed, with no atomics and no scratch tensor: every run gives the same
// bits. `split` comes from the caller's plan (ops/flash_attention.cluster_plan:
// the smallest split, at most 8, that puts 132 CTAs on the card).
//
// Per walked tile of 32 rows, 8 warps: each computes a 16 x 8 block of the
// two 32 x 32 score products (s, dp) on the tensor cores, forms p and ds in
// fp32 registers and writes them to shared memory; then each computes a
// 16 x D/4 block of the tile's share of its outputs (p^T dout and ds^T q,
// or ds k) and adds it to its running sums with fp32 adds. Every product is
// mma.sync m16n8k8 in the 3xTF32 split (flash_common.cuh), so the sums keep
// fp32 accuracy; no tensor-core accumulation runs longer than a tile. Each
// value is split into its tf32 parts once, where it lands in shared memory
// (p and ds where they are formed), and fragments are read with ldmatrix.
// Tiles are staged by cp.async, 16 bytes at a time where d % 4 == 0 and the
// pointers and strides allow it, else 4 bytes; the next tile is loaded
// while this one is computed (two stages). Shared memory is dynamic: 99 KB
// (dK/dV) and 90 KB (dQ) at D = 64, 181 / 172 KB at D = 128.
//
// Segment ids (the TPU kernels' SegmentIds, masks at :861-891 and
// :1201-1224): given a non-null `seg`, a contiguous int32 (batch, n) array,
// p is 0 wherever the query's and the key's ids differ (the library adds
// its mask value to the logits instead, which gives the same 0 in fp32).
// As in the forward, each thread reads the ids of its two owned rows once
// (rows g and g + 8 of its fragment), and a walked tile's 32 ids are staged
// with the tile. The branch is a template variant (kSeg), so a null `seg`
// launches code without it.
//
// Any n >= 1: rows past n are zero-filled, masked out of p, and not
// written. Any d <= 128: the tile width D is 32, 64 or 128 and columns past
// d are zero-filled. Inputs are read through strides with the last
// dimension contiguous (the views of the qkv projection's (b, n, 3, h, d)
// buffer in place); l, m and di are contiguous (b, h, n); outputs are
// written through their strides.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::cp_async4;
using flash::kRows;
using flash::kThreads;
using flash::store_acc;
using flash::Strides;
using flash::tile_at;

// m, l and di of rows [r0, r0 + 32) of one head into dst[0..32), [32..64),
// [64..96); zero past n.
__device__ __forceinline__ void stage_row_stats(float* dst, const float* m, const float* l,
                                                const float* di, int r0, int n) {
  const int i = threadIdx.x;
  if (i < 3 * kRows) {
    const float* src = i < kRows ? m : (i < 2 * kRows ? l : di);
    const int r = r0 + i % kRows;
    cp_async4(dst + i, r < n ? src + r : src, r < n);
  }
}

template <int D, bool kVec>
__device__ __forceinline__ void stage_tile(float* hi, const float* src, long long stride, int r0,
                                           int n, int d) {
  flash::stage_rows<kRows, D, kThreads, kVec>(hi, src, stride, r0, n, d);
}

template <int D, bool kVec>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  flash::split_staged<kRows, D, kThreads, kVec>(hi, lo);
}

// The ids of owned rows i and i + 8 (0 past n: such rows are masked and
// not written).
__device__ __forceinline__ int2 owned_ids(const int* ids, int i, int n) {
  return int2{i < n ? ids[i] : 0, i + 8 < n ? ids[i + 8] : 0};
}

// l -> 1/l in staged row stats, by the threads that staged l (after their
// cp_async_wait): p is then one multiply. Rows past n give inf, masked.
__device__ __forceinline__ void invert_l(float* stats) {
  if (threadIdx.x >= kRows && threadIdx.x < 2 * kRows)
    stats[threadIdx.x] = 1.f / stats[threadIdx.x];
}

// Rows [r0, r1) of this rank's share of a 32 x D block: sum the ranks'
// partial blocks (tiles of width D in each rank's shared memory at `red`)
// in rank order and write rows that lie below n, columns below d.
template <int D>
__device__ __forceinline__ void reduce_rows(cg::cluster_group& cluster, float* red, int split,
                                            float* out, long long stride, int row0, int n,
                                            int d) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * kRows / split, r1 = (rank + 1) * kRows / split;
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * kChunks; i += kThreads) {
    const int r = r0 + i / kChunks, c = (i % kChunks) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < split; ++src) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, src) + tile_at<D>(r, c));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (row0 + r < n) {
      float* o = out + (row0 + r) * stride + c;
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) o[e] = v[e];
    }
  }
}

template <int D>
struct Smem {
  static constexpr int kTile = kRows * D;  // floats of a 32 x D tile
  static constexpr int kScores = kRows * kRows;
  // dK/dV: k, v (owned; big and small parts), 2 stages of q, dout, their
  // small parts, p and ds (big and small), 2 stages of m, l, di; segment
  // ids of 2 stages of queries (32 ints each)
  static constexpr int kDkv = 10 * kTile + 4 * kScores + 2 * 3 * kRows + 2 * kRows;
  // dQ: q, dout (owned; big and small), 2 stages of k, v, their small
  // parts, ds (big and small), m, l, di of the owned rows; segment ids of
  // 2 stages of keys
  static constexpr int kDq = 10 * kTile + 2 * kScores + 3 * kRows + 2 * kRows;
};

template <int D, bool kVec, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ l, const float* __restrict__ m,
                  const float* __restrict__ di, float* __restrict__ dk,
                  float* __restrict__ dv, const int* __restrict__ seg, Strides sq, Strides sk,
                  Strides sv, Strides sdo,
                  Strides sdk, Strides sdv, int heads, int n, int d, int split, float scale) {
  constexpr int T = Smem<D>::kTile, P = Smem<D>::kScores;
  constexpr int kCols = D / 4;  // output columns per warp
  constexpr int kN = kCols / 8;  // their 16 x 8 fragments
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;  // each tile's small parts follow it: ks + T, vs + T
  float* vs = ks + 2 * T;
  float* stage = vs + 2 * T;  // stage s: q at stage + 2sT, dout at + T
  float* q_lo = stage + 4 * T;
  float* do_lo = q_lo + T;
  float* ps = do_lo + T;  // 32 keys x 32 queries, then its small parts
  float* dss = ps + 2 * P;
  float* stats = dss + 2 * P;  // stage s: m, 1/l, di at stats + 96s
  int* walk_seg = reinterpret_cast<int*>(stats + 2 * 3 * kRows);  // stage s: at walk_seg + 32s

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / split;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int k0 = blockIdx.y * kRows;
  const int tiles = (n + kRows - 1) / kRows;
  const int first = rank * tiles / split, last = (rank + 1) * tiles / split;
  const long long rb = static_cast<long long>(bh) * n;  // l, m, di of this head

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const int* sb = kSeg ? seg + b * n : nullptr;  // this batch row's ids
  stage_tile<D, kVec>(ks, k + b * sk.b + h * sk.h, sk.n, k0, n, d);
  stage_tile<D, kVec>(vs, v + b * sv.b + h * sv.h, sv.n, k0, n, d);
  auto stage_walk = [&](int tile, int s) {
    stage_tile<D, kVec>(stage + 2 * s * T, qb, sq.n, tile * kRows, n, d);
    stage_tile<D, kVec>(stage + 2 * s * T + T, dob, sdo.n, tile * kRows, n, d);
    stage_row_stats(stats + 3 * kRows * s, m + rb, l + rb, di + rb, tile * kRows, n);
    if constexpr (kSeg) flash::stage_ids(walk_seg + kRows * s, sb, tile * kRows, n, 3 * kRows);
  };
  if (first < last) stage_walk(first, 0);
  flash::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16;      // the warp's 16 keys of the block
  const int n0 = (warp >> 1) * 8;      // its 8 queries of the score tile
  const int c0 = (warp >> 1) * kCols;  // its columns of dk and dv
  const int2 key_seg = kSeg ? owned_ids(sb, k0 + m0 + g, n) : int2{0, 0};  // keys g, g + 8
  const flash::Frag<D> fk = flash::frag_a<D>(m0);      // k, v rows
  const flash::Frag<D> fq = flash::frag_bt<D>(n0);     // q, dout rows
  const flash::Frag<kRows> fp = flash::frag_a<kRows>(m0);  // p, ds rows
  flash::FragB<D> fo[kN];  // q, dout columns of the output fragments
#pragma unroll
  for (int j = 0; j < kN; ++j) fo[j] = flash::FragB<D>(c0 + 8 * j);
  float acc_dk[kN][4] = {}, acc_dv[kN][4] = {};

  for (int it = first; it < last; ++it) {
    const int s = (it - first) & 1;
    if (it + 1 < last) stage_walk(it + 1, s ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // this tile's copies (the next tile's may fly)
    float* qs = stage + 2 * s * T;
    float* dos = qs + T;
    float* st = stats + 3 * kRows * s;
    const int* qseg = walk_seg + kRows * s;
    if (it == first) {
      split_tile<D, kVec>(ks, ks + T);
      split_tile<D, kVec>(vs, vs + T);
    }
    split_tile<D, kVec>(qs, q_lo);
    split_tile<D, kVec>(dos, do_lo);
    invert_l(st);
    __syncthreads();
    const int q0 = it * kRows;

    // s^T = k q^T and dp^T = v dout^T: the warp's 16 keys x 8 queries
    float sc[3][4] = {}, dp[3][4] = {};
#pragma unroll
    for (int e = 0; e < D; e += 8) {
      flash::mma_3xtf32(sc, flash::load_a(ks, ks + T, fk, e), flash::load_b_t(qs, q_lo, fq, e));
      flash::mma_3xtf32(dp, flash::load_a(vs, vs + T, fk, e), flash::load_b_t(dos, do_lo, fq, e));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + 8 * (i >> 1);  // key in the block
      const int c = n0 + 2 * t + (i & 1);   // query in the tile
      const float e = expf(flash::sum3(sc, i) * scale - st[c]) * st[kRows + c];
      const bool ok = q0 + c < n && k0 + r < n &&
                      (!kSeg || (i < 2 ? key_seg.x : key_seg.y) == qseg[c]);
      const float p = ok ? e : 0.f;
      const int at = tile_at<kRows>(r, c);
      flash::split_tf32(p, ps[at], ps[P + at]);
      flash::split_tf32(p * (flash::sum3(dp, i) - st[2 * kRows + c]) * scale, dss[at],
                        dss[P + at]);
    }
    __syncthreads();

    // dv += p^T dout, dk += ds^T q over the tile's 32 queries
    float tv[kN][3][4] = {}, tk[kN][3][4] = {};
#pragma unroll
    for (int e = 0; e < kRows; e += 8) {
      const flash::Split<4> pa = flash::load_a(ps, ps + P, fp, e);
      const flash::Split<4> da = flash::load_a(dss, dss + P, fp, e);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        flash::mma_3xtf32(tv[j], pa, flash::load_b(dos, do_lo, fo[j], e));
        flash::mma_3xtf32(tk[j], da, flash::load_b(qs, q_lo, fo[j], e));
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_dv[j][i] += flash::sum3(tv[j], i);
        acc_dk[j][i] += flash::sum3(tk[j], i);
      }
    __syncthreads();  // stage s, the small parts and ps/dss are free
  }
  flash::cp_async_wait<0>();

  // The stage area holds the partial sums now (no thread reads it anymore).
  store_acc<D, kN>(stage, acc_dk, m0, c0);
  store_acc<D, kN>(stage + T, acc_dv, m0, c0);
  cluster.sync();
  reduce_rows<D>(cluster, stage, split, dk + b * sdk.b + h * sdk.h, sdk.n, k0, n, d);
  reduce_rows<D>(cluster, stage + T, split, dv + b * sdv.b + h * sdv.h, sdv.n, k0, n, d);
  cluster.sync();  // every rank's shared memory stays until all have read it
}

template <int D, bool kVec, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ l, const float* __restrict__ m,
                 const float* __restrict__ di, float* __restrict__ dq,
                 const int* __restrict__ seg, Strides sq, Strides sk, Strides sv, Strides sdo,
                 Strides sdq, int heads, int n, int d, int split, float scale) {
  constexpr int T = Smem<D>::kTile, P = Smem<D>::kScores;
  constexpr int kCols = D / 4;
  constexpr int kN = kCols / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // each tile's small parts follow it: qs + T, dos + T
  float* dos = qs + 2 * T;
  float* stage = dos + 2 * T;  // stage s: k at stage + 2sT, v at + T
  float* k_lo = stage + 4 * T;
  float* v_lo = k_lo + T;
  float* dss = v_lo + T;  // 32 queries x 32 keys, then its small parts
  float* stats = dss + 2 * P;  // m, 1/l, di of the owned queries
  int* walk_seg = reinterpret_cast<int*>(stats + 3 * kRows);  // stage s: at walk_seg + 32s

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / split;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int q0 = blockIdx.y * kRows;
  const int tiles = (n + kRows - 1) / kRows;
  const int first = rank * tiles / split, last = (rank + 1) * tiles / split;
  const long long rb = static_cast<long long>(bh) * n;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int* sb = kSeg ? seg + b * n : nullptr;  // this batch row's ids
  stage_tile<D, kVec>(qs, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
  stage_tile<D, kVec>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, n, d);
  stage_row_stats(stats, m + rb, l + rb, di + rb, q0, n);
  auto stage_walk = [&](int tile, int s) {
    stage_tile<D, kVec>(stage + 2 * s * T, kb, sk.n, tile * kRows, n, d);
    stage_tile<D, kVec>(stage + 2 * s * T + T, vb, sv.n, tile * kRows, n, d);
    if constexpr (kSeg) flash::stage_ids(walk_seg + kRows * s, sb, tile * kRows, n, 3 * kRows);
  };
  if (first < last) stage_walk(first, 0);
  flash::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16;      // the warp's 16 queries of the block
  const int n0 = (warp >> 1) * 8;      // its 8 keys of the score tile
  const int c0 = (warp >> 1) * kCols;  // its columns of dq
  const int2 row_seg = kSeg ? owned_ids(sb, q0 + m0 + g, n) : int2{0, 0};  // rows g, g + 8
  const flash::Frag<D> fq = flash::frag_a<D>(m0);      // q, dout rows
  const flash::Frag<D> fk = flash::frag_bt<D>(n0);     // k, v rows
  const flash::Frag<kRows> fs = flash::frag_a<kRows>(m0);  // ds rows
  flash::FragB<D> fo[kN];  // k columns of the output fragments
#pragma unroll
  for (int j = 0; j < kN; ++j) fo[j] = flash::FragB<D>(c0 + 8 * j);
  float acc[kN][4] = {};

  for (int it = first; it < last; ++it) {
    const int s = (it - first) & 1;
    if (it + 1 < last) stage_walk(it + 1, s ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    float* ks = stage + 2 * s * T;
    float* vs = ks + T;
    const int* kseg = walk_seg + kRows * s;
    if (it == first) {
      split_tile<D, kVec>(qs, qs + T);
      split_tile<D, kVec>(dos, dos + T);
      invert_l(stats);
    }
    split_tile<D, kVec>(ks, k_lo);
    split_tile<D, kVec>(vs, v_lo);
    __syncthreads();
    const int kt0 = it * kRows;

    // s = q k^T and dp = dout v^T: the warp's 16 queries x 8 keys
    float sc[3][4] = {}, dp[3][4] = {};
#pragma unroll
    for (int e = 0; e < D; e += 8) {
      flash::mma_3xtf32(sc, flash::load_a(qs, qs + T, fq, e), flash::load_b_t(ks, k_lo, fk, e));
      flash::mma_3xtf32(dp, flash::load_a(dos, dos + T, fq, e), flash::load_b_t(vs, v_lo, fk, e));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + 8 * (i >> 1);  // query in the block
      const int c = n0 + 2 * t + (i & 1);   // key in the tile
      const float e = expf(flash::sum3(sc, i) * scale - stats[r]) * stats[kRows + r];
      const bool ok = q0 + r < n && kt0 + c < n &&
                      (!kSeg || (i < 2 ? row_seg.x : row_seg.y) == kseg[c]);
      const float p = ok ? e : 0.f;
      const int at = tile_at<kRows>(r, c);
      flash::split_tf32(p * (flash::sum3(dp, i) - stats[2 * kRows + r]) * scale, dss[at],
                        dss[P + at]);
    }
    __syncthreads();

    // dq += ds k over the tile's 32 keys
    float tq[kN][3][4] = {};
#pragma unroll
    for (int e = 0; e < kRows; e += 8) {
      const flash::Split<4> da = flash::load_a(dss, dss + P, fs, e);
#pragma unroll
      for (int j = 0; j < kN; ++j) flash::mma_3xtf32(tq[j], da, flash::load_b(ks, k_lo, fo[j], e));
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += flash::sum3(tq[j], i);
    __syncthreads();
  }
  flash::cp_async_wait<0>();

  store_acc<D, kN>(stage, acc, m0, c0);
  cluster.sync();
  reduce_rows<D>(cluster, stage, split, dq + b * sdq.b + h * sdq.h, sdq.n, q0, n, d);
  cluster.sync();
}

template <int D, bool kVec>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* l, const float* m, const float* di, float* dk, float* dv,
                       const int* seg, const Strides* s, int batch, int heads, int n, int d,
                       int split, float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return flash::launch_cluster<&flash_bwd_dkv<D, kVec, decltype(segments)::value>>(
        Smem<D>::kDkv, batch, heads, n, split, stream, q, k, v, dout, l, m, di, dk, dv, seg,
        s[0], s[1], s[2], s[3], s[4], s[5], heads, n, d, split, scale);
  });
}

template <int D, bool kVec>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* l, const float* m, const float* di, float* dq,
                      const int* seg, const Strides* s, int batch, int heads, int n, int d,
                      int split, float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return flash::launch_cluster<&flash_bwd_dq<D, kVec, decltype(segments)::value>>(
        Smem<D>::kDq, batch, heads, n, split, stream, q, k, v, dout, l, m, di, dq, seg, s[0],
        s[1], s[2], s[3], s[4], heads, n, d, split, scale);
  });
}

}  // namespace

// q, k, v, dout: device fp32 buffers read as (batch, heads, n, d) through
// the given element strides (3 per tensor: batch, head, row; the last
// dimension contiguous); l, m, di: contiguous fp32 (batch, heads, n); dk,
// dv: written as (batch, heads, n, d) through their strides; seg: null, or
// contiguous int32 (batch, n) segment ids. 1 <= d <= 128, n >= 1. The
// plan: rows per tile (32) and the split of the walked side (1..8, at most
// ceil(n/32)). Launches once on `stream` and returns the
// launch's error or cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dk, void* dv, const void* seg,
    const long long* strides, int batch, int heads, int n, int d, int rows, int split,
    float scale, void* stream) {
  if (!flash::plan_ok(batch, heads, n, d, rows, split))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int i = 0; i < 6; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* inputs[4] = {q, k, v, dout};
  const bool vec = flash::vec_ok(inputs, strides, 4, d);
  return static_cast<int>(FLASH_DISPATCH(
      launch_dkv, vec, d, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(seg), s, batch, heads, n, d, split, scale,
      static_cast<cudaStream_t>(stream)));
}

// The same inputs, segment ids and plan; dq written as (batch, heads, n, d)
// through its strides (5 stride triples: q, k, v, dout, dq).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dq, const void* seg, const long long* strides,
    int batch, int heads, int n, int d, int rows, int split, float scale, void* stream) {
  if (!flash::plan_ok(batch, heads, n, d, rows, split))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[5];
  for (int i = 0; i < 5; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* inputs[4] = {q, k, v, dout};
  const bool vec = flash::vec_ok(inputs, strides, 4, d);
  return static_cast<int>(FLASH_DISPATCH(
      launch_dq, vec, d, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(di), static_cast<float*>(dq), static_cast<const int*>(seg), s,
      batch, heads, n, d, split, scale, static_cast<cudaStream_t>(stream)));
}
