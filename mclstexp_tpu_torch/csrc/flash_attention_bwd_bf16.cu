// Flash-attention backward for Hopper (sm_90a), bfloat16: the bf16 branch of
// the two TPU kernels that csrc/flash_attention_bwd.cu ports in fp32
// (jax.experimental.pallas.ops.tpu.flash_attention, jax 0.9.0):
//   _flash_attention_bwd_dkv (pallas_call :1121, kernel :796) -> flash_bwd_dkv_bf16
//   _flash_attention_bwd_dq  (pallas_call :1456, kernel :1146) -> flash_bwd_dq_bf16
// reached through jax.grad with a bf16 compute dtype (mclstexp_tpu/core/
// layers.py:201-219).
//
// What the library kernels compute on bf16 inputs, and these too: s = q k^T
// and dp = dout v^T from bf16 operands with fp32 accumulation; p = exp(s -
// m) / l and ds = p * (dp - di) * scale in fp32 (l, m and di fp32); then p^T
// is cast to bf16 before p^T dout (:900), ds^T before ds^T q (:918) and ds
// before ds k (:1258); the sums stay fp32 over the whole walk (:1445) and
// dk, dv, dq are stored in bf16 once (:1094-1099, :1436).
//
// Design: csrc/flash_attention_bwd.cu's, with bf16 operands. One cluster of
// `split` CTAs per (batch*head, block of 32 keys) for dK/dV or of 32
// queries for dQ, sharing the walk over the other side's tiles; per walked
// tile each warp computes a 16 x 8 block of the two score products on the
// tensor cores (mma m16n8k16 over d), forms p and ds in fp32 registers and
// writes them to shared memory in bf16 (the library's casts); then each
// computes a 16 x D/4 block of the tile's share of its outputs (m16n8k16
// over the tile's 32 rows) and adds it to fp32 running sums. At the end the
// ranks' partial sums are added in rank order over distributed shared
// memory, in fp32, and written once in bf16: no atomics, the same bits on
// every run.
//
// Bound: at the training shape (1, 8, 128, 64) dK/dV moves 6*b*h*n*d bf16
// values and does 8*b*h*n^2*d operations, dQ 5*b*h*n*d values and
// 6*b*h*n^2*d operations: well under a microsecond each at 3.35 TB/s and
// 989 TFLOP/s, so a launch is bound by latency; at n = 4,096 the products.
//
// Any n >= 1, d <= 128, segment ids as in the fp32 kernels (kSeg). Inputs
// are read through strides (16-byte cp.async where d % 8 == 0 and the
// pointers and strides allow it, else 2-byte loads); l, m and di are
// contiguous fp32 (b, h, n); outputs are written through their strides.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bf16.cuh"
#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

namespace bf = flash::bf16;
using flash::invert_l;
using flash::kRows;
using flash::kThreads;
using flash::owned_ids;
using flash::stage_row_stats;
using flash::Strides;

constexpr int kSP = kRows + bf::kPad;  // row stride of a 32 x 32 bf16 score tile

// Rows [r0, r1) of this rank's share of a 32 x D block: the ranks' fp32
// partial blocks (row-major, width D, at `red` in each rank's shared
// memory) added in rank order and written once in bf16, rows below n,
// columns below d.
template <int D>
__device__ __forceinline__ void reduce_rows(cg::cluster_group& cluster, float* red, int split,
                                            uint16_t* out, long long stride, int row0, int n,
                                            int d) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * kRows / split, r1 = (rank + 1) * kRows / split;
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * kChunks; i += kThreads) {
    const int r = r0 + i / kChunks, c = (i % kChunks) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < split; ++src) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, src) + r * D + c);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (row0 + r < n) {
      uint16_t* o = out + (row0 + r) * stride + c;
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) o[e] = bf::from_float(v[e]);
    }
  }
}

template <int D>
struct Smem {
  static constexpr int kTile = bf::Tile<D>::kElems;  // bf16 values of a 32 x (D + 8) tile
  static constexpr int kScores = kRows * kSP;        // bf16 values of a 32 x 40 score tile
  // dK/dV: k, v (owned), 2 stages of q and dout, p and ds (bf16); 2 stages
  // of m, l, di, the dk and dv partial sums (32 x D each; fp32); segment ids
  // of 2 stages of queries. In floats:
  static constexpr int kDkv =
      (6 * kTile + 2 * kScores) / 2 + 2 * 3 * kRows + 2 * kRows * D + 2 * kRows;
  // dQ: q, dout (owned), 2 stages of k and v, ds (bf16); m, l, di of the
  // owned rows, the dq partial sums (fp32); segment ids of 2 stages of keys
  static constexpr int kDq = (6 * kTile + kScores) / 2 + 3 * kRows + kRows * D + 2 * kRows;
};

template <int D, bool kVec, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                       const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                       const float* __restrict__ l, const float* __restrict__ m,
                       const float* __restrict__ di, uint16_t* __restrict__ dk,
                       uint16_t* __restrict__ dv, const int* __restrict__ seg, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int heads,
                       int n, int d, int split, float scale) {
  constexpr int S = bf::Tile<D>::kStride;
  constexpr int T = Smem<D>::kTile, P = Smem<D>::kScores;
  constexpr int kCols = D / 4;   // output columns per warp
  constexpr int kN = kCols / 8;  // their 16 x 8 fragments
  extern __shared__ __align__(16) float smem[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* vs = ks + T;
  uint16_t* stage = vs + T;  // stage s: q at stage + 2sT, dout at + T
  uint16_t* ps = stage + 4 * T;  // 32 keys x 32 queries
  uint16_t* dss = ps + P;
  float* stats = reinterpret_cast<float*>(dss + P);  // stage s: m, 1/l, di at stats + 96s
  float* red = stats + 2 * 3 * kRows;                // dk partials, then dv partials
  int* walk_seg = reinterpret_cast<int*>(red + 2 * kRows * D);  // stage s: at walk_seg + 32s

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / split;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int k0 = blockIdx.y * kRows;
  const int tiles = (n + kRows - 1) / kRows;
  const int first = rank * tiles / split, last = (rank + 1) * tiles / split;
  const long long rb = static_cast<long long>(bh) * n;

  const uint16_t* qb = q + b * sq.b + h * sq.h;
  const uint16_t* dob = dout + b * sdo.b + h * sdo.h;
  const int* sb = kSeg ? seg + b * n : nullptr;
  bf::stage_rows<D, kVec>(ks, k + b * sk.b + h * sk.h, sk.n, k0, n, d);
  bf::stage_rows<D, kVec>(vs, v + b * sv.b + h * sv.h, sv.n, k0, n, d);
  auto stage_walk = [&](int tile, int s) {
    bf::stage_rows<D, kVec>(stage + 2 * s * T, qb, sq.n, tile * kRows, n, d);
    bf::stage_rows<D, kVec>(stage + 2 * s * T + T, dob, sdo.n, tile * kRows, n, d);
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
  const int2 key_seg = kSeg ? owned_ids(sb, k0 + m0 + g, n) : int2{0, 0};
  float acc_dk[kN][4] = {}, acc_dv[kN][4] = {};

  for (int it = first; it < last; ++it) {
    const int s = (it - first) & 1;
    if (it + 1 < last) stage_walk(it + 1, s ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // this tile's copies (the next tile's may fly)
    const uint16_t* qs = stage + 2 * s * T;
    const uint16_t* dos = qs + T;
    float* st = stats + 3 * kRows * s;
    const int* qseg = walk_seg + kRows * s;
    invert_l(st);
    __syncthreads();
    const int q0 = it * kRows;

    // s^T = k q^T and dp^T = v dout^T: the warp's 16 keys x 8 queries
    float sc[4] = {}, dp[4] = {};
#pragma unroll
    for (int e = 0; e < D; e += 16) {
      uint32_t a[4], bq[2];
      bf::load_a(a, ks, S, m0, e);
      bf::load_b_t(bq, qs, S, n0, e);
      bf::mma16(sc, a, bq);
      bf::load_a(a, vs, S, m0, e);
      bf::load_b_t(bq, dos, S, n0, e);
      bf::mma16(dp, a, bq);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + 8 * (i >> 1);  // key in the block
      const int c = n0 + 2 * t + (i & 1);   // query in the tile
      const float e = expf(sc[i] * scale - st[c]) * st[kRows + c];
      const bool ok = q0 + c < n && k0 + r < n &&
                      (!kSeg || (i < 2 ? key_seg.x : key_seg.y) == qseg[c]);
      const float p = ok ? e : 0.f;
      ps[r * kSP + c] = bf::from_float(p);
      dss[r * kSP + c] = bf::from_float(p * (dp[i] - st[2 * kRows + c]) * scale);
    }
    __syncthreads();

    // dv += p^T dout, dk += ds^T q over the tile's 32 queries
    float tv[kN][4] = {}, tk[kN][4] = {};
#pragma unroll
    for (int e = 0; e < kRows; e += 16) {
      uint32_t pa[4], da[4];
      bf::load_a(pa, ps, kSP, m0, e);
      bf::load_a(da, dss, kSP, m0, e);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t bo[2];
        bf::load_b(bo, dos, S, e, c0 + 8 * j);
        bf::mma16(tv[j], pa, bo);
        bf::load_b(bo, qs, S, e, c0 + 8 * j);
        bf::mma16(tk[j], da, bo);
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_dv[j][i] += tv[j][i];
        acc_dk[j][i] += tk[j][i];
      }
    __syncthreads();  // stage s and ps/dss are free
  }
  flash::cp_async_wait<0>();

  bf::store_acc<D, kN>(red, acc_dk, m0, c0);
  bf::store_acc<D, kN>(red + kRows * D, acc_dv, m0, c0);
  cluster.sync();
  reduce_rows<D>(cluster, red, split, dk + b * sdk.b + h * sdk.h, sdk.n, k0, n, d);
  reduce_rows<D>(cluster, red + kRows * D, split, dv + b * sdv.b + h * sdv.h, sdv.n, k0, n, d);
  cluster.sync();  // every rank's shared memory stays until all have read it
}

template <int D, bool kVec, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                      const float* __restrict__ l, const float* __restrict__ m,
                      const float* __restrict__ di, uint16_t* __restrict__ dq,
                      const int* __restrict__ seg, Strides sq, Strides sk, Strides sv,
                      Strides sdo, Strides sdq, int heads, int n, int d, int split,
                      float scale) {
  constexpr int S = bf::Tile<D>::kStride;
  constexpr int T = Smem<D>::kTile;
  constexpr int kCols = D / 4;
  constexpr int kN = kCols / 8;
  extern __shared__ __align__(16) float smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dos = qs + T;
  uint16_t* stage = dos + T;  // stage s: k at stage + 2sT, v at + T
  uint16_t* dss = stage + 4 * T;  // 32 queries x 32 keys
  float* stats = reinterpret_cast<float*>(dss + Smem<D>::kScores);  // m, 1/l, di of the owned rows
  float* red = stats + 3 * kRows;  // dq partials
  int* walk_seg = reinterpret_cast<int*>(red + kRows * D);  // stage s: at walk_seg + 32s

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / split;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int q0 = blockIdx.y * kRows;
  const int tiles = (n + kRows - 1) / kRows;
  const int first = rank * tiles / split, last = (rank + 1) * tiles / split;
  const long long rb = static_cast<long long>(bh) * n;

  const uint16_t* kb = k + b * sk.b + h * sk.h;
  const uint16_t* vb = v + b * sv.b + h * sv.h;
  const int* sb = kSeg ? seg + b * n : nullptr;
  bf::stage_rows<D, kVec>(qs, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
  bf::stage_rows<D, kVec>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, n, d);
  stage_row_stats(stats, m + rb, l + rb, di + rb, q0, n);
  auto stage_walk = [&](int tile, int s) {
    bf::stage_rows<D, kVec>(stage + 2 * s * T, kb, sk.n, tile * kRows, n, d);
    bf::stage_rows<D, kVec>(stage + 2 * s * T + T, vb, sv.n, tile * kRows, n, d);
    if constexpr (kSeg) flash::stage_ids(walk_seg + kRows * s, sb, tile * kRows, n, 3 * kRows);
  };
  if (first < last) stage_walk(first, 0);
  flash::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16;      // the warp's 16 queries of the block
  const int n0 = (warp >> 1) * 8;      // its 8 keys of the score tile
  const int c0 = (warp >> 1) * kCols;  // its columns of dq
  const int2 row_seg = kSeg ? owned_ids(sb, q0 + m0 + g, n) : int2{0, 0};
  float acc[kN][4] = {};

  for (int it = first; it < last; ++it) {
    const int s = (it - first) & 1;
    if (it + 1 < last) stage_walk(it + 1, s ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    const uint16_t* ks = stage + 2 * s * T;
    const uint16_t* vs = ks + T;
    const int* kseg = walk_seg + kRows * s;
    if (it == first) invert_l(stats);
    __syncthreads();
    const int kt0 = it * kRows;

    // s = q k^T and dp = dout v^T: the warp's 16 queries x 8 keys
    float sc[4] = {}, dp[4] = {};
#pragma unroll
    for (int e = 0; e < D; e += 16) {
      uint32_t a[4], bk[2];
      bf::load_a(a, qs, S, m0, e);
      bf::load_b_t(bk, ks, S, n0, e);
      bf::mma16(sc, a, bk);
      bf::load_a(a, dos, S, m0, e);
      bf::load_b_t(bk, vs, S, n0, e);
      bf::mma16(dp, a, bk);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + 8 * (i >> 1);  // query in the block
      const int c = n0 + 2 * t + (i & 1);   // key in the tile
      const float e = expf(sc[i] * scale - stats[r]) * stats[kRows + r];
      const bool ok = q0 + r < n && kt0 + c < n &&
                      (!kSeg || (i < 2 ? row_seg.x : row_seg.y) == kseg[c]);
      const float p = ok ? e : 0.f;
      dss[r * kSP + c] = bf::from_float(p * (dp[i] - stats[2 * kRows + r]) * scale);
    }
    __syncthreads();

    // dq += ds k over the tile's 32 keys
    float tq[kN][4] = {};
#pragma unroll
    for (int e = 0; e < kRows; e += 16) {
      uint32_t da[4];
      bf::load_a(da, dss, kSP, m0, e);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t bk[2];
        bf::load_b(bk, ks, S, e, c0 + 8 * j);
        bf::mma16(tq[j], da, bk);
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += tq[j][i];
    __syncthreads();
  }
  flash::cp_async_wait<0>();

  bf::store_acc<D, kN>(red, acc, m0, c0);
  cluster.sync();
  reduce_rows<D>(cluster, red, split, dq + b * sdq.b + h * sdq.h, sdq.n, q0, n, d);
  cluster.sync();
}

template <int D, bool kVec>
cudaError_t launch_dkv(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                       const uint16_t* dout, const float* l, const float* m, const float* di,
                       uint16_t* dk, uint16_t* dv, const int* seg, const Strides* s, int batch,
                       int heads, int n, int d, int split, float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return flash::launch_cluster<&flash_bwd_dkv_bf16<D, kVec, decltype(segments)::value>>(
        Smem<D>::kDkv, batch, heads, n, split, stream, q, k, v, dout, l, m, di, dk, dv, seg,
        s[0], s[1], s[2], s[3], s[4], s[5], heads, n, d, split, scale);
  });
}

template <int D, bool kVec>
cudaError_t launch_dq(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                      const uint16_t* dout, const float* l, const float* m, const float* di,
                      uint16_t* dq, const int* seg, const Strides* s, int batch, int heads, int n,
                      int d, int split, float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return flash::launch_cluster<&flash_bwd_dq_bf16<D, kVec, decltype(segments)::value>>(
        Smem<D>::kDq, batch, heads, n, split, stream, q, k, v, dout, l, m, di, dq, seg, s[0],
        s[1], s[2], s[3], s[4], heads, n, d, split, scale);
  });
}

}  // namespace

// As flash_attention_bwd_dkv_launch (csrc/flash_attention_bwd.cu), for
// bf16 q, k, v, dout, dk and dv; l, m and di stay fp32.
extern "C" int flash_attention_bwd_dkv_bf16_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dk, void* dv, const void* seg,
    const long long* strides, int batch, int heads, int n, int d, int rows, int split,
    float scale, void* stream) {
  if (!flash::plan_ok(batch, heads, n, d, rows, split))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int i = 0; i < 6; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* inputs[4] = {q, k, v, dout};
  const bool vec = flash::vec_ok(inputs, strides, 4, d, 8);
  return static_cast<int>(FLASH_DISPATCH(
      launch_dkv, vec, d, static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(di), static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
      static_cast<const int*>(seg), s, batch, heads, n, d, split, scale,
      static_cast<cudaStream_t>(stream)));
}

// As flash_attention_bwd_dq_launch, for bf16 q, k, v, dout and dq.
extern "C" int flash_attention_bwd_dq_bf16_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dq, const void* seg, const long long* strides,
    int batch, int heads, int n, int d, int rows, int split, float scale, void* stream) {
  if (!flash::plan_ok(batch, heads, n, d, rows, split))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[5];
  for (int i = 0; i < 5; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* inputs[4] = {q, k, v, dout};
  const bool vec = flash::vec_ok(inputs, strides, 4, d, 8);
  return static_cast<int>(FLASH_DISPATCH(
      launch_dq, vec, d, static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(di), static_cast<uint16_t*>(dq), static_cast<const int*>(seg), s,
      batch, heads, n, d, split, scale, static_cast<cudaStream_t>(stream)));
}
