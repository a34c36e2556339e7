// Flash-attention forward for Hopper (sm_90a), fp32. Replaces the TPU kernel
// that the spot tower reaches with attn_backend="flash":
// jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0; flash_attention
// :140 -> _flash_attention_impl :589 -> pallas_call :758, kernel
// _flash_attention_kernel_single_batch :342-481), called at
// mclstexp_tpu/core/layers.py:201-219.
//
//   out[b, i, h, :] = sum_j softmax_j(q[b, h, i, :] . k[b, h, j, :] * scale) v[b, h, j, :]
//
// What it computes is the TPU kernel's function: an online softmax over key
// tiles, so no (n, n) matrix ever reaches device memory, with running max
// and sum in fp32 and the output normalized once at the end.
//
// Segment ids (the TPU kernel's SegmentIds(q=m, kv=m), built from a padded
// slide's mask at mclstexp_tpu/core/layers.py:207-212; its mask at :412-424):
// given a non-null `seg`, a contiguous int32 (batch, n) array, query i sees
// key j only where seg[b][i] == seg[b][j]. Each thread reads the ids of its
// two accumulator rows once; a tile's 32 key ids are staged with its K tile.
// The predicate of a score is then per (row, key): key < n and the ids
// equal. The branch is a template variant (kSeg), so a null `seg` launches
// code without it (a run-time test cost the unmasked launch 4-8%; PERF.md
// section 6). With segments a whole key group, or a whole cluster rank's share
// of the walk, can see no valid key for a row (a padded row's rank that
// walks only real keys): its (m, l) stays (-inf, 0) and it weighs 0 in both
// merges (`weight`), never NaN. Every row sees at least itself, so no row
// is left empty.
//
// Residuals: given non-null `l_out` and `m_out`, the kernel also writes each
// row's max m and sum l = sum_j exp(s_j - m) as contiguous fp32 (b, h, n)
// arrays, what the TPU kernel keeps with save_residuals for its backward
// (csrc/flash_attention_bwd.cu recomputes p = exp(s - m) / l from them).
// With null pointers it writes the output only.
//
// Bound: 4*b*h*n^2*d flops against 4*b*h*n*d floats moved (q, k, v read,
// out written). At the spot tower's shapes (b=1, h=8, d=64; n=32 on the
// eval sweep, 128 at train) both take under a microsecond at 67 TFLOP/s
// (fp32) and 3.35 TB/s, so a launch is bound by latency: how many CTAs share
// the work and how long each waits for its loads. At n = 4,096 (the
// baselines' whole-slide sequences) the products rule: 68.7 GFLOP at
// (1, 16, 4096, 64).
//
// Design. The TPU kernel carries m, l and the output block in VMEM scratch
// across a sequential grid dimension over key blocks. Here each block of 32
// queries is one thread-block cluster of `split` CTAs, and rank r walks key
// tiles [r*T/split, (r+1)*T/split) of T = ceil(n/32) (the caller's plan,
// ops/flash_attention.cluster_plan: the smallest split, at most 8, that
// puts 132 CTAs on the card). Every rank's share holds a valid key: only the
// last tile is ragged.
//
// Per walked tile of 32 keys, 8 warps: warp w owns queries 16*(w & 1).. and
// keys 8*(w >> 1).. of the tile (its key group), and computes that 16 x 8
// block of s = q k^T on the tensor cores; it keeps its own running max and
// sum per row over the keys of its group, turns its scores into p in fp32
// registers, moves p into mma's A layout with quad shuffles, and adds p v
// over its 8 keys (16 x D) to its own running output after the rescale.
// A warp thus never waits for another within a tile: one barrier per tile,
// after the tile's K and V land. Every product is mma.sync m16n8k8 in the
// 3xTF32 split (flash_common.cuh) with three accumulators, no tensor-core
// chain longer than a tile, tiles added with fp32 adds. Q is split into its
// tf32 parts once, where it lands in shared memory; K and V stay raw there
// and each fragment is split in registers where it is read (each value by
// the two warps that read it), and p is split in registers. At long
// sequences shared-memory traffic bounds a tile, and split K and V tiles
// would more than double it (the split pass, and big and small reads).
// Scores are kept in log2 units (scale * log2(e) folded into the scale), so
// each exponential is one exp2; m is written back in natural units. Q is
// staged once, K and V in two stages by cp.async, 16 bytes at a time where
// d % 4 == 0 and the pointers and strides allow it, else 4 bytes; the next
// tile loads while this one is computed.
//
// Merge, in a fixed order (no atomics, no scratch tensor, the same bits on
// every run): the 4 key groups' (m, l, out) of each row are merged in group
// order into the rank's (m_r, l_r, acc_r) in its own shared memory:
//   m = max_i m_i,  l = sum_i l_i exp(m_i - m),  acc = sum_i acc_i exp(m_i - m);
// then, after cluster.sync(), rank r merges rows [r*32/split, (r+1)*32/split)
// over the ranks' shared memory (distributed shared memory) in rank order
// 0..split-1 by the same formulas and writes out = acc / l once (and l and m
// when asked); a last cluster.sync() keeps each rank's shared memory alive
// until all have read it. With split 1 the rank's merge writes the output.
// A group that has seen no valid key (m = -inf) weighs 0, never NaN.
//
// Any n >= 1: keys past n are masked, rows past n are not written. Any
// d <= 128: the tile width D is 32, 64 or 128 and columns past d are
// zero-filled. q, k, v are read through strides (the three views of the
// qkv projection's (b, n, 3, h, d) buffer in place); the output is written
// through its strides (the wrapper's (b, n, h, d) buffer). Dynamic shared
// memory: 6 tiles of 32 x D (q and its small parts, two stages of k and v)
// and the row stats: 25 / 49 / 97 KB at D = 32 / 64 / 128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::kRows;
using flash::kThreads;
using flash::Strides;
using flash::tile_at;

constexpr int kGroups = kThreads / 32 / 2;  // key groups of 8 keys: 4 warps per 16 rows
constexpr float kLog2e = 1.4426950408889634f;  // scores in log2 units: exp(x) = exp2(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int kTile = kRows * D;  // floats of a 32 x D tile
  // q (big and small parts), 2 stages of k and v (raw), the key groups' m
  // and l (4 x 32 each), the rank's m and l (32 each), 2 stages of the
  // walked keys' segment ids (32 ints each)
  static constexpr int kFloats = 6 * kTile + 2 * kGroups * kRows + 2 * kRows + 2 * kRows;
};

// B fragments of p v over a warp's 8 keys n0.. (B[k][c] = v[n0 + k][c0 + c]):
// rows n0 + t and n0 + t + 4, column c0 + g of a raw tile of width D, split
// in registers. The
// row swizzle of n0 + t is that of t (n0 a multiple of 8) and the XOR
// touches column bits 2-4 only, so four offsets per row serve every c0 (a
// multiple of 8): the fragment sits at o[(c0 >> 3) & 3] + (c0 & ~31).
template <int D>
struct FragV {
  int o0[4], o1[4];
  __device__ __forceinline__ explicit FragV(int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o0[j] = tile_at<D>(n0 + t, 8 * j + g);
      o1[j] = tile_at<D>(n0 + t + 4, 8 * j + g);
    }
  }
  __device__ __forceinline__ flash::Split<2> load(const float* tile, int c0) const {
    const int a0 = o0[(c0 >> 3) & 3] + (c0 & ~31), a1 = o1[(c0 >> 3) & 3] + (c0 & ~31);
    return flash::split_pair(tile[a0], tile[a1]);
  }
};

// exp(m_i - m) for maxima in log2 units: the weight of a partial (m_i, l_i,
// acc_i) in a merge to max m; 0 for a part that saw no valid key.
__device__ __forceinline__ float weight(float m_i, float m) {
  return m_i == -INFINITY ? 0.f : exp2f(m_i - m);
}

template <int D, bool kVec, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ l_out,
              float* __restrict__ m_out, const int* __restrict__ seg, Strides sq, Strides sk,
              Strides sv, Strides so, int heads, int n, int d, int split, float scale) {
  constexpr int T = Smem<D>::kTile;
  constexpr int kN = D / 8;  // the warp's 16 x 8 output fragments: all D columns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // q; its small parts at qs + T
  float* stage = qs + 2 * T;       // stage s: k at stage + 2sT, v at + T
  float* group_m = stage + 4 * T;  // m of key group j at group_m + 32j; l at group_l + 32j
  float* group_l = group_m + kGroups * kRows;
  float* rank_ml = group_l + kGroups * kRows;  // the rank's m (32), then l (32)
  int* key_seg = reinterpret_cast<int*>(rank_ml + 2 * kRows);  // stage s at key_seg + 32s

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / split;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int q0 = blockIdx.y * kRows;
  const int tiles = (n + kRows - 1) / kRows;
  const int first = rank * tiles / split, last = (rank + 1) * tiles / split;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int* sb = kSeg ? seg + b * n : nullptr;  // this batch row's ids
  flash::stage_rows<kRows, D, kThreads, kVec>(qs, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
  auto stage_walk = [&](int tile, int s) {
    float* st = stage + 2 * s * T;
    flash::stage_rows<kRows, D, kThreads, kVec>(st, kb, sk.n, tile * kRows, n, d);
    flash::stage_rows<kRows, D, kThreads, kVec>(st + T, vb, sv.n, tile * kRows, n, d);
    if constexpr (kSeg) flash::stage_ids(key_seg + kRows * s, sb, tile * kRows, n, 0);
  };
  if (first < last) stage_walk(first, 0);
  flash::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int m0 = (warp & 1) * 16;  // the warp's 16 queries of the block
  const int grp = warp >> 1;       // its key group: keys n0.. of every tile
  const int n0 = grp * 8;
  const flash::Frag<D> fq = flash::frag_a<D>(m0);   // q rows
  const flash::Frag<D> fk = flash::frag_bt<D>(n0);  // k rows
  const FragV<D> fv(n0);
  // p's A fragment (rows g, g + 8; columns t, t + 4 of the 8 keys) from the
  // score fragment (columns 2t, 2t + 1): column c lies in lane c / 2 of the
  // quad, element c % 2
  const int src_a = (lane & ~3) | (t >> 1), src_b = src_a + 2;
  const bool odd = t & 1;
  int row_seg[2] = {0, 0};  // the ids of rows g and g + 8
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + m0 + (lane >> 2) + 8 * r;
      row_seg[r] = qi < n ? sb[qi] : 0;  // rows past n are not written
    }
  }

  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8: running max over the group's keys
  float l[2] = {0.f, 0.f};              // this lane's part of the running sum
  float acc[kN][4] = {};

  for (int it = first; it < last; ++it) {
    const int s = (it - first) & 1;
    float* ks = stage + 2 * s * T;
    float* vs = ks + T;
    flash::cp_async_wait<0>();  // this tile's copies (and q's on the first)
    if (it == first) flash::split_staged<kRows, D, kThreads, kVec>(qs, qs + T);
    __syncthreads();  // the tile landed, and every warp is done with the other stage
    if (it + 1 < last) stage_walk(it + 1, s ^ 1);
    flash::cp_async_commit();

    // s = q k^T * scale * log2(e): the warp's 16 queries x 8 keys
    float sc[3][4] = {};
#pragma unroll
    for (int e = 0; e < D; e += 8)
      flash::mma_3xtf32(sc, flash::load_a(qs, qs + T, fq, e), flash::load_b_t_raw(ks, fk, e));
    const int key = it * kRows + n0 + 2 * t;  // the key of elements 0 and 2; +1 for 1 and 3
    const int* ks_seg = key_seg + kRows * s + n0 + 2 * t;
    float p[4], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g, g + 8
      const bool ok0 = key < n && (!kSeg || ks_seg[0] == row_seg[r]);
      const bool ok1 = key + 1 < n && (!kSeg || ks_seg[1] == row_seg[r]);
      const float s0 = flash::sum3(sc, 2 * r) * scale2, s1 = flash::sum3(sc, 2 * r + 1) * scale2;
      float mx = fmaxf(ok0 ? s0 : -INFINITY, ok1 ? s1 : -INFINITY);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = weight(m[r], m_new);
      p[2 * r] = ok0 ? exp2f(s0 - m_new) : 0.f;
      p[2 * r + 1] = ok1 ? exp2f(s1 - m_new) : 0.f;
      l[r] = l[r] * alpha[r] + (p[2 * r] + p[2 * r + 1]);
      m[r] = m_new;
    }
    flash::Split<4> pa;
    {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = __shfl_sync(0xffffffffu, p[i], src_a);
        y[i] = __shfl_sync(0xffffffffu, p[i], src_b);
      }
      const float a[4] = {odd ? x[1] : x[0], odd ? x[3] : x[2], odd ? y[1] : y[0],
                          odd ? y[3] : y[2]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float big, small;
        flash::split_tf32(a[i], big, small);
        pa.big[i] = __float_as_uint(big);
        pa.small[i] = __float_as_uint(small);
      }
    }

    // out = out * alpha + p v over the group's 8 keys, all D columns
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float tv[3][4] = {};
      flash::mma_3xtf32(tv, pa, fv.load(vs, 8 * j));
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acc[j][i] * alpha[i >> 1] + flash::sum3(tv, i);
    }
  }
  flash::cp_async_wait<0>();

  // the row sums over the quad's lanes (each holds two keys of a tile)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // no warp reads the stages anymore: they take the groups' outputs (4T)
  flash::store_acc<D, kN>(stage + grp * T, acc, m0, 0);
  if (t == 0) {
    const int g = lane >> 2;
    group_m[grp * kRows + m0 + g] = m[0];
    group_m[grp * kRows + m0 + g + 8] = m[1];
    group_l[grp * kRows + m0 + g] = l[0];
    group_l[grp * kRows + m0 + g + 8] = l[1];
  }
  __syncthreads();

  const long long rb = static_cast<long long>(bh) * n;  // l, m of this head
  float* ob = out + b * so.b + h * so.h;
  // out = acc / l for row r, columns c..c+3 (rows below n, columns below d);
  // m back in natural units
  auto write = [&](int r, int c, float4 x, float lr, float mr) {
    const int qi = q0 + r;
    if (qi >= n) return;
    float* o = ob + qi * so.n + c;
    const float val[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) o[e] = val[e] / lr;
    if (l_out != nullptr && c == 0) {
      l_out[rb + qi] = lr;
      m_out[rb + qi] = mr * kLn2;
    }
  };

  // The key groups merged in group order: the rank's (m, l, acc) of each row.
  constexpr int kChunks = D / 4;
  float* acc_r = qs;  // q is no longer read
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float mr = -INFINITY;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) mr = fmaxf(mr, group_m[j * kRows + r]);
    float lr = 0.f;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float w = weight(group_m[j * kRows + r], mr);
      const float4 y = *reinterpret_cast<const float4*>(stage + j * T + tile_at<D>(r, c));
      lr += group_l[j * kRows + r] * w;
      x.x += y.x * w;
      x.y += y.y * w;
      x.z += y.z * w;
      x.w += y.w * w;
    }
    if (split == 1) {
      write(r, c, x, lr, mr);
    } else {
      *reinterpret_cast<float4*>(acc_r + tile_at<D>(r, c)) = x;
      if (c == 0) {
        rank_ml[r] = mr;
        rank_ml[kRows + r] = lr;
      }
    }
  }
  if (split == 1) return;

  // The ranks merged in rank order: rows [rank*32/split, (rank+1)*32/split).
  cluster.sync();
  const int r0 = rank * kRows / split, r1 = (rank + 1) * kRows / split;
  for (int i = threadIdx.x; i < (r1 - r0) * kChunks; i += kThreads) {
    const int r = r0 + i / kChunks, c = (i % kChunks) * 4;
    float mr = -INFINITY;
    for (int src = 0; src < split; ++src)
      mr = fmaxf(mr, cluster.map_shared_rank(rank_ml, src)[r]);
    float lr = 0.f;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < split; ++src) {
      const float* ml = cluster.map_shared_rank(rank_ml, src);
      const float w = weight(ml[r], mr);
      const float4 y =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(acc_r, src) + tile_at<D>(r, c));
      lr += ml[kRows + r] * w;
      x.x += y.x * w;
      x.y += y.y * w;
      x.z += y.z * w;
      x.w += y.w * w;
    }
    write(r, c, x, lr, mr);
  }
  cluster.sync();  // every rank's shared memory stays until all have read it
}

template <int D, bool kVec>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* out, float* l_out,
                       float* m_out, const int* seg, const Strides* s, int batch, int heads, int n,
                       int d, int split, float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return flash::launch_cluster<&flash_fwd<D, kVec, decltype(segments)::value>>(
        Smem<D>::kFloats, batch, heads, n, split, stream, q, k, v, out, l_out, m_out, seg, s[0],
        s[1], s[2], s[3], heads, n, d, split, scale);
  });
}

}  // namespace

// q, k, v: device fp32 buffers read as (batch, heads, n, d) through the
// given element strides (3 per tensor: batch, head, row; the last dimension
// contiguous); out: written as (batch, heads, n, d) through its strides (the
// fourth triple); l_out, m_out: null, or both contiguous fp32 (batch, heads,
// n) buffers for the residuals; seg: null, or contiguous int32 (batch, n)
// segment ids. 1 <= d <= 128, n >= 1. The plan: rows per query block (32)
// and the split of the key walk (1..8, at most ceil(n/32)).
// Launches once on `stream` and returns the launch's error or
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                          void* l_out, void* m_out, const void* seg,
                                          const long long* strides,
                                          int batch, int heads, int n, int d, int rows, int split,
                                          float scale, void* stream) {
  if (!flash::plan_ok(batch, heads, n, d, rows, split) || (l_out == nullptr) != (m_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* inputs[3] = {q, k, v};
  const bool vec = flash::vec_ok(inputs, strides, 3, d);
  return static_cast<int>(FLASH_DISPATCH(
      launch_fwd, vec, d, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(l_out),
      static_cast<float*>(m_out), static_cast<const int*>(seg), s, batch, heads, n, d, split,
      scale,
      static_cast<cudaStream_t>(stream)));
}
