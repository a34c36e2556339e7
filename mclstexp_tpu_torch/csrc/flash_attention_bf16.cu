// Flash-attention forward for Hopper (sm_90a), bfloat16: the bf16 branch of
// the TPU kernel that csrc/flash_attention.cu ports in fp32
// (jax.experimental.pallas.ops.tpu.flash_attention, jax 0.9.0; pallas_call
// :758, kernel :342-481), which the spot tower and the slide baselines
// reach with ModelConfig.dtype / BaselineConfig.dtype "bfloat16"
// (mclstexp_tpu/core/layers.py:201-219: q, k, v in the compute dtype).
//
// What the library kernel computes on bf16 inputs, and this one too: the
// scores s = q k^T from bf16 operands with fp32 accumulation (:396), the
// online softmax's max m and sum l in fp32 (l sums the fp32 p), p cast to
// bf16 before p v (:471, fp32 accumulation), the output normalized in fp32
// and stored in bf16 once (:477, :670); l and m stay fp32 (:689-692).
// Where p is rounded differs: the library rounds exp(s - m) against its
// block's running max, this kernel against its key group's, so the two
// agree to bf16 rounding, not bit for bit.
//
// Design: csrc/flash_attention.cu's, with bf16 operands. Each block of 32
// queries is one thread-block cluster of `split` CTAs (ops/flash_attention.
// cluster_plan) that share the walk over the key tiles; per walked tile of
// 32 keys warp w owns queries 16*(w & 1).. and the key group 8*(w >> 1)..,
// computes its 16 x 8 block of s with mma m16n8k16 over d, keeps its
// group's running max and sum per row, turns its scores into p, packs p
// (its accumulator fragment) straight into the A operand of an m16n8k8
// product with v over its 8 keys, and adds that to its running output
// after the rescale. The 4 key groups' (m, l, out) are merged in group
// order, then the cluster's ranks in rank order, in fp32, over distributed
// shared memory: no atomics, the same bits on every run. The products take
// one tensor-core pass (3xTF32 takes three); q, k and v move at half the
// fp32 kernel's bytes.
//
// Bound: 4*b*h*n^2*d operations against 4*b*h*n*d bf16 values moved; at
// 989 TFLOP/s (bf16 dense) and 3.35 TB/s a launch at the spot tower's
// shapes is bound by latency, as the fp32 kernel's is; at (1, 16, 4096,
// 64) the products are 69 us of work at the tensor-core peak.
//
// Any n >= 1, d <= 128 (tile widths 32, 64, 128; columns past d zero),
// segment ids as in the fp32 kernel (kSeg). Inputs are read through
// strides, 16 bytes (8 values) at a time by cp.async where d % 8 == 0 and
// the pointers and strides allow it, else 2 bytes at a time by plain loads.
// Dynamic shared memory: 5 bf16 tiles of 32 x (D + 8) (q, two stages of k
// and v) and, in fp32, the key groups' and the rank's outputs and the row
// stats: 63 / 124 KB at D = 64 / 128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bf16.cuh"
#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::kLn2;
using flash::kLog2e;
using flash::kRows;
using flash::kThreads;
using flash::Strides;
using flash::weight;

constexpr int kGroups = kThreads / 32 / 2;  // key groups of 8 keys: 4 warps per 16 rows

template <int D>
struct Smem {
  static constexpr int kTile = flash::bf16::Tile<D>::kElems;  // bf16 values of a tile
  // q, 2 stages of k and v (bf16); then in fp32 the key groups' outputs (4
  // x 32 x D), the rank's output (32 x D), the groups' m and l (4 x 32
  // each), the rank's m and l (32 each); then 2 stages of the walked keys'
  // segment ids (32 ints each). In floats:
  static constexpr int kFloats = 5 * kTile / 2 + kGroups * kRows * D + kRows * D +
                                 2 * kGroups * kRows + 2 * kRows + 2 * kRows;
};

template <int D, bool kVec, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                   float* __restrict__ l_out, float* __restrict__ m_out,
                   const int* __restrict__ seg, Strides sq, Strides sk, Strides sv, Strides so,
                   int heads, int n, int d, int split, float scale) {
  namespace bf = flash::bf16;
  constexpr int S = bf::Tile<D>::kStride;
  constexpr int T = Smem<D>::kTile;
  constexpr int kN = D / 8;  // the warp's 16 x 8 output fragments: all D columns
  extern __shared__ __align__(16) float smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* stage = qs + T;  // stage s: k at stage + 2sT, v at + T
  float* group_acc = reinterpret_cast<float*>(qs + 5 * T);  // group j at + j * 32 * D
  float* acc_r = group_acc + kGroups * kRows * D;
  float* group_m = acc_r + kRows * D;  // m of key group j at group_m + 32j; l at group_l + 32j
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

  const uint16_t* kb = k + b * sk.b + h * sk.h;
  const uint16_t* vb = v + b * sv.b + h * sv.h;
  const int* sb = kSeg ? seg + b * n : nullptr;
  bf::stage_rows<D, kVec>(qs, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
  auto stage_walk = [&](int tile, int s) {
    uint16_t* st = stage + 2 * s * T;
    bf::stage_rows<D, kVec>(st, kb, sk.n, tile * kRows, n, d);
    bf::stage_rows<D, kVec>(st + T, vb, sv.n, tile * kRows, n, d);
    if constexpr (kSeg) flash::stage_ids(key_seg + kRows * s, sb, tile * kRows, n, 0);
  };
  if (first < last) stage_walk(first, 0);
  flash::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16;  // the warp's 16 queries of the block
  const int grp = warp >> 1;       // its key group: keys n0.. of every tile
  const int n0 = grp * 8;
  int row_seg[2] = {0, 0};  // the ids of rows g and g + 8
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + m0 + g + 8 * r;
      row_seg[r] = qi < n ? sb[qi] : 0;
    }
  }

  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kN][4] = {};

  for (int it = first; it < last; ++it) {
    const int s = (it - first) & 1;
    const uint16_t* ks = stage + 2 * s * T;
    const uint16_t* vs = ks + T;
    flash::cp_async_wait<0>();
    __syncthreads();  // the tile landed, and every warp is done with the other stage
    if (it + 1 < last) stage_walk(it + 1, s ^ 1);
    flash::cp_async_commit();

    // s = q k^T (fp32 accumulation of bf16 products): 16 queries x 8 keys
    float sc[4] = {};
#pragma unroll
    for (int e = 0; e < D; e += 16) {
      uint32_t a[4], bk[2];
      bf::load_a(a, qs, S, m0, e);
      bf::load_b_t(bk, ks, S, n0, e);
      bf::mma16(sc, a, bk);
    }
    const int key = it * kRows + n0 + 2 * t;
    const int* ks_seg = key_seg + kRows * s + n0 + 2 * t;
    float p[4], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok0 = key < n && (!kSeg || ks_seg[0] == row_seg[r]);
      const bool ok1 = key + 1 < n && (!kSeg || ks_seg[1] == row_seg[r]);
      const float s0 = sc[2 * r] * scale2, s1 = sc[2 * r + 1] * scale2;
      float mx = fmaxf(ok0 ? s0 : -INFINITY, ok1 ? s1 : -INFINITY);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = weight(m[r], m_new);
      p[2 * r] = ok0 ? exp2f(s0 - m_new) : 0.f;
      p[2 * r + 1] = ok1 ? exp2f(s1 - m_new) : 0.f;
      l[r] = l[r] * alpha[r] + (p[2 * r] + p[2 * r + 1]);  // l sums the fp32 p
      m[r] = m_new;
    }
    // p in bf16 as the A operand of m16n8k8: rows g, g + 8; keys 2t, 2t + 1
    const uint32_t pa[2] = {bf::pack(p[0], p[1]), bf::pack(p[2], p[3])};

    // out = out * alpha + p v over the group's 8 keys, all D columns
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float tv[4] = {};
      bf::mma8(tv, pa, bf::column_pair(vs, S, n0 + 2 * t, 8 * j + g));
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acc[j][i] * alpha[i >> 1] + tv[i];
    }
  }
  flash::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf::store_acc<D, kN>(group_acc + grp * kRows * D, acc, m0, 0);
  if (t == 0) {
    group_m[grp * kRows + m0 + g] = m[0];
    group_m[grp * kRows + m0 + g + 8] = m[1];
    group_l[grp * kRows + m0 + g] = l[0];
    group_l[grp * kRows + m0 + g + 8] = l[1];
  }
  __syncthreads();

  const long long rb = static_cast<long long>(bh) * n;
  uint16_t* ob = out + b * so.b + h * so.h;
  // out = bf16(acc / l) for row r, columns c..c+3 (rows below n, columns
  // below d); m back in natural units
  auto write = [&](int r, int c, float4 x, float lr, float mr) {
    const int qi = q0 + r;
    if (qi >= n) return;
    uint16_t* o = ob + qi * so.n + c;
    const float val[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) o[e] = bf::from_float(val[e] / lr);
    if (l_out != nullptr && c == 0) {
      l_out[rb + qi] = lr;
      m_out[rb + qi] = mr * kLn2;
    }
  };

  // The key groups merged in group order: the rank's (m, l, acc) of each row.
  constexpr int kChunks = D / 4;
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
      const float4 y = *reinterpret_cast<const float4*>(group_acc + (j * kRows + r) * D + c);
      lr += group_l[j * kRows + r] * w;
      x.x += y.x * w;
      x.y += y.y * w;
      x.z += y.z * w;
      x.w += y.w * w;
    }
    if (split == 1) {
      write(r, c, x, lr, mr);
    } else {
      *reinterpret_cast<float4*>(acc_r + r * D + c) = x;
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
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(acc_r, src) + r * D + c);
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
cudaError_t launch_fwd(const uint16_t* q, const uint16_t* k, const uint16_t* v, uint16_t* out,
                       float* l_out, float* m_out, const int* seg, const Strides* s, int batch,
                       int heads, int n, int d, int split, float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return flash::launch_cluster<&flash_fwd_bf16<D, kVec, decltype(segments)::value>>(
        Smem<D>::kFloats, batch, heads, n, split, stream, q, k, v, out, l_out, m_out, seg, s[0],
        s[1], s[2], s[3], heads, n, d, split, scale);
  });
}

}  // namespace

// As flash_attention_fwd_launch (csrc/flash_attention.cu), for bf16 q, k, v
// and out; l_out and m_out stay fp32.
extern "C" int flash_attention_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                               void* out, void* l_out, void* m_out,
                                               const void* seg, const long long* strides,
                                               int batch, int heads, int n, int d, int rows,
                                               int split, float scale, void* stream) {
  if (!flash::plan_ok(batch, heads, n, d, rows, split) || (l_out == nullptr) != (m_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* inputs[3] = {q, k, v};
  const bool vec = flash::vec_ok(inputs, strides, 3, d, 8);
  return static_cast<int>(FLASH_DISPATCH(
      launch_fwd, vec, d, static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), static_cast<float*>(l_out),
      static_cast<float*>(m_out), static_cast<const int*>(seg), s, batch, heads, n, d, split,
      scale, static_cast<cudaStream_t>(stream)));
}
