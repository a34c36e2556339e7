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
// Design of dK/dV (csrc/flash_wgmma.cuh's tiles and products). One
// warpgroup of 128 threads owns 64 keys, whose k and v tiles stay in shared
// memory for the whole walk over the query tiles of 64; warp w owns keys
// 16w..16w+15. Per query tile four wgmma products:
//   S^T = K Q^T and dP^T = V dout^T (m64n64k16, both operands K-major from
//   shared memory); then p^T = exp2(s^T scale log2(e) - m log2(e)) / l and
//   ds^T = p^T (dp^T - di) scale in fp32 registers, rounded to bf16 and
//   packed into register A operands;
//   dV += P^T dout and dK += dS^T Q (m64nDPk16), with q and dout read as
//   the MN-major B operands of the same swizzled tiles that fed the first
//   two products: p and ds never go to shared memory.
// Q, dout (TMA, as the forward's k and v) and each tile's m, l, di and ids
// (cp.async) arrive through a ring of two stages; one barrier per tile. The
// threads that staged a tile's m and l turn them into m log2(e) and 1 / l
// (+inf and 0 past n, so p = 0 there without a mask) before that barrier,
// once per tile rather than once per thread and column. The sums stay in
// fp32 registers over the whole walk and dk, dv are stored in bf16 once.
// The plan (ops/flash_attention.bf16_plan): one CTA per block of 64 keys,
// which walks every query tile in order: no split of the walk and no merge,
// the same bits on every run. Inputs TMA cannot take run the kTma = false
// variant (2-byte loads into the same tiles).
//
// Design of dQ (not yet redesigned; ops/flash_attention.cluster_plan):
// csrc/flash_attention_bwd.cu's, with bf16 operands. One cluster of `split`
// CTAs per (batch*head, block of 32 queries), sharing the walk over the key
// tiles; per walked tile each warp computes a 16 x 8 block of the two score
// products on the tensor cores (mma m16n8k16 over d), forms ds in fp32
// registers and writes it to shared memory in bf16 (the library's cast);
// then each computes a 16 x D/4 block of the tile's share of dq (m16n8k16
// over the tile's 32 keys) and adds it to fp32 running sums. At the end the
// ranks' partial sums are added in rank order over distributed shared
// memory, in fp32, and written once in bf16.
//
// Bound: at the training shape (1, 8, 128, 64) dK/dV moves 6*b*h*n*d bf16
// values and does 8*b*h*n^2*d operations, dQ 5*b*h*n*d values and
// 6*b*h*n^2*d operations: well under a microsecond each at 3.35 TB/s and
// 989 TFLOP/s, so a launch is bound by latency; at n = 4,096 the products.
//
// Any n >= 1, d <= 128, segment ids as in the fp32 kernels (kSeg). Inputs
// are read through strides; l, m and di are contiguous fp32 (b, h, n);
// outputs are written through their strides. dK/dV's dynamic shared memory:
// k, v, two stages of q and dout, the stats and ids: 51 / 99 KB at d <= 64 /
// 128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bf16.cuh"
#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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
  // dQ: q, dout (owned), 2 stages of k and v, ds (bf16); m, l, di of the
  // owned rows, the dq partial sums (fp32); segment ids of 2 stages of keys
  static constexpr int kDq = (6 * kTile + kScores) / 2 + 3 * kRows + kRows * D + 2 * kRows;
};

namespace wg = flash::wg;
using flash::kLog2e;
using wg::kR;

static_assert(wg::kStages == 2, "the ring below alternates two stages");

template <int DP>
struct DkvLayout {  // byte offsets in dynamic shared memory (after 1024-byte alignment)
  static constexpr int kTile = kR * DP * 2;
  static constexpr int kV = kTile;                                // k at 0
  static constexpr int kRing = 2 * kTile;                         // stage s: q, dout at + 2sT
  static constexpr int kStats = kRing + 2 * wg::kStages * kTile;  // stage s: m, l, di (64 each)
  static constexpr int kIds = kStats + wg::kStages * 3 * kR * 4;  // stage s: 64 query ids
  static constexpr int kBars = kIds + wg::kStages * kR * 4;        // k and v, then one per stage
  static constexpr int kBytes = kBars + (1 + wg::kStages) * 8 + 1024;
};

template <int DP, bool kTma, bool kSeg>
__global__ void __launch_bounds__(wg::kThreads)
    flash_bwd_dkv_bf16(const __grid_constant__ wg::View qview,
                       const __grid_constant__ wg::View kview,
                       const __grid_constant__ wg::View vview,
                       const __grid_constant__ wg::View doview, const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                       const uint16_t* __restrict__ dout, const float* __restrict__ l,
                       const float* __restrict__ m, const float* __restrict__ di,
                       uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                       const int* __restrict__ seg, Strides sq, Strides sk, Strides sv,
                       Strides sdo, Strides sdk, Strides sdv, int heads, int n, int d,
                       float scale) {
  using L = DkvLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  int* ids = reinterpret_cast<int*>(smem + L::kIds);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int k0 = blockIdx.y * kR;
  const int tiles = (n + kR - 1) / kR;
  const long long rb = static_cast<long long>(bh) * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const uint16_t* qb = q + b * sq.b + h * sq.h;
  const uint16_t* dob = dout + b * sdo.b + h * sdo.h;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  // the q and dout tiles of query tile `tile`, its m, l, di and ids into stage s
  auto issue = [&](int tile, int s) {
    const int at = L::kRing + 2 * s * L::kTile;
    if constexpr (kTma) {
      if (tid == 0) {
        wg::mbar_expect_tx(bars + 1 + s, 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < DP / 64; ++p) {
          const int off = at + p * wg::kPanelBytes;
          wg::tma_load(base + off, qview, 64 * p, tile * kR, h, b, bars + 1 + s);
          wg::tma_load(base + off + L::kTile, doview, 64 * p, tile * kR, h, b, bars + 1 + s);
        }
      }
    } else {
      wg::stage_tile<DP>(smem + at, qb, sq.n, tile * kR, n, d);
      wg::stage_tile<DP>(smem + at + L::kTile, dob, sdo.n, tile * kR, n, d);
    }
    float* st = stats + 3 * kR * s;
    wg::stage_row64(st, m + rb, tile * kR, n, 0);
    wg::stage_row64(st + kR, l + rb, tile * kR, n, kR);
    wg::stage_row64(st + 2 * kR, di + rb, tile * kR, n, 0);
    if constexpr (kSeg)
      wg::stage_row64(reinterpret_cast<float*>(ids + kR * s), reinterpret_cast<const float*>(sb),
                      tile * kR, n, kR);
    flash::cp_async_commit();
  };

  // k, v and the walk's first two tiles (thread 0 issues the TMA copies on
  // the barriers it has just initialized; the __syncthreads publishes them)
  if (kTma && tid == 0) {
    wg::prefetch_view(qview);
    wg::prefetch_view(kview);
    wg::prefetch_view(vview);
    wg::prefetch_view(doview);
    for (int i = 0; i < 1 + wg::kStages; ++i) wg::mbar_init(bars + i, 1);
    wg::mbar_init_fence();
  }
  if constexpr (kTma) {
    if (tid == 0) {
      wg::mbar_expect_tx(bars, 2 * L::kTile);
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) {
        wg::tma_load(base + p * wg::kPanelBytes, kview, 64 * p, k0, h, b, bars);
        wg::tma_load(base + L::kV + p * wg::kPanelBytes, vview, 64 * p, k0, h, b, bars);
      }
    }
  } else {
    wg::stage_tile<DP>(smem, k + b * sk.b + h * sk.h, sk.n, k0, n, d);
    wg::stage_tile<DP>(smem + L::kV, v + b * sv.b + h * sv.h, sv.n, k0, n, d);
  }
  issue(0, 0);
  if (tiles > 1) issue(1, 1);  // both stages start free
  __syncthreads();

  // keys 16w + g and 16w + g + 8: an exponent bias of -inf past n (p = 0
  // there), and their ids
  float key_bias[2];
  int key_seg[2] = {0, 0};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ki = k0 + 16 * warp + g + 8 * hr;
    key_bias[hr] = ki < n ? 0.f : -INFINITY;
    if constexpr (kSeg) key_seg[hr] = ki < n ? sb[ki] : 0;
  }

  const float scale2 = scale * kLog2e;
  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  if constexpr (kTma) wg::mbar_wait(bars, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    if constexpr (kTma) wg::mbar_wait(bars + 1 + s, phase);
    flash::cp_async_wait<0>();
    float* st = stats + 3 * kR * s;
    const int q0 = it * kR;
    {  // the stats this thread staged, in the forms the tile uses: m log2(e)
       // (+inf past n, so p = 0 there) by threads 0..63, 1 / l (0 past n) by 64..127
      const int c = tid & (kR - 1);
      float& x = st[tid < kR ? c : kR + c];
      x = q0 + c < n ? (tid < kR ? x * kLog2e : 1.f / x) : (tid < kR ? INFINITY : 0.f);
    }
    if constexpr (!kTma) wg::fence_proxy_async();
    __syncthreads();  // the tile and its stats landed; every warp is done with the other stage
    if (it > 0 && it + 1 < tiles) issue(it + 1, s ^ 1);  // into the stage of tile it - 1
    const uint32_t qt = base + L::kRing + 2 * s * L::kTile, dot = qt + L::kTile;

    // S^T = K Q^T and dP^T = V dout^T: 64 keys x 64 queries
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::wgmma_ss_n64(sc, wg::desc_k(base, kk), wg::desc_k(qt, kk), kk > 0);
      wg::wgmma_ss_n64(dp, wg::desc_k(base + L::kV, kk), wg::desc_k(dot, kk), kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);
    wg::fence_regs(dp);

    // p^T and ds^T in fp32, in place: query c of the tile is column 8j + 2t
    // + e. Masked entries get an exponent of -inf, so p = 0 without a
    // branch: keys past n by key_bias, queries past n by their stats, other
    // segments' queries by the same bias.
    const int* tile_ids = ids + kR * s;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float m2 = st[c], inv_l = st[kR + c], dc = st[2 * kR + c];
        const int qid = kSeg ? tile_ids[c] : 0;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const float bias = kSeg && key_seg[hr] != qid ? -INFINITY : key_bias[hr];
          const float p = wg::ex2(fmaf(sc[i], scale2, bias - m2)) * inv_l;
          sc[i] = p;
          dp[i] = p * (dp[i] - dc) * scale;
        }
      }
    uint32_t pa[4][4], da[4][4];  // p^T and ds^T in bf16, by k16 slice of queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::pack_a(pa[kk], sc, kk);
      wg::pack_a(da[kk], dp, kk);
    }

    // dV += P^T dout, dK += dS^T Q over the tile's 64 queries
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // slices of queries past n hold p = ds = 0: skipped
      if (q0 + 16 * kk < n) {
        wg::wgmma_rs<DP>(acc_dv, pa[kk], wg::desc_mn(dot, kk), 1);
        wg::wgmma_rs<DP>(acc_dk, da[kk], wg::desc_mn(qt, kk), 1);
      }
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(acc_dv);
    wg::fence_regs(acc_dk);
    if (++s == wg::kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  flash::cp_async_wait<0>();

  uint16_t* dkb = dk + b * sdk.b + h * sdk.h;
  uint16_t* dvb = dv + b * sdv.b + h * sdv.h;
  const bool pairs = wg::pairs_ok(dkb, sdk.n, d) && wg::pairs_ok(dvb, sdv.n, d);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ki = k0 + 16 * warp + g + 8 * hr;
    if (ki >= n) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t, i = 4 * j + 2 * hr;
      wg::store_pair(dkb + ki * sdk.n, c, d, acc_dk[i], acc_dk[i + 1], pairs);
      wg::store_pair(dvb + ki * sdv.n, c, d, acc_dv[i], acc_dv[i + 1], pairs);
    }
  }
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

template <int DP, bool kTma>
cudaError_t launch_dkv(const wg::View* views, const uint16_t* q, const uint16_t* k,
                       const uint16_t* v, const uint16_t* dout, const float* l, const float* m,
                       const float* di, uint16_t* dk, uint16_t* dv, const int* seg,
                       const Strides* s, int batch, int heads, int n, int d, float scale,
                       cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return wg::launch<&flash_bwd_dkv_bf16<DP, kTma, decltype(segments)::value>>(
        DkvLayout<DP>::kBytes, batch, heads, n, stream, views[0], views[1], views[2], views[3],
        q, k, v, dout, l, m, di, dk, dv, seg, s[0], s[1], s[2], s[3], s[4], s[5], heads, n, d,
        scale);
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

// As flash_attention_bwd_dkv_launch (csrc/flash_attention_bwd.cu), for bf16
// q, k, v, dout, dk and dv (l, m and di stay fp32), under
// ops/flash_attention.bf16_plan: rows must be 64 and split 1. The TMA
// variant runs where q, k, v and dout pass wg::tma_ok, the plain-load
// variant elsewhere.
extern "C" int flash_attention_bwd_dkv_bf16_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dk, void* dv, const void* seg,
    const long long* strides, int batch, int heads, int n, int d, int rows, int split,
    float scale, void* stream) {
  if (!wg::plan_ok(batch, heads, n, d, rows, split))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int i = 0; i < 6; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  wg::View views[4] = {};
  const void* inputs[4] = {q, k, v, dout};
  bool tma = true;
  for (int i = 0; i < 4; ++i) tma = tma && wg::tma_ok(inputs[i], s[i], batch, heads, n, d);
  for (int i = 0; tma && i < 4; ++i)
    if (!wg::encode_view(&views[i], inputs[i], s[i], batch, heads, n, d))
      return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* dop = static_cast<const uint16_t*>(dout);
  const auto* lp = static_cast<const float*>(l);
  const auto* mp = static_cast<const float*>(m);
  const auto* dip = static_cast<const float*>(di);
  auto* dkp = static_cast<uint16_t*>(dk);
  auto* dvp = static_cast<uint16_t*>(dv);
  const auto* sp = static_cast<const int*>(seg);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 64) {
    err = tma ? launch_dkv<64, true>(views, qp, kp, vp, dop, lp, mp, dip, dkp, dvp, sp, s, batch,
                                     heads, n, d, scale, st)
              : launch_dkv<64, false>(views, qp, kp, vp, dop, lp, mp, dip, dkp, dvp, sp, s,
                                      batch, heads, n, d, scale, st);
  } else {
    err = tma ? launch_dkv<128, true>(views, qp, kp, vp, dop, lp, mp, dip, dkp, dvp, sp, s,
                                      batch, heads, n, d, scale, st)
              : launch_dkv<128, false>(views, qp, kp, vp, dop, lp, mp, dip, dkp, dvp, sp, s,
                                       batch, heads, n, d, scale, st);
  }
  return static_cast<int>(err);
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
