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
// dk, dv, dq are stored in bf16 once (:1094-1099, :1283, :1436).
//
// Design (csrc/flash_wgmma.cuh's tiles and products), the same for both
// kernels with the roles of queries and keys swapped. One warpgroup of 128
// threads owns 64 rows (keys for dK/dV, queries for dQ), whose two tiles (k
// and v, or q and dout) stay in shared memory for the whole walk over the
// other side's tiles of 64; warp w owns rows 16w..16w+15. Per walked tile:
//   dK/dV: S^T = K Q^T and dP^T = V dout^T (m64n64k16, both operands
//   K-major from shared memory); p^T = exp2(s^T scale log2(e) - m log2(e))
//   / l and ds^T = p^T (dp^T - di) scale in fp32 registers, rounded to bf16
//   and packed into register A operands; dV += P^T dout and dK += dS^T Q
//   (m64nDPk16), with dout and q read as the MN-major B operands of the
//   same swizzled tiles that fed the first two products;
//   dQ: S = Q K^T and dP = dout V^T (m64n64k16 from shared memory); ds = p
//   (dp - di) scale with p = exp2(s scale log2(e) - m log2(e)) / l, rounded
//   to bf16 into the register A operand; dQ += dS K (m64nDPk16) with k read
//   as the MN-major B operand of the tile that fed S.
// p and ds never go to shared memory. The walked pair (Q and dout, or K and
// V: TMA, as the forward's k and v) and each walked tile's ids (and for
// dK/dV its m, l, di; cp.async) arrive through a ring of two stages; one
// barrier per tile. Masks are exponent biases of -inf, never branches (a
// masked branch cost dK/dV 14-22%: PERF.md, section 6): dK/dV's threads that
// staged a tile's m and l turn them into m log2(e) and 1 / l (+inf and 0
// past n, so p = 0 there) before that barrier, and each thread's keys past
// n carry a row bias; dQ reads its two rows' m log2(e), scale / l and di once
// before the walk (+inf, 0 and 0 past n), and keys past n or of another
// segment get a column bias. k16 slices of the walked side past n skip
// their products. The sums stay in fp32 registers over the whole walk and
// are stored in bf16 once. The plan (ops/flash_attention.bf16_plan): one
// CTA per block of 64 rows, which walks every tile of the other side in
// order: no split of the walk and no merge, the same bits on every run.
// Inputs TMA cannot take run the kTma = false variant (2-byte loads into
// the same tiles).
//
// Bound: at the training shape (1, 8, 128, 64) dK/dV moves 6*b*h*n*d bf16
// values and does 8*b*h*n^2*d operations, dQ 5*b*h*n*d values and
// 6*b*h*n^2*d operations: well under a microsecond each at 3.35 TB/s and
// 989 TFLOP/s, so a launch is bound by latency; at n = 4,096 the products
// (and the n^2 exponentials per head on the special-function units).
//
// Any n >= 1, d <= 128, segment ids as in the fp32 kernels (kSeg). Inputs
// are read through strides; l, m and di are contiguous fp32 (b, h, n);
// outputs are written through their strides. Dynamic shared memory: the
// owned pair, two stages of the walked pair, the stats and ids: 51 / 99 KB
// at d <= 64 / 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

namespace wg = flash::wg;
using flash::kLog2e;
using flash::Strides;
using wg::kR;

static_assert(wg::kStages == 2, "the ring below alternates two stages");

// Byte offsets in dynamic shared memory (after 1024-byte alignment): the
// owned pair (k, v for dK/dV; q, dout for dQ) at 0 and kSecond; stage s of
// the ring holds the walked pair at kRing + 2sT, the walked rows' m, l, di
// (dK/dV) and their ids; the barriers of the owned pair and of each stage.
template <int DP>
struct Layout {
  static constexpr int kTile = kR * DP * 2;
  static constexpr int kSecond = kTile;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kStats = kRing + 2 * wg::kStages * kTile;
  static constexpr int kIds = kStats + wg::kStages * 3 * kR * 4;
  static constexpr int kBars = kIds + wg::kStages * kR * 4;
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
  using L = Layout<DP>;
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
        wg::tma_load(base + L::kSecond + p * wg::kPanelBytes, vview, 64 * p, k0, h, b, bars);
      }
    }
  } else {
    wg::stage_tile<DP>(smem, k + b * sk.b + h * sk.h, sk.n, k0, n, d);
    wg::stage_tile<DP>(smem + L::kSecond, v + b * sv.b + h * sv.h, sv.n, k0, n, d);
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
      wg::wgmma_ss_n64(dp, wg::desc_k(base + L::kSecond, kk), wg::desc_k(dot, kk), kk > 0);
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

template <int DP, bool kTma, bool kSeg>
__global__ void __launch_bounds__(wg::kThreads)
    flash_bwd_dq_bf16(const __grid_constant__ wg::View qview,
                      const __grid_constant__ wg::View kview,
                      const __grid_constant__ wg::View vview,
                      const __grid_constant__ wg::View doview, const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                      const uint16_t* __restrict__ dout, const float* __restrict__ l,
                      const float* __restrict__ m, const float* __restrict__ di,
                      uint16_t* __restrict__ dq, const int* __restrict__ seg, Strides sq,
                      Strides sk, Strides sv, Strides sdo, Strides sdq, int heads, int n, int d,
                      float scale) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  int* ids = reinterpret_cast<int*>(smem + L::kIds);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kR;
  const int tiles = (n + kR - 1) / kR;
  const long long rb = static_cast<long long>(bh) * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const uint16_t* kb = k + b * sk.b + h * sk.h;
  const uint16_t* vb = v + b * sv.b + h * sv.h;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  // the k and v tiles of key tile `tile` and its ids into stage s
  auto issue = [&](int tile, int s) {
    const int at = L::kRing + 2 * s * L::kTile;
    if constexpr (kTma) {
      if (tid == 0) {
        wg::mbar_expect_tx(bars + 1 + s, 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < DP / 64; ++p) {
          const int off = at + p * wg::kPanelBytes;
          wg::tma_load(base + off, kview, 64 * p, tile * kR, h, b, bars + 1 + s);
          wg::tma_load(base + off + L::kTile, vview, 64 * p, tile * kR, h, b, bars + 1 + s);
        }
      }
    } else {
      wg::stage_tile<DP>(smem + at, kb, sk.n, tile * kR, n, d);
      wg::stage_tile<DP>(smem + at + L::kTile, vb, sv.n, tile * kR, n, d);
    }
    if constexpr (kSeg) {
      wg::stage_row64(reinterpret_cast<float*>(ids + kR * s), reinterpret_cast<const float*>(sb),
                      tile * kR, n, 0);
      flash::cp_async_commit();
    }
  };

  // q, dout and the walk's first two tiles (thread 0 issues the TMA copies
  // on the barriers it has just initialized; the __syncthreads publishes them)
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
        wg::tma_load(base + p * wg::kPanelBytes, qview, 64 * p, q0, h, b, bars);
        wg::tma_load(base + L::kSecond + p * wg::kPanelBytes, doview, 64 * p, q0, h, b, bars);
      }
    }
  } else {
    wg::stage_tile<DP>(smem, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
    wg::stage_tile<DP>(smem + L::kSecond, dout + b * sdo.b + h * sdo.h, sdo.n, q0, n, d);
  }
  issue(0, 0);
  if (tiles > 1) issue(1, 1);  // both stages start free

  // queries 16w + g and 16w + g + 8, read once while the copies fly: m
  // log2(e) (+inf past n, so p = 0 there), scale / l (0 past n: the 1 / l
  // of p and the scale of ds in one factor), di and the id
  float m2[2], sl[2], dr[2];
  int row_seg[2] = {0, 0};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 16 * warp + g + 8 * hr;
    const bool in = qi < n;
    m2[hr] = in ? m[rb + qi] * kLog2e : INFINITY;
    sl[hr] = in ? scale / l[rb + qi] : 0.f;
    dr[hr] = in ? di[rb + qi] : 0.f;
    if constexpr (kSeg) row_seg[hr] = in ? sb[qi] : 0;
  }
  __syncthreads();

  const float scale2 = scale * kLog2e;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if constexpr (kTma) wg::mbar_wait(bars, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    if constexpr (kTma) wg::mbar_wait(bars + 1 + s, phase);
    if constexpr (kSeg) flash::cp_async_wait<0>();
    if constexpr (!kTma) wg::fence_proxy_async();
    __syncthreads();  // the tile and its ids landed; every warp is done with the other stage
    if (it > 0 && it + 1 < tiles) issue(it + 1, s ^ 1);  // into the stage of tile it - 1
    const uint32_t kt = base + L::kRing + 2 * s * L::kTile, vt = kt + L::kTile;

    // S = Q K^T and dP = dout V^T: 64 queries x 64 keys
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::wgmma_ss_n64(sc, wg::desc_k(base, kk), wg::desc_k(kt, kk), kk > 0);
      wg::wgmma_ss_n64(dp, wg::desc_k(base + L::kSecond, kk), wg::desc_k(vt, kk), kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);
    wg::fence_regs(dp);

    // ds in fp32, in place of s: key c of the tile is column 8j + 2t + e.
    // Masked entries get an exponent of -inf, so p = ds = 0 without a
    // branch: keys past n and keys of another segment by a column bias,
    // queries past n by their m.
    const int key0 = it * kR;
    const int* tile_ids = ids + kR * s;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float col = key0 + c < n ? 0.f : -INFINITY;
        const int kid = kSeg ? tile_ids[c] : 0;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const float bias = kSeg && kid != row_seg[hr] ? -INFINITY : col;
          const float p = wg::ex2(fmaf(sc[i], scale2, bias - m2[hr]));
          sc[i] = p * ((dp[i] - dr[hr]) * sl[hr]);
        }
      }
    uint32_t da[4][4];  // ds in bf16, by k16 slice of keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(da[kk], sc, kk);

    // dQ += dS K over the tile's 64 keys, all DP columns
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // slices of keys past n hold ds = 0: skipped
      if (key0 + 16 * kk < n) wg::wgmma_rs<DP>(acc, da[kk], wg::desc_mn(kt, kk), 1);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(acc);
    if (++s == wg::kStages) {
      s = 0;
      phase ^= 1;
    }
  }

  uint16_t* dqb = dq + b * sdq.b + h * sdq.h;
  const bool pairs = wg::pairs_ok(dqb, sdq.n, d);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 16 * warp + g + 8 * hr;
    if (qi >= n) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      wg::store_pair(dqb + qi * sdq.n, 8 * j + 2 * t, d, acc[4 * j + 2 * hr],
                     acc[4 * j + 2 * hr + 1], pairs);
  }
}

// The backward launchers' common part: the plan, the strides of `count`
// views (q, k, v, dout, then the outputs) and the TMA views of q, k, v and
// dout where all four pass wg::tma_ok; then go(views, strides, DP, kTma)
// for the variant (wg::with_variant).
template <int kCount, typename Go>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const long long* strides, int batch, int heads, int n, int d, int rows,
               int split, Go go) {
  if (!wg::plan_ok(batch, heads, n, d, rows, split))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[kCount];
  wg::read_strides(s, strides, kCount);
  wg::View views[4] = {};
  const void* inputs[4] = {q, k, v, dout};
  bool tma;
  if (!wg::encode_views(views, &tma, inputs, s, 4, batch, heads, n, d))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(wg::with_variant(
      d, tma, [&](auto dp, auto staging) { return go(views, s, dp, staging); }));
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
  const auto* sp = static_cast<const int*>(seg);
  return launch_bwd<6>(q, k, v, dout, strides, batch, heads, n, d, rows, split,
                       [&](const wg::View* views, const Strides* s, auto dp, auto staging) {
    constexpr int DP = decltype(dp)::value;
    constexpr bool kTma = decltype(staging)::value;
    return flash::with_segments(sp, [&](auto segments) {
      return wg::launch<&flash_bwd_dkv_bf16<DP, kTma, decltype(segments)::value>>(
          Layout<DP>::kBytes, batch, heads, n, static_cast<cudaStream_t>(stream), views[0],
          views[1], views[2], views[3], static_cast<const uint16_t*>(q),
          static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
          static_cast<const uint16_t*>(dout), static_cast<const float*>(l),
          static_cast<const float*>(m), static_cast<const float*>(di),
          static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), sp, s[0], s[1], s[2], s[3],
          s[4], s[5], heads, n, d, scale);
    });
  });
}

// As flash_attention_bwd_dq_launch, for bf16 q, k, v, dout and dq (l, m and
// di stay fp32), under bf16_plan, TMA or plain loads as for dK/dV.
extern "C" int flash_attention_bwd_dq_bf16_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dq, const void* seg, const long long* strides,
    int batch, int heads, int n, int d, int rows, int split, float scale, void* stream) {
  const auto* sp = static_cast<const int*>(seg);
  return launch_bwd<5>(q, k, v, dout, strides, batch, heads, n, d, rows, split,
                       [&](const wg::View* views, const Strides* s, auto dp, auto staging) {
    constexpr int DP = decltype(dp)::value;
    constexpr bool kTma = decltype(staging)::value;
    return flash::with_segments(sp, [&](auto segments) {
      return wg::launch<&flash_bwd_dq_bf16<DP, kTma, decltype(segments)::value>>(
          Layout<DP>::kBytes, batch, heads, n, static_cast<cudaStream_t>(stream), views[0],
          views[1], views[2], views[3], static_cast<const uint16_t*>(q),
          static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
          static_cast<const uint16_t*>(dout), static_cast<const float*>(l),
          static_cast<const float*>(m), static_cast<const float*>(di),
          static_cast<uint16_t*>(dq), sp, s[0], s[1], s[2], s[3], s[4], heads, n, d, scale);
    });
  });
}
