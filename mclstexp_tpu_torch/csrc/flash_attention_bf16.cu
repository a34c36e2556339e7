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
// key block's running max, this kernel against the running max after each
// tile of 64 keys, so the two agree to bf16 rounding, not bit for bit.
//
// Design (csrc/flash_wgmma.cuh's tiles and products). One warpgroup of 128
// threads owns 64 queries; warp w owns rows 16w..16w+15 across the whole
// key tile, so no key-group merge is needed. Per tile of 64 keys:
//   S = Q K^T by wgmma m64n64k16 from shared memory (Q resident, K of the
//   ring, both K-major in the 128-byte swizzle), 4 or 8 k16 slices;
//   the online softmax on the accumulator in registers (exp2 of scores in
//   log2 units), p rounded to bf16 and packed straight into the register A
//   operand of the next product;
//   O = O * alpha + P V by wgmma m64nDPk16 with V read as the MN-major B
//   operand of the same tile: no transposed copy, no 2-byte column loads.
// K and V arrive through a ring of two stages, filled by TMA (one thread
// issues the copies, an mbarrier per stage counts their bytes; the first two
// tiles are issued before the walk) while the other stage's products run;
// the tensor maps are encoded by the launcher and passed as
// __grid_constant__ parameters (prefetched at entry). Inputs TMA cannot take
// (d % 8 != 0, a base not 16-byte aligned, a stride not a multiple of 8
// elements) take the kTma = false variant: the same kernel staging the same
// swizzled tiles by 2-byte loads. Segment ids: each thread reads its two
// rows' ids once, and the ids of its 16 key columns of the next tile into
// registers while this tile's products run; a warp vote finds a tile whose
// keys share one id. A row skips the masks in a tile below n that it sees
// whole (no ids, or one id equal to the row's), and k16 slices of keys past
// n skip their P V product.
//
// The plan (ops/flash_attention.bf16_plan): a grid of ceil(n / 64) query
// blocks per (batch, head), one CTA each, which walks every key tile in
// order: no split of the walk and no merge, the same bits on every run.
//
// Bound: 4*b*h*n^2*d operations against 4*b*h*n*d bf16 values moved; at
// 989 TFLOP/s (bf16 dense) and 3.35 TB/s a launch at the spot tower's
// shapes is bound by latency; at (1, 16, 4096, 64) the products are 69 us
// of work at the tensor-core peak, and the exponentials (n^2 per head on the
// special-function units, 16 per clock per SM) about as many.
//
// Any n >= 1, d <= 128 (tiles 64 columns wide for d <= 64, else 128;
// columns past d zero). Dynamic shared memory: q, two stages of k and v, 3
// mbarriers: 41 / 81 KB at d <= 64 / 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bf16.cuh"
#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

namespace bf = flash::bf16;
namespace wg = flash::wg;
using flash::kLn2;
using flash::kLog2e;
using flash::Strides;
using flash::weight;
using wg::kR;

static_assert(wg::kStages == 2, "the ring below alternates two stages");

template <int DP>
struct Layout {  // byte offsets in dynamic shared memory (after 1024-byte alignment)
  static constexpr int kTile = kR * DP * 2;
  static constexpr int kRing = kTile;                            // q at 0; stage s: k, v
  static constexpr int kBars = kRing + 2 * wg::kStages * kTile;  // q, then one per stage
  static constexpr int kBytes = kBars + (1 + wg::kStages) * 8 + 1024;
};

template <int DP, bool kTma, bool kSeg>
__global__ void __launch_bounds__(wg::kThreads)
    flash_fwd_bf16(const __grid_constant__ wg::View qview, const __grid_constant__ wg::View kview,
                   const __grid_constant__ wg::View vview, const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                   uint16_t* __restrict__ out, float* __restrict__ l_out,
                   float* __restrict__ m_out, const int* __restrict__ seg, Strides sq,
                   Strides sk, Strides sv, Strides so, int heads, int n, int d, float scale) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kR;
  const int tiles = (n + kR - 1) / kR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const uint16_t* kb = k + b * sk.b + h * sk.h;
  const uint16_t* vb = v + b * sv.b + h * sv.h;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  // the k and v tiles of key tile `tile` into stage s
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
  };

  // q and the walk's first two tiles (thread 0 issues the TMA copies on the
  // barriers it has just initialized; the others wait after the
  // __syncthreads that publishes the initialization)
  if (kTma && tid == 0) {
    wg::prefetch_view(qview);
    wg::prefetch_view(kview);
    wg::prefetch_view(vview);
    for (int i = 0; i < 1 + wg::kStages; ++i) wg::mbar_init(bars + i, 1);
    wg::mbar_init_fence();
  }
  if constexpr (kTma) {
    if (tid == 0) {
      wg::mbar_expect_tx(bars, L::kTile);
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
        wg::tma_load(base + p * wg::kPanelBytes, qview, 64 * p, q0, h, b, bars);
    }
  } else {
    wg::stage_tile<DP>(smem, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
  }
  issue(0, 0);
  if (tiles > 1) issue(1, 1);  // both stages start free
  __syncthreads();

  int row_seg[2] = {0, 0};  // the ids of rows 16w + g and 16w + g + 8
  // The ids of the thread's 16 key columns 8j + 2t + e of the walked tile,
  // read into registers a tile ahead of their use (0 past n)
  int key_ids[16] = {};
  auto load_ids = [&](int tile, int (&dst)[16]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = tile * kR + 8 * j + 2 * t + e;
        dst[2 * j + e] = key < n ? sb[key] : 0;
      }
  };
  if constexpr (kSeg) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + 16 * warp + g + 8 * hr;
      row_seg[hr] = qi < n ? sb[qi] : 0;
    }
    load_ids(0, key_ids);
  }

  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  if constexpr (kTma) wg::mbar_wait(bars, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    if constexpr (kTma) wg::mbar_wait(bars + 1 + s, phase);
    if constexpr (!kTma) wg::fence_proxy_async();
    __syncthreads();  // the tile landed; every warp is done with the other stage
    if (it > 0 && it + 1 < tiles) issue(it + 1, s ^ 1);  // into the stage of tile it - 1
    int next_ids[16] = {};
    if constexpr (kSeg) {
      if (it + 1 < tiles) load_ids(it + 1, next_ids);
    }
    const uint32_t kt = base + L::kRing + 2 * s * L::kTile, vt = kt + L::kTile;

    // S = Q K^T: 64 queries x 64 keys, fp32 sums of bf16 products
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::wgmma_ss_n64(sc, wg::desc_k(base, kk), wg::desc_k(kt, kk), kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);

    // the online softmax of rows 16w + g (+8): scores in log2 units, p =
    // 2^(s scale log2(e) - m) with m the running max of the scaled scores
    // (scaling by a positive constant keeps the max). A row sees every key
    // of the tile (no mask) where the tile lies below n and, with segment
    // ids, all its keys share the row's id.
    const int key0 = it * kR;
    bool whole = key0 + kR <= n;
    int tile_id = 0;  // with segment ids: the one id of every key of a whole tile
    if constexpr (kSeg) {
      tile_id = __shfl_sync(0xffffffffu, key_ids[0], 0);
      bool same = true;
#pragma unroll
      for (int x = 0; x < 16; ++x) same = same && key_ids[x] == tile_id;
      whole = __all_sync(0xffffffffu, same) && whole;  // the warp's lanes hold all 64 keys
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool full = whole && (!kSeg || row_seg[hr] == tile_id);
      float mx = -INFINITY;
      if (full) {
#pragma unroll
        for (int i = 2 * hr; i < 32; i += 4) mx = fmaxf(mx, fmaxf(sc[i], sc[i + 1]));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e, i = 4 * j + 2 * hr + e;
            if (!(key0 + c < n && (!kSeg || key_ids[2 * j + e] == row_seg[hr]))) sc[i] = -INFINITY;
            mx = fmaxf(mx, sc[i]);
          }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx * scale2);
      alpha[hr] = weight(m[hr], m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hr + e;
          const float x = wg::ex2(fmaf(sc[i], scale2, -m_new));
          sc[i] = (full || sc[i] != -INFINITY) ? x : 0.f;
          sum += sc[i];
        }
      l[hr] = l[hr] * alpha[hr] + sum;  // l sums the fp32 p
      m[hr] = m_new;
    }
    uint32_t pa[4][4];  // p in bf16: the A operand of P V, by k16 slice of keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(pa[kk], sc, kk);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i >> 1];

    // O += P V over the tile's 64 keys, all DP columns
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // slices of keys past n hold p = 0: skipped
      if (key0 + 16 * kk < n) wg::wgmma_rs<DP>(o, pa[kk], wg::desc_mn(vt, kk), 1);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(o);
    if constexpr (kSeg) {
#pragma unroll
      for (int x = 0; x < 16; ++x) key_ids[x] = next_ids[x];
    }
    if (++s == wg::kStages) {
      s = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  const long long rb = static_cast<long long>(bh) * n;
  uint16_t* ob = out + b * so.b + h * so.h;
  const bool pairs = wg::pairs_ok(ob, so.n, d);

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 16 * warp + g + 8 * hr;
    if (qi >= n) continue;
    uint16_t* row = ob + qi * so.n;
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      wg::store_pair(row, 8 * j + 2 * t, d, o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv,
                     pairs);
    if (l_out != nullptr && t == 0) {
      l_out[rb + qi] = l[hr];
      m_out[rb + qi] = m[hr] * kLn2;
    }
  }
}

template <int DP, bool kTma>
cudaError_t launch_fwd(const wg::View* views, const uint16_t* q, const uint16_t* k,
                       const uint16_t* v, uint16_t* out, float* l_out, float* m_out,
                       const int* seg, const Strides* s, int batch, int heads, int n, int d,
                       float scale, cudaStream_t stream) {
  return flash::with_segments(seg, [&](auto segments) {
    return wg::launch<&flash_fwd_bf16<DP, kTma, decltype(segments)::value>>(
        Layout<DP>::kBytes, batch, heads, n, stream, views[0], views[1], views[2], q, k, v, out,
        l_out, m_out, seg, s[0], s[1], s[2], s[3], heads, n, d, scale);
  });
}

}  // namespace

// As flash_attention_fwd_launch (csrc/flash_attention.cu), for bf16 q, k, v
// and out (l_out and m_out stay fp32), under ops/flash_attention.bf16_plan:
// rows must be 64 and split 1. The TMA variant runs where every input passes
// wg::tma_ok, the plain-load variant elsewhere.
extern "C" int flash_attention_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                               void* out, void* l_out, void* m_out,
                                               const void* seg, const long long* strides,
                                               int batch, int heads, int n, int d, int rows,
                                               int split, float scale, void* stream) {
  if (!wg::plan_ok(batch, heads, n, d, rows, split) || (l_out == nullptr) != (m_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  wg::View views[3] = {};
  const void* inputs[3] = {q, k, v};
  bool tma = true;
  for (int i = 0; i < 3; ++i) tma = tma && wg::tma_ok(inputs[i], s[i], batch, heads, n, d);
  for (int i = 0; tma && i < 3; ++i)
    if (!wg::encode_view(&views[i], inputs[i], s[i], batch, heads, n, d))
      return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  auto* op = static_cast<uint16_t*>(out);
  auto* lp = static_cast<float*>(l_out);
  auto* mp = static_cast<float*>(m_out);
  const auto* sp = static_cast<const int*>(seg);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 64) {
    err = tma ? launch_fwd<64, true>(views, qp, kp, vp, op, lp, mp, sp, s, batch, heads, n, d,
                                     scale, st)
              : launch_fwd<64, false>(views, qp, kp, vp, op, lp, mp, sp, s, batch, heads, n, d,
                                      scale, st);
  } else {
    err = tma ? launch_fwd<128, true>(views, qp, kp, vp, op, lp, mp, sp, s, batch, heads, n, d,
                                      scale, st)
              : launch_fwd<128, false>(views, qp, kp, vp, op, lp, mp, sp, s, batch, heads, n, d,
                                       scale, st);
  }
  return static_cast<int>(err);
}
