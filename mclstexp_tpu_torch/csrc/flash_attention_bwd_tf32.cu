// Flash-attention backward for Hopper (sm_90a), fp32 on 64-row warpgroup
// tiles. Replaces, for long sequences, the two TPU kernels that
// csrc/flash_attention_bwd.cu ports as thread-block clusters of 32-row
// blocks (jax.experimental.pallas.ops.tpu.flash_attention, jax 0.9.0):
//   _flash_attention_bwd_dkv (pallas_call :1121, kernel :796) -> flash_bwd_dkv_tf32
//   _flash_attention_bwd_dq  (pallas_call :1456, kernel :1146) -> flash_bwd_dq_tf32
// The caller's plan (ops/flash_attention.fp32_plan) sends a shape here or
// there.
//
// What they compute is csrc/flash_attention_bwd.cu's function to fp32
// accuracy: p = exp(s - m) / l recomputed from the forward's residuals, ds
// = p * (dout v^T - di) * scale, dv = p^T dout, dk = ds^T q, dq = ds k, every
// product 3xTF32 with fp32 accumulation; segment ids as there.
//
// Bound. dK/dV does 8*b*h*n^2*d operations and dQ 6*b*h*n^2*d; the tensor
// cores do three products for each, so at (1, 16, 4096, 64) the 412 and 309
// GFLOP issued take 0.83 and 0.62 ms at the TF32 peak of 495 TFLOP/s,
// against ~100 MB moved (30 us). The products and the shared-memory traffic
// that feeds them bound a tile: a walked tile of 32 queries against 64 keys
// is 3.15 MFLOP of 3xTF32 products (~0.84 us at an SM's share of the peak)
// whose shared-memory operands are ~195 KB (~0.85 us at 128 bytes a clock),
// and it brings 64 KB by TMA. On 64-key CTAs (flash_bwd_dkv_tf32) dK/dV's
// 193 KB of shared memory leave one warpgroup an SM, with nothing to hide its
// softmax and its waits behind, and every tile feeds 64 keys: 8.6 GB from L2
// into shared memory a call at (1, 16, 4096, 64).
//
// The K-major constraint and the split. A tf32 wgmma reads both
// shared-memory operands K-major. The score products sum over d and read
// q, k, v and dout by rows; the others sum over the walked rows: dV += P^T
// dout and dK += dS^T Q need dout and q transposed, dQ += dS K needs k
// transposed. The split pass (flash_tf32_split, csrc/flash_tf32.cuh),
// launched by the same entry point, writes once for both kernels the big
// and small tf32 parts of q, k, v and dout in the row form and of q, k and
// dout in the column form; the kernels' TMA copies those tiles as they
// are. p and ds are split in registers and fed as register A operands (the
// column form's row order makes the accumulator the A operand).
//
// Design (csrc/flash_tf32.cuh's tiles and products), as the bf16 kernels
// with the roles of queries and keys swapped between the two. One
// warpgroup of 128 threads owns 64 rows (keys for dK/dV, queries for dQ),
// whose two tiles (k and v, or q and dout; both parts) stay in shared
// memory for the whole walk over the other side in tiles of W = 32 rows,
// through a ring of two stages filled by TMA (and the walked rows' m, l, di
// and ids by cp.async); warp w owns rows 16w..16w+15. Per walked tile:
//   dK/dV: S^T = K Q^T and dP^T = V dout^T (product_ss, m64n32k8); p^T and
//   ds^T in fp32 registers, split; the tile's P^T dout and dS^T Q
//   (product_rs, m64nDPk8, k8 slices of queries past n skipped) into two
//   fresh accumulators, then added to dV and dK in fp32;
//   dQ: S = Q K^T and dP = dout V^T (product_mixed: the big parts of q and
//   dout read once into registers as A operands, their small parts read
//   from shared memory); ds in fp32, split; the tile's dS K (product_rs)
//   into a fresh accumulator, added to dQ in fp32.
// Masks are exponent biases of -inf, as in the bf16 kernels: keys past n
// and other segments' keys give p = 0. The sums stay in fp32 registers over
// the whole walk and are written once. One CTA per block of 64 rows walks
// every tile of the other side in order: no split, no merge, no atomics, the
// same bits on every run.
//
// dK/dV on 128-key CTAs (flash_bwd_dkv128_tf32; the caller's plan picks it
// where b h ceil(n / 128) CTAs fill the card). Two consumer warpgroups own 64
// keys each and walk the same query tiles out of one ring, which one warp of
// a third, producer warpgroup fills by TMA: three slots of half a tile (32 KB
// at DP = 64), the row half (q and dout by rows, both parts, which S^T and
// dP^T read) and the column half (q and dout transposed, which dV and dK
// read, with the walked rows' m log2(e), 1 / l, di and ids that the
// producer's lanes stage). A slot has a full mbarrier (the producer's 32
// lanes and the TMA bytes) and an empty one (one arrival per consumer warp
// once its products have read it). Each warpgroup's tile runs as above, so
// the products and the bound of a tile are the same, but:
//   * each walked tile feeds 128 keys: 4.3 GB a call from L2 into shared
//     memory at (1, 16, 4096, 64), half the 64-key design's;
//   * the SM's schedulers interleave the two warpgroups, so one's
//     exponentials, splits and waits run under the other's products. A fixed
//     order of the two warpgroups' products (named barriers, as
//     FlashAttention-3 orders its forward) ran 2.3x slower on the card, and
//     p^T computed under dP^T's products (two commit groups) gained nothing:
//     neither is used.
// The 384 threads launch with 168 registers each; the producer warpgroup
// gives its share to the consumers (setmaxnreg: 24 and 240), whose tiles
// need ~245. On the card at (1, 16, 4096, 64) with segment ids dK/dV with
// its split pass took 1.75 ms against the 64-key design's 2.53 (PERF.md
// section 6, row 5).
//
// Any n >= 1, d <= 64 (DP = 32 or 64). l, m and di are contiguous fp32 (b,
// h, n); outputs are written through their strides. Dynamic shared memory
// at DP = 64 / 32: dK/dV 193 / 97 KB on 64-key CTAs, 227 / 115 KB on 128-key
// ones (owned tiles 128 / 64 KB, the ring 96 / 48 KB), dQ 161 / 81 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tf32.cuh"

namespace {

namespace tf = flash::tf;
namespace wg = flash::wg;
using flash::kLog2e;
using flash::Strides;
using tf::kR;

constexpr int kW = 32;  // walked rows per tile
static_assert(tf::kStages == 2, "the ring below alternates two stages");

// Byte offsets in dynamic shared memory (after 1024-byte alignment): the
// owned pair (k, v for dK/dV; q, dout for dQ), two parts each, at 0; stage
// s of the ring at kRing + s kStage holds the walked tiles (dK/dV: q and
// dout in the row form, then q and dout in the column form; dQ: k and v in
// the row form, then k in the column form), two parts each; then each
// stage's stats (dK/dV: m, l, di of the walked rows) and ids; the barriers
// of the owned pair and of each stage.
template <int DP, int kWalked, int kStats>
struct Layout {
  static constexpr int kOwned = kR * DP * 4;  // one part of an owned tile
  static constexpr int kTile = kW * DP * 4;   // one part of a walked tile, either form
  static constexpr int kStage = 2 * kWalked * kTile;
  static constexpr int kRing = 4 * kOwned;
  static constexpr int kStat = kRing + tf::kStages * kStage;
  static constexpr int kIds = kStat + tf::kStages * kStats * kW * 4;
  static constexpr int kBars = kIds + tf::kStages * kW * 4;
  static constexpr int kBytes = kBars + (1 + tf::kStages) * 8 + 1024;
};

// The owned pair's two tiles (both parts) of rows r0.. into 0 (a) and
// 2 kOwned (b), completing on bar; by thread 0.
template <int DP>
__device__ __forceinline__ void load_owned(uint32_t base, const CUtensorMap* a,
                                           const CUtensorMap* b, int r0, int bh, uint64_t* bar) {
  constexpr int kOwned = kR * DP * 4;
  wg::mbar_expect_tx(bar, 4 * kOwned);
  for (int part = 0; part < 2; ++part) {
    tf::tma_tile(base + part * kOwned, a, kR, DP, 0, r0, 2 * bh + part, bar);
    tf::tma_tile(base + (2 + part) * kOwned, b, kR, DP, 0, r0, 2 * bh + part, bar);
  }
}

// The exponent biases (-inf past n) and segment ids of keys key0 + 16w + g
// and key0 + 16w + g + 8: the accumulator rows of warp w of a warpgroup,
// lane 4g + t.
template <bool kSeg>
__device__ __forceinline__ void key_masks(float (&bias)[2], int (&ids)[2], const int* sb,
                                          int key0, int w, int g, int n) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ki = key0 + 16 * w + g + 8 * hr;
    bias[hr] = ki < n ? 0.f : -INFINITY;
    ids[hr] = kSeg && ki < n ? sb[ki] : 0;
  }
}

// p^T in fp32, in place of a walked tile's S^T: query c of the tile is
// column 8j + 2t + e; st holds the tile's m log2(e) (+inf past n), 1 / l (0
// past n) and di, ids its segment ids.
template <bool kSeg>
__device__ __forceinline__ void probs(float (&sc)[kW / 2], const float* st, const int* ids,
                                      const float (&key_bias)[2], const int (&key_seg)[2],
                                      float scale2, int t) {
#pragma unroll
  for (int j = 0; j < kW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const float m2 = st[c], inv_l = st[kW + c];
      const int qid = kSeg ? ids[c] : 0;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 4 * j + 2 * hr + e;
        const float bias = kSeg && key_seg[hr] != qid ? -INFINITY : key_bias[hr];
        sc[i] = exp2f(fmaf(sc[i], scale2, bias - m2)) * inv_l;
      }
    }
}

// ds^T = p^T (dP^T - di) scale in fp32, in place of the tile's dP^T
__device__ __forceinline__ void grads(float (&dp)[kW / 2], const float (&p)[kW / 2],
                                      const float* st, float scale, int t) {
#pragma unroll
  for (int j = 0; j < kW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dc = st[2 * kW + 8 * j + 2 * t + e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 4 * j + 2 * hr + e;
        dp[i] = p[i] * (dp[i] - dc) * scale;
      }
    }
}

// dk and dv of keys key0 + 16w + g (+8) below n, columns below d
template <int DP>
__device__ __forceinline__ void store_dkv(const float (&acc_dk)[DP / 2],
                                          const float (&acc_dv)[DP / 2], float* dkb, float* dvb,
                                          Strides sdk, Strides sdv, int key0, int w, int g, int t,
                                          int n, int d) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ki = key0 + 16 * w + g + 8 * hr;
    if (ki >= n) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e, i = 4 * j + 2 * hr + e;
        if (c < d) {
          dkb[ki * sdk.n + c] = acc_dk[i];
          dvb[ki * sdv.n + c] = acc_dv[i];
        }
      }
  }
}

template <int DP, bool kSeg>
__global__ void __launch_bounds__(tf::kThreads)
    flash_bwd_dkv_tf32(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap qtmap,
                       const __grid_constant__ CUtensorMap dotmap, const float* __restrict__ l,
                       const float* __restrict__ m, const float* __restrict__ di,
                       float* __restrict__ dk, float* __restrict__ dv,
                       const int* __restrict__ seg, Strides sdk, Strides sdv, int heads, int n,
                       int d, float scale) {
  using L = Layout<DP, 4, 3>;
  constexpr int KD = DP / 8, KW = kW / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  float* stats = reinterpret_cast<float*>(smem + L::kStat);
  int* ids = reinterpret_cast<int*>(smem + L::kIds);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int k0 = blockIdx.y * kR;
  const int tiles = (n + kW - 1) / kW;
  const long long rb = static_cast<long long>(bh) * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  // query tile `tile`: q and dout in both forms, its m, l, di and ids, into stage s
  auto issue = [&](int tile, int s) {
    if (tid == 0) {
      uint64_t* bar = bars + 1 + s;
      const uint32_t at = base + L::kRing + s * L::kStage;
      wg::mbar_expect_tx(bar, L::kStage);
      for (int part = 0; part < 2; ++part) {
        tf::tma_tile(at + part * L::kTile, &qmap, kW, DP, 0, tile * kW, 2 * bh + part, bar);
        tf::tma_tile(at + (2 + part) * L::kTile, &domap, kW, DP, 0, tile * kW, 2 * bh + part,
                     bar);
        tf::tma_tile(at + (4 + part) * L::kTile, &qtmap, DP, kW, tile * kW, 0, 2 * bh + part,
                     bar);
        tf::tma_tile(at + (6 + part) * L::kTile, &dotmap, DP, kW, tile * kW, 0, 2 * bh + part,
                     bar);
      }
    }
    float* st = stats + 3 * kW * s;
    tf::stage_row<kW>(st, m + rb, tile * kW, n, 0);
    tf::stage_row<kW>(st + kW, l + rb, tile * kW, n, kW);
    tf::stage_row<kW>(st + 2 * kW, di + rb, tile * kW, n, 2 * kW);
    if constexpr (kSeg)
      tf::stage_row<kW>(reinterpret_cast<float*>(ids + kW * s),
                        reinterpret_cast<const float*>(sb), tile * kW, n, 3 * kW);
    flash::cp_async_commit();
  };

  if (tid == 0) {
    tf::prefetch_map(&kmap);
    tf::prefetch_map(&vmap);
    tf::prefetch_map(&qmap);
    tf::prefetch_map(&domap);
    tf::prefetch_map(&qtmap);
    tf::prefetch_map(&dotmap);
    for (int i = 0; i < 1 + tf::kStages; ++i) wg::mbar_init(bars + i, 1);
    wg::mbar_init_fence();
    load_owned<DP>(base, &kmap, &vmap, k0, bh, bars);
  }
  issue(0, 0);
  if (tiles > 1) issue(1, 1);  // both stages start free
  __syncthreads();

  float key_bias[2];
  int key_seg[2];
  key_masks<kSeg>(key_bias, key_seg, sb, k0, warp, g, n);

  const float scale2 = scale * kLog2e;
  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  wg::mbar_wait(bars, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    wg::mbar_wait(bars + 1 + s, phase);
    flash::cp_async_wait<0>();
    float* st = stats + 3 * kW * s;
    const int q0 = it * kW;
    if (tid < 2 * kW) {  // the stats this thread staged, as the tile uses them: m log2(e)
                         // (+inf past n, so p = 0 there) by threads 0..31, 1 / l (0 past n) by 32..63
      const int c = tid & (kW - 1);
      float& x = st[tid];
      x = q0 + c < n ? (tid < kW ? x * kLog2e : 1.f / x) : (tid < kW ? INFINITY : 0.f);
    }
    __syncthreads();  // the tile and its stats landed; every warp is done with the other stage
    if (it > 0 && it + 1 < tiles) issue(it + 1, s ^ 1);  // into the stage of tile it - 1
    const uint32_t at = base + L::kRing + s * L::kStage;

    // S^T = K Q^T and dP^T = V dout^T: 64 keys x 32 queries
    float sc[kW / 2], dp[kW / 2];
    wg::wgmma_fence();
    tf::product_ss<kW, KD>(sc, base, L::kOwned, at, L::kTile);
    tf::product_ss<kW, KD>(dp, base + 2 * L::kOwned, L::kOwned, at + 2 * L::kTile, L::kTile);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);
    wg::fence_regs(dp);

    probs<kSeg>(sc, st, ids + kW * s, key_bias, key_seg, scale2, t);
    grads(dp, sc, st, scale, t);
    uint32_t pb[KW][4], ps[KW][4], db[KW][4], ds[KW][4];
    tf::split_a<KW>(pb, ps, sc);
    tf::split_a<KW>(db, ds, dp);
    tf::fence_a(pb);
    tf::fence_a(ps);
    tf::fence_a(db);
    tf::fence_a(ds);

    // the tile's P^T dout and dS^T Q over its queries below n
    float tv[DP / 2], tk[DP / 2];
    const int live = min(KW, (n - q0 + 7) / 8);
    wg::wgmma_fence();
    tf::product_rs<DP, KW>(tv, pb, ps, at + 6 * L::kTile, L::kTile, live);
    tf::product_rs<DP, KW>(tk, db, ds, at + 4 * L::kTile, L::kTile, live);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(tv);
    wg::fence_regs(tk);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      acc_dv[i] += tv[i];
      acc_dk[i] += tk[i];
    }
    if (++s == tf::kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  flash::cp_async_wait<0>();

  store_dkv<DP>(acc_dk, acc_dv, dk + b * sdk.b + h * sdk.h, dv + b * sdv.b + h * sdv.h, sdk, sdv,
                k0, warp, g, t, n, d);
}

constexpr int kSlots = 3;  // the 128-key design's ring of half tiles
// two consumer warpgroups and a producer warpgroup, of which one warp works
constexpr int kPairThreads = 3 * tf::kThreads;
// Registers a thread: the launch gives each 168 (65,536 / 384, rounded down
// to 8); the producer warpgroup hands its share to the consumers, as much as
// it frees (128 x (168 - 24) = 256 x (240 - 168)).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Byte offsets of the 128-key design (after 1024-byte alignment): the owned
// tiles of warpgroup c (k, v, both parts) at c * 4 kOwned; slot s of the
// ring at kRing + s kHalf holds half a walked tile: q and dout in the row
// form, or q and dout in the column form, both parts; then each slot's
// stats (m log2(e), 1 / l, di, ids of the walked rows, written with a
// column half); the barriers of the owned tiles, then full[kSlots] and
// empty[kSlots].
template <int DP>
struct PairLayout {
  static constexpr int kOwned = kR * DP * 4;
  static constexpr int kTile = kW * DP * 4;
  static constexpr int kHalf = 4 * kTile;
  static constexpr int kRing = 8 * kOwned;
  static constexpr int kStat = kRing + kSlots * kHalf;
  static constexpr int kBars = kStat + kSlots * 4 * kW * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kSlots) * 8 + 1024;
};
static_assert(PairLayout<64>::kBytes <= 232448, "the 128-key design fits a block's shared memory");

template <int DP, bool kSeg>
__global__ void __launch_bounds__(kPairThreads, 1)
    flash_bwd_dkv128_tf32(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap qtmap,
                          const __grid_constant__ CUtensorMap dotmap, const float* __restrict__ l,
                          const float* __restrict__ m, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ seg, Strides sdk, Strides sdv, int heads,
                          int n, int d, float scale) {
  using L = PairLayout<DP>;
  constexpr int KD = DP / 8, KW = kW / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  float* stats = reinterpret_cast<float*>(smem + L::kStat);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kSlots;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int k0 = blockIdx.y * 2 * kR;
  const int groups = k0 + kR < n ? 2 : 1;  // consumer warpgroups with keys below n
  const int tiles = (n + kW - 1) / kW;
  const long long rb = static_cast<long long>(bh) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  if (threadIdx.x == 0) {
    tf::prefetch_map(&kmap);
    tf::prefetch_map(&vmap);
    tf::prefetch_map(&qmap);
    tf::prefetch_map(&domap);
    tf::prefetch_map(&qtmap);
    tf::prefetch_map(&dotmap);
    wg::mbar_init(bars, groups);
    for (int s = 0; s < kSlots; ++s) {
      wg::mbar_init(full + s, 32);
      wg::mbar_init(empty + s, 4 * groups);
    }
    wg::mbar_init_fence();
    for (int c = 0; c < groups; ++c)
      load_owned<DP>(base + c * 4 * L::kOwned, &kmap, &vmap, k0 + c * kR, bh, bars);
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > 8) return;
    // warp 8 fills the ring: half h of the walk into slot h % 3
    int s = 0;
    uint32_t phase = 0;
    float m2 = 0.f, inv_l = 0.f, dr = 0.f;
    int id = 0;
    for (int half = 0; half < 2 * tiles; ++half) {
      const int q0 = (half >> 1) * kW;
      const bool cols = half & 1;
      if (!cols) {  // query q0 + lane's stats as the consumers use them, ahead of its column half
        const int q = q0 + lane;
        const bool in = q < n;
        m2 = in ? m[rb + q] * kLog2e : INFINITY;
        inv_l = in ? 1.f / l[rb + q] : 0.f;
        dr = in ? di[rb + q] : 0.f;
        if constexpr (kSeg) id = in ? sb[q] : 0;
      }
      wg::mbar_wait(empty + s, phase ^ 1);  // a fresh barrier passes parity 1
      if (cols) {
        float* st = stats + 4 * kW * s;
        st[lane] = m2;
        st[kW + lane] = inv_l;
        st[2 * kW + lane] = dr;
        reinterpret_cast<int*>(st)[3 * kW + lane] = id;
      }
      if (lane == 0) {  // after its own stats: the arrival releases them
        const uint32_t at = base + L::kRing + s * L::kHalf;
        wg::mbar_expect_tx(full + s, L::kHalf);
        for (int part = 0; part < 2; ++part) {
          if (cols) {
            tf::tma_tile(at + part * L::kTile, &qtmap, DP, kW, q0, 0, 2 * bh + part, full + s);
            tf::tma_tile(at + (2 + part) * L::kTile, &dotmap, DP, kW, q0, 0, 2 * bh + part,
                         full + s);
          } else {
            tf::tma_tile(at + part * L::kTile, &qmap, kW, DP, 0, q0, 2 * bh + part, full + s);
            tf::tma_tile(at + (2 + part) * L::kTile, &domap, kW, DP, 0, q0, 2 * bh + part,
                         full + s);
          }
        }
      } else {
        wg::mbar_arrive(full + s);
      }
      if (++s == kSlots) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup c: keys key0 .. key0 + 63
  const int c = warp >> 2;
  if (c >= groups) return;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + c * kR;
  const uint32_t own = base + c * 4 * L::kOwned;
  float key_bias[2];
  int key_seg[2];
  key_masks<kSeg>(key_bias, key_seg, sb, key0, w, g, n);
  const float scale2 = scale * kLog2e;
  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  wg::mbar_wait(bars, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = it * kW;
    // the row half: S^T = K Q^T and dP^T = V dout^T, 64 keys x 32 queries
    wg::mbar_wait(full + s, phase);
    uint32_t at = base + L::kRing + s * L::kHalf;
    float sc[kW / 2], dp[kW / 2];
    wg::wgmma_fence();
    tf::product_ss<kW, KD>(sc, own, L::kOwned, at, L::kTile);
    tf::product_ss<kW, KD>(dp, own + 2 * L::kOwned, L::kOwned, at + 2 * L::kTile, L::kTile);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);
    wg::fence_regs(dp);
    if (lane == 0) wg::mbar_arrive(empty + s);
    if (++s == kSlots) {
      s = 0;
      phase ^= 1;
    }

    // the column half and the tile's stats
    wg::mbar_wait(full + s, phase);
    at = base + L::kRing + s * L::kHalf;
    const float* st = stats + 4 * kW * s;
    probs<kSeg>(sc, st, reinterpret_cast<const int*>(st + 3 * kW), key_bias, key_seg, scale2, t);
    grads(dp, sc, st, scale, t);
    uint32_t pb[KW][4], ps[KW][4], db[KW][4], ds[KW][4];
    tf::split_a<KW>(pb, ps, sc);
    tf::split_a<KW>(db, ds, dp);
    tf::fence_a(pb);
    tf::fence_a(ps);
    tf::fence_a(db);
    tf::fence_a(ds);

    // the tile's P^T dout and dS^T Q over its queries below n
    float tv[DP / 2], tk[DP / 2];
    const int live = min(KW, (n - q0 + 7) / 8);
    wg::wgmma_fence();
    tf::product_rs<DP, KW>(tv, pb, ps, at + 2 * L::kTile, L::kTile, live);
    tf::product_rs<DP, KW>(tk, db, ds, at, L::kTile, live);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(tv);
    wg::fence_regs(tk);
    if (lane == 0) wg::mbar_arrive(empty + s);
    if (++s == kSlots) {
      s = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      acc_dv[i] += tv[i];
      acc_dk[i] += tk[i];
    }
  }
  store_dkv<DP>(acc_dk, acc_dv, dk + b * sdk.b + h * sdk.h, dv + b * sdv.b + h * sdv.h, sdk, sdv,
                key0, w, g, t, n, d);
}

template <int DP, bool kSeg>
__global__ void __launch_bounds__(tf::kThreads)
    flash_bwd_dq_tf32(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap ktmap, const float* __restrict__ l,
                      const float* __restrict__ m, const float* __restrict__ di,
                      float* __restrict__ dq, const int* __restrict__ seg, Strides sdq,
                      int heads, int n, int d, float scale) {
  using L = Layout<DP, 3, 0>;
  constexpr int KD = DP / 8, KW = kW / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  int* ids = reinterpret_cast<int*>(smem + L::kIds);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kR;
  const int tiles = (n + kW - 1) / kW;
  const long long rb = static_cast<long long>(bh) * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  // key tile `tile`: k and v in the row form, k in the column form, and its
  // ids, into stage s
  auto issue = [&](int tile, int s) {
    if (tid == 0) {
      uint64_t* bar = bars + 1 + s;
      const uint32_t at = base + L::kRing + s * L::kStage;
      wg::mbar_expect_tx(bar, L::kStage);
      for (int part = 0; part < 2; ++part) {
        tf::tma_tile(at + part * L::kTile, &kmap, kW, DP, 0, tile * kW, 2 * bh + part, bar);
        tf::tma_tile(at + (2 + part) * L::kTile, &vmap, kW, DP, 0, tile * kW, 2 * bh + part,
                     bar);
        tf::tma_tile(at + (4 + part) * L::kTile, &ktmap, DP, kW, tile * kW, 0, 2 * bh + part,
                     bar);
      }
    }
    if constexpr (kSeg) {
      tf::stage_row<kW>(reinterpret_cast<float*>(ids + kW * s),
                        reinterpret_cast<const float*>(sb), tile * kW, n, 0);
      flash::cp_async_commit();
    }
  };

  if (tid == 0) {
    tf::prefetch_map(&qmap);
    tf::prefetch_map(&domap);
    tf::prefetch_map(&kmap);
    tf::prefetch_map(&vmap);
    tf::prefetch_map(&ktmap);
    for (int i = 0; i < 1 + tf::kStages; ++i) wg::mbar_init(bars + i, 1);
    wg::mbar_init_fence();
    load_owned<DP>(base, &qmap, &domap, q0, bh, bars);
  }
  issue(0, 0);
  if (tiles > 1) issue(1, 1);  // both stages start free

  // queries 16w + g and 16w + g + 8, read once while the copies fly: m
  // log2(e) (+inf past n, so p = 0 there), scale / l (0 past n), di and the id
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
  wg::mbar_wait(bars, 0);
  uint32_t qb[KD][4], dob[KD][4];  // the big parts of q and dout as A operands, in registers
  tf::load_a<KD>(qb, smem);
  tf::load_a<KD>(dob, smem + 2 * L::kOwned);
  tf::fence_a(qb);
  tf::fence_a(dob);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    wg::mbar_wait(bars + 1 + s, phase);
    if constexpr (kSeg) flash::cp_async_wait<0>();
    __syncthreads();  // the tile and its ids landed; every warp is done with the other stage
    if (it > 0 && it + 1 < tiles) issue(it + 1, s ^ 1);  // into the stage of tile it - 1
    const uint32_t at = base + L::kRing + s * L::kStage;

    // S = Q K^T and dP = dout V^T: 64 queries x 32 keys
    float sc[kW / 2], dp[kW / 2];
    wg::wgmma_fence();
    tf::product_mixed<kW, KD>(sc, qb, base + L::kOwned, at, L::kTile);
    tf::product_mixed<kW, KD>(dp, dob, base + 3 * L::kOwned, at + 2 * L::kTile, L::kTile);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);
    wg::fence_regs(dp);

    // ds in fp32, in place of s: key c of the tile is column 8j + 2t + e
    const int key0 = it * kW;
    const int* tile_ids = ids + kW * s;
#pragma unroll
    for (int j = 0; j < KW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float col = key0 + c < n ? 0.f : -INFINITY;
        const int kid = kSeg ? tile_ids[c] : 0;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const float bias = kSeg && kid != row_seg[hr] ? -INFINITY : col;
          const float p = exp2f(fmaf(sc[i], scale2, bias - m2[hr]));
          sc[i] = p * ((dp[i] - dr[hr]) * sl[hr]);
        }
      }
    uint32_t db[KW][4], ds[KW][4];
    tf::split_a<KW>(db, ds, sc);
    tf::fence_a(db);
    tf::fence_a(ds);

    // the tile's dS K over its keys below n
    float tq[DP / 2];
    const int live = min(KW, (n - key0 + 7) / 8);
    wg::wgmma_fence();
    tf::product_rs<DP, KW>(tq, db, ds, at + 4 * L::kTile, L::kTile, live);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(tq);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += tq[i];
    if (++s == tf::kStages) {
      s = 0;
      phase ^= 1;
    }
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 16 * warp + g + 8 * hr;
    if (qi >= n) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c < d) dqb[qi * sdq.n + c] = acc[4 * j + 2 * hr + e];
      }
  }
}

// One launch of Kernel(args...) on a grid of (batch * heads, ceil(n / 128))
// blocks of kPairThreads with `smem` bytes of dynamic shared memory.
template <auto Kernel, typename... Args>
cudaError_t launch_pairs(int smem, int batch, int heads, int n, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = flash::allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim =
      dim3(static_cast<unsigned>(batch * heads), static_cast<unsigned>((n + 2 * kR - 1) / (2 * kR)));
  config.blockDim = dim3(kPairThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  err = cudaLaunchKernelEx(&config, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The backward on either dK/dV design (keys128: the 128-key kernel); the
// entry points below.
int bwd_launch(const void* q, const void* k, const void* v, const void* dout, void* scratch,
               const void* l, const void* m, const void* di, void* dk, void* dv, void* dq,
               const void* seg, const long long* strides, int batch, int heads, int n, int d,
               float scale, void* stream, bool keys128) {
  const bool dkv = dk != nullptr;
  if (!tf::shape_ok(batch, heads, n, d) || dkv != (dv != nullptr) || (!dkv && dq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[7];
  for (int i = 0; i < 7; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int bh = batch * heads;
  const auto* sp = static_cast<const int*>(seg);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fl = static_cast<const float*>(l);
  const auto* fm = static_cast<const float*>(m);
  const auto* fdi = static_cast<const float*>(di);
  return static_cast<int>(tf::with_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const long long size = tf::copy_floats(batch, heads, n, DP);
    float* next = static_cast<float*>(scratch);
    const auto take = [&](bool want) {
      float* at = want ? next : nullptr;
      next += want ? size : 0;
      return at;
    };
    float *qr = take(true), *kr = take(true), *vr = take(true), *dor = take(true);
    float *qc = take(dkv), *doc = take(dkv), *kc = take(dq != nullptr);
    const tf::SplitJobs jobs = {{{static_cast<const float*>(q), s[0], qr, qc},
                                 {static_cast<const float*>(k), s[1], kr, kc},
                                 {static_cast<const float*>(v), s[2], vr, nullptr},
                                 {static_cast<const float*>(dout), s[3], dor, doc}}};
    cudaError_t err = tf::split<DP>(jobs, 4, batch, heads, n, d, st);
    if (err != cudaSuccess) return err;
    if (dkv) {
      CUtensorMap maps[6];
      if (!tf::encode_rows(&maps[0], kr, bh, n, DP, kR) ||
          !tf::encode_rows(&maps[1], vr, bh, n, DP, kR) ||
          !tf::encode_rows(&maps[2], qr, bh, n, DP, kW) ||
          !tf::encode_rows(&maps[3], dor, bh, n, DP, kW) ||
          !tf::encode_cols(&maps[4], qc, bh, n, DP) || !tf::encode_cols(&maps[5], doc, bh, n, DP))
        return cudaErrorInvalidValue;
      err = flash::with_segments(sp, [&](auto segments) {
        constexpr bool kSeg = decltype(segments)::value;
        if (keys128)
          return launch_pairs<&flash_bwd_dkv128_tf32<DP, kSeg>>(
              PairLayout<DP>::kBytes, batch, heads, n, st, maps[0], maps[1], maps[2], maps[3],
              maps[4], maps[5], fl, fm, fdi, static_cast<float*>(dk), static_cast<float*>(dv), sp,
              s[4], s[5], heads, n, d, scale);
        return wg::launch<&flash_bwd_dkv_tf32<DP, kSeg>>(
            Layout<DP, 4, 3>::kBytes, batch, heads, n, st, maps[0], maps[1], maps[2], maps[3],
            maps[4], maps[5], fl, fm, fdi, static_cast<float*>(dk), static_cast<float*>(dv), sp,
            s[4], s[5], heads, n, d, scale);
      });
      if (err != cudaSuccess) return err;
    }
    if (dq == nullptr) return cudaSuccess;
    CUtensorMap maps[5];
    if (!tf::encode_rows(&maps[0], qr, bh, n, DP, kR) ||
        !tf::encode_rows(&maps[1], dor, bh, n, DP, kR) ||
        !tf::encode_rows(&maps[2], kr, bh, n, DP, kW) ||
        !tf::encode_rows(&maps[3], vr, bh, n, DP, kW) || !tf::encode_cols(&maps[4], kc, bh, n, DP))
      return cudaErrorInvalidValue;
    return flash::with_segments(sp, [&](auto segments) {
      return wg::launch<&flash_bwd_dq_tf32<DP, decltype(segments)::value>>(
          Layout<DP, 3, 0>::kBytes, batch, heads, n, st, maps[0], maps[1], maps[2], maps[3],
          maps[4], fl, fm, fdi, static_cast<float*>(dq), sp, s[6], heads, n, d, scale);
    });
  }));
}

}  // namespace

// q, k, v, dout: device fp32 buffers read as (batch, heads, n, d) through
// the given element strides (3 per tensor: batch, head, row; the last
// dimension contiguous); l, m, di: contiguous fp32 (batch, heads, n); dk,
// dv, dq: written as (batch, heads, n, d) through their strides (the fifth
// to seventh triples), dk and dv both null to skip dK/dV, dq null to skip
// dQ; seg: null, or contiguous int32 (batch, n) segment ids; scratch: (4 +
// 2 [dK/dV] + 1 [dQ]) * tf::copy_floats(batch, heads, n, DP) floats for the
// split copies. 1 <= d <= 64, n >= 1, b h <= 65535. Launches the split pass
// (q, k, v, dout in the row form; q and dout for dK/dV and k for dQ in the
// column form), then dK/dV and dQ, each one CTA of 128 threads per (batch *
// head, block of 64 rows), on `stream`; returns the first launch error or
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_tf32_launch(
    const void* q, const void* k, const void* v, const void* dout, void* scratch,
    const void* l, const void* m, const void* di, void* dk, void* dv, void* dq,
    const void* seg, const long long* strides, int batch, int heads, int n, int d, float scale,
    void* stream) {
  return bwd_launch(q, k, v, dout, scratch, l, m, di, dk, dv, dq, seg, strides, batch, heads, n,
                    d, scale, stream, false);
}

// The same with dK/dV on the 128-key design: one CTA of two warpgroups and
// a producer warp per (batch * head, block of 128 keys).
extern "C" int flash_attention_bwd_tf32_dkv128_launch(
    const void* q, const void* k, const void* v, const void* dout, void* scratch,
    const void* l, const void* m, const void* di, void* dk, void* dv, void* dq,
    const void* seg, const long long* strides, int batch, int heads, int n, int d, float scale,
    void* stream) {
  return bwd_launch(q, k, v, dout, scratch, l, m, di, dk, dv, dq, seg, strides, batch, heads, n,
                    d, scale, stream, true);
}
