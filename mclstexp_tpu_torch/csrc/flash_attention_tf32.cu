// Flash-attention forward for Hopper (sm_90a), fp32 on 64-row warpgroup
// tiles, after the pass that splits its inputs. Replaces, for long sequences,
// the TPU kernel that csrc/flash_attention.cu ports as thread-block clusters
// of 32-row blocks: jax.experimental.pallas.ops.tpu.flash_attention (jax
// 0.9.0; pallas_call :758, kernel _flash_attention_kernel_single_batch
// :342-481), reached at mclstexp_tpu/core/layers.py:201-219. The caller's
// plan (ops/flash_attention.fp32_plan) sends a shape here or there.
//
// What it computes is csrc/flash_attention.cu's function to fp32 accuracy:
// an online softmax over key tiles with running max m and sum l in fp32,
// every product 3xTF32 with fp32 accumulation, out = acc / l written once,
// l and m (natural units) as the residuals; segment ids as there (query i
// sees key j only where seg[b][i] == seg[b][j]).
//
// Bound. 4*b*h*n^2*d operations; in 3xTF32 the tensor cores do three
// products for each, so at (1, 16, 4096, 64) the 206 GFLOP issued take 0.42
// ms at the TF32 peak of 495 TFLOP/s, against 16 MB per input at 3.35 TB/s
// (5 us). The products and the shared-memory traffic that feeds them (a
// tile's TMA writes and wgmma reads) bound a tile; the split pass adds a
// read of the inputs and a write of twice their size (~70 us at that shape).
//
// The K-major constraint and the split. A tf32 wgmma reads both
// shared-memory operands K-major, so q k^T reads q and k row by row, but p v
// needs v transposed. The split pass (flash_tf32_split, csrc/flash_tf32.cuh),
// launched by the same entry point just before, writes the big and small
// tf32 parts of q and k in the row form and of v in the column form (v^T,
// rows of v reordered within 8), each a plain-load pass over the strided
// input; the kernel's TMA copies those tiles as they are, and p is split in
// registers and fed as the register A operand.
//
// Design (csrc/flash_tf32.cuh's tiles and products). One warpgroup of 128
// threads owns 64 queries, warp w rows 16w..16w+15; the q tile (both parts)
// lands in shared memory once and is read into registers as the A operand
// of every S, so a tile's shared-memory reads are K's and V's alone. Per
// tile of W = 32 keys, through a ring of two stages filled by TMA (thread 0
// issues the copies, an mbarrier per stage counts their bytes):
//   S = Q K^T by product_rs (m64n32k8, 3 x DP/8 wgmma);
//   the online softmax on the accumulator in registers (scores in log2
//   units, exp2f), p split into its tf32 parts as the register A operand;
//   the tile's P V by product_rs into a fresh accumulator (k8 slices of
//   keys past n skipped), then out = out * alpha + P V in fp32.
// Two CTAs share an SM (97 KB of shared memory each at DP = 64), so one's
// softmax runs while the other's products do. Tiles of 64 keys (160 KB,
// one CTA an SM) took 13% longer at (1, 16, 4096, 64), and a walk
// pipelined inside the CTA (the next tile's S issued before this tile's P
// V) 43% longer (PERF.md section 6). Segment ids as the bf16 kernel reads
// them: each thread its two rows' ids once, its keys' ids a tile ahead; a
// warp vote finds a tile whose keys share one id, and rows that see a whole
// tile skip the masks. One CTA per block of 64 queries walks every key
// tile in order: no split of the walk, no merge, the same bits on every run.
//
// Any n >= 1 and d <= 64 (tiles of DP = 32 or 64 columns; the split
// copies are zero past d and n). Dynamic shared memory: q (2 parts) and two
// stages of k (row form) and v (column form), 2 parts each: 49 / 97 KB at
// DP = 32 / 64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tf32.cuh"

namespace {

namespace tf = flash::tf;
namespace wg = flash::wg;
using flash::kLn2;
using flash::kLog2e;
using flash::Strides;
using flash::weight;
using tf::kR;

static_assert(tf::kStages == 2, "the ring below alternates two stages");

// ---- the forward ---------------------------------------------------------------

template <int DP, int W>
struct Layout {  // byte offsets in dynamic shared memory (after 1024-byte alignment)
  static constexpr int kQ = kR * DP * 4;  // one part of the q tile
  static constexpr int kK = W * DP * 4;   // one part of a k tile (row form)
  static constexpr int kV = DP * W * 4;   // one part of a v tile (column form)
  static constexpr int kStage = 2 * kK + 2 * kV;
  static constexpr int kRing = 2 * kQ;  // q big, small at 0; stage s at kRing + s kStage
  static constexpr int kBars = kRing + tf::kStages * kStage;  // q, then one per stage
  static constexpr int kBytes = kBars + (1 + tf::kStages) * 8 + 1024;
};

template <int DP, int W, bool kSeg>
__global__ void __launch_bounds__(tf::kThreads)
    flash_fwd_tf32(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, float* __restrict__ out,
                   float* __restrict__ l_out, float* __restrict__ m_out,
                   const int* __restrict__ seg, Strides so, int heads, int n, int d,
                   float scale) {
  using L = Layout<DP, W>;
  constexpr int KD = DP / 8;  // k8 slices of a head
  constexpr int KW = W / 8;   // k8 slices of a key tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kR;
  const int tiles = (n + W - 1) / W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int* sb = kSeg ? seg + static_cast<long long>(b) * n : nullptr;

  // the k and v tiles of key tile `tile` into stage s
  auto issue = [&](int tile, int s) {
    if (tid == 0) {
      uint64_t* bar = bars + 1 + s;
      const uint32_t at = base + L::kRing + s * L::kStage;
      wg::mbar_expect_tx(bar, L::kStage);
      for (int part = 0; part < 2; ++part) {
        tf::tma_tile(at + part * L::kK, &kmap, W, DP, 0, tile * W, 2 * bh + part, bar);
        tf::tma_tile(at + 2 * L::kK + part * L::kV, &vmap, DP, W, tile * W, 0, 2 * bh + part,
                     bar);
      }
    }
  };

  // q and the walk's first two tiles (thread 0 issues the copies on the
  // barriers it has just initialized; the __syncthreads publishes them)
  if (tid == 0) {
    tf::prefetch_map(&qmap);
    tf::prefetch_map(&kmap);
    tf::prefetch_map(&vmap);
    for (int i = 0; i < 1 + tf::kStages; ++i) wg::mbar_init(bars + i, 1);
    wg::mbar_init_fence();
    wg::mbar_expect_tx(bars, 2 * L::kQ);
    for (int part = 0; part < 2; ++part)
      tf::tma_tile(base + part * L::kQ, &qmap, kR, DP, 0, q0, 2 * bh + part, bars);
  }
  issue(0, 0);
  if (tiles > 1) issue(1, 1);  // both stages start free
  __syncthreads();

  int row_seg[2] = {0, 0};  // the ids of rows 16w + g and 16w + g + 8
  // the ids of the thread's key columns 8j + 2t + e of the walked tile, read
  // into registers a tile ahead of their use (0 past n)
  int key_ids[W / 4] = {};
  auto load_ids = [&](int tile, int (&dst)[W / 4]) {
#pragma unroll
    for (int j = 0; j < KW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = tile * W + 8 * j + 2 * t + e;
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
  wg::mbar_wait(bars, 0);
  uint32_t qb[KD][4], qs[KD][4];  // q's tf32 parts: the A operand of every S, in registers
  tf::load_a<KD>(qb, smem);
  tf::load_a<KD>(qs, smem + L::kQ);
  tf::fence_a(qb);
  tf::fence_a(qs);

  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    wg::mbar_wait(bars + 1 + s, phase);
    __syncthreads();  // the tile landed; every warp is done with the other stage
    if (it > 0 && it + 1 < tiles) issue(it + 1, s ^ 1);  // into the stage of tile it - 1
    int next_ids[W / 4] = {};
    if constexpr (kSeg) {
      if (it + 1 < tiles) load_ids(it + 1, next_ids);
    }
    const uint32_t kt = base + L::kRing + s * L::kStage, vt = kt + 2 * L::kK;

    // S = Q K^T: 64 queries x W keys
    float sc[W / 2];
    wg::wgmma_fence();
    tf::product_rs<W, KD>(sc, qb, qs, kt, L::kK, KD);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(sc);

    // the online softmax of rows 16w + g (+8), as in the bf16 kernel, in
    // fp32 throughout: a row sees every key of the tile (no mask) where the
    // tile lies below n and, with segment ids, all its keys share the row's
    const int key0 = it * W;
    bool whole = key0 + W <= n;
    int tile_id = 0;
    if constexpr (kSeg) {
      tile_id = __shfl_sync(0xffffffffu, key_ids[0], 0);
      bool same = true;
#pragma unroll
      for (int x = 0; x < W / 4; ++x) same = same && key_ids[x] == tile_id;
      whole = __all_sync(0xffffffffu, same) && whole;  // the warp's lanes hold all W keys
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool full = whole && (!kSeg || row_seg[hr] == tile_id);
      float mx = -INFINITY;
      if (full) {
#pragma unroll
        for (int i = 2 * hr; i < W / 2; i += 4) mx = fmaxf(mx, fmaxf(sc[i], sc[i + 1]));
      } else {
#pragma unroll
        for (int j = 0; j < KW; ++j)
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
      for (int j = 0; j < KW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hr + e;
          const float x = exp2f(fmaf(sc[i], scale2, -m_new));
          sc[i] = (full || sc[i] != -INFINITY) ? x : 0.f;
          sum += sc[i];
        }
      l[hr] = l[hr] * alpha[hr] + sum;
      m[hr] = m_new;
    }
    uint32_t pb[KW][4], ps[KW][4];  // p's tf32 parts: the A operand of P V
    tf::split_a<KW>(pb, ps, sc);
    tf::fence_a(pb);
    tf::fence_a(ps);

    // the tile's P V over its keys below n, all DP columns
    float pv[DP / 2];
    const int live = min(KW, (n - key0 + 7) / 8);
    wg::wgmma_fence();
    tf::product_rs<DP, KW>(pv, pb, ps, vt, L::kV, live);
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
    if constexpr (kSeg) {
#pragma unroll
      for (int x = 0; x < W / 4; ++x) key_ids[x] = next_ids[x];
    }
    if (++s == tf::kStages) {
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
  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 16 * warp + g + 8 * hr;
    if (qi >= n) continue;
    float* row = ob + qi * so.n;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c < d) row[c] = o[4 * j + 2 * hr + e] / l[hr];
      }
    if (l_out != nullptr && t == 0) {
      l_out[rb + qi] = l[hr];
      m_out[rb + qi] = m[hr] * kLn2;
    }
  }
}

}  // namespace

// q, k, v: device fp32 buffers read as (batch, heads, n, d) through the
// given element strides (3 per tensor: batch, head, row; the last dimension
// contiguous); out: written as (batch, heads, n, d) through its strides (the
// fourth triple); l_out, m_out: null, or both contiguous fp32 (batch, heads,
// n) buffers for the residuals; seg: null, or contiguous int32 (batch, n)
// segment ids; scratch: 3 * tf::copy_floats(batch, heads, n, DP) floats for
// the split copies (DP = 32 for d <= 32, else 64). 1 <= d <= 64, n >= 1, b h
// <= 65535. Launches the split pass (q, k in the row form, v in the column
// form) and then the forward, one CTA of 128 threads per (batch * head,
// block of 64 queries), on `stream`; returns the first launch error or
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd_tf32_launch(const void* q, const void* k, const void* v,
                                               void* scratch, void* out, void* l_out,
                                               void* m_out, const void* seg,
                                               const long long* strides, int batch, int heads,
                                               int n, int d, float scale, void* stream) {
  constexpr int W = 32;
  if (!tf::shape_ok(batch, heads, n, d) || (l_out == nullptr) != (m_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int bh = batch * heads;
  const auto* sp = static_cast<const int*>(seg);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tf::with_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const long long size = tf::copy_floats(batch, heads, n, DP);
    float* qr = static_cast<float*>(scratch);
    float *kr = qr + size, *vc = kr + size;
    const tf::SplitJobs jobs = {{{static_cast<const float*>(q), s[0], qr, nullptr},
                                 {static_cast<const float*>(k), s[1], kr, nullptr},
                                 {static_cast<const float*>(v), s[2], nullptr, vc}}};
    cudaError_t err = tf::split<DP>(jobs, 3, batch, heads, n, d, st);
    if (err != cudaSuccess) return err;
    CUtensorMap maps[3];
    if (!tf::encode_rows(&maps[0], qr, bh, n, DP, kR) ||
        !tf::encode_rows(&maps[1], kr, bh, n, DP, W) || !tf::encode_cols(&maps[2], vc, bh, n, DP))
      return cudaErrorInvalidValue;
    return flash::with_segments(sp, [&](auto segments) {
      return wg::launch<&flash_fwd_tf32<DP, W, decltype(segments)::value>>(
          Layout<DP, W>::kBytes, batch, heads, n, st, maps[0], maps[1], maps[2],
          static_cast<float*>(out), static_cast<float*>(l_out), static_cast<float*>(m_out), sp,
          s[3], heads, n, d, scale);
    });
  }));
}
