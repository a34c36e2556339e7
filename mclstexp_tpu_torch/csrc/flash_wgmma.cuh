// Building blocks of the Hopper (sm_90a) bf16 flash-attention kernels that
// work on 64-row warpgroup tiles: wgmma.mma_async on shared-memory tiles in
// the 128-byte swizzled layout, the tensor memory accelerator (TMA) and
// mbarriers that fill them, and the plain-load staging of the same layout
// for inputs TMA cannot take.
//
// Tiles. A tile is 64 rows x DP bf16 columns (DP = 64 for d <= 64, 128 for
// d <= 128; columns past d are zero), kept as DP / 64 column panels of 64
// rows x 128 bytes, panel p at p * 8192 bytes. In a panel, row r is at r *
// 128 bytes and its 16-byte chunk c (columns 8c..8c+7) is stored at chunk c
// ^ (r & 7): the 128-byte swizzle that a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B writes and that a wgmma descriptor of layout
// type 1 reads. Panels start at multiples of 1024 bytes, so the swizzle
// (address bits 4-6 XOR bits 7-9) is a function of the row alone.
//
// Products (PTX ISA, wgmma, .bf16 with .f32 accumulators; warpgroup = 4
// warps, lane = 4 g + t of warp w):
//   * the accumulator of m64nNk16 holds, in register 4j + 2h + e of thread
//     (w, g, t), row 16w + g + 8h and column 8j + 2t + e;
//   * an A operand in registers for k16 slice kk holds rows 16w + g (+8),
//     columns 16kk + 2t (+1, +8, +9) packed in pairs: registers 4(2kk) ..
//     4(2kk) + 3 and 4(2kk + 1) .. of an fp32 accumulator become its four
//     words (pack_a), so a score tile turns into the A operand of the next
//     product without leaving registers;
//   * K-major operands (a tile's rows are M or N, its columns K) are read
//     by descriptors whose start moves 32 bytes per k16 slice inside a
//     panel; MN-major B operands (rows K, columns N: v, dout, q and k read
//     as the right factor) by descriptors whose start moves 16 rows (2048
//     bytes) per k16 slice, with the 64-column panels 8192 bytes apart
//     (LBO) and 8-row groups 1024 bytes apart (SBO).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace flash {
namespace wg {

constexpr int kR = 64;            // rows of every tile, owned or walked
constexpr int kThreads = 128;     // one warpgroup
constexpr int kStages = 2;        // depth of the ring of walked tiles
constexpr int kPanelBytes = 8192; // 64 rows x 128 bytes

// byte offset of element (r, c) in a swizzled tile
__host__ __device__ __forceinline__ int swizzled(int r, int c) {
  return (c >> 6) * kPanelBytes + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// The shapes and plans the kernels take: 1 <= d <= 128, n >= 1 with at most
// 65535 tiles of 64, b * h < 2^31, rows == 64 and split == 1 (one CTA walks
// the whole other side).
inline bool plan_ok(int batch, int heads, int n, int d, int rows, int split) {
  if (batch < 1 || heads < 1 || n < 1 || d < 1 || d > 128 || rows != kR || split != 1)
    return false;
  const long long tiles = (static_cast<long long>(n) + kR - 1) / kR;
  return tiles <= 65535 && static_cast<long long>(batch) * heads <= 0x7fffffffLL;
}

// ---- descriptors and products ---------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);  // 128-byte swizzle
}

// K-major operand: the 64 rows of a tile, k16 slice kk (columns 16kk..)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: rows 16kk..16kk+15 of a tile as K, all its columns as N
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (after wgmma_wait, before wgmma_fence).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// round to nearest even, what XLA's convert (and the library's astype) does
__device__ __forceinline__ uint16_t from_float(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two floats as one register of two bf16 (lo in the lower half), each
// rounded to nearest even (as from_float) by one cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The A operand of k16 slice kk from the fp32 accumulator of a 64 x 64 score
// tile, rounded to bf16 (round to nearest even)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[32], int kk) {
  a[0] = pack2(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack2(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack2(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack2(s[8 * kk + 6], s[8 * kk + 7]);
}

// 2^x on the special-function unit (ex2.approx.ftz: results below 2^-126
// flush to 0, where they would round away in the bf16 p anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= a * b, m64n64k16, A and B from shared memory (K-major), fp32 accumulators
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a * b, m64n64k16, A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a * b, m64n128k16, A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a * b over the tile's DP columns: m64n64k16 or m64n128k16
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, b, scale_d);
  } else {
    wgmma_rs_n128(d, a, b, scale_d);
  }
}

// ---- the outputs ---------------------------------------------------------------

// bf16 values x0, x1 at columns c, c + 1 (c even) of a row, those below d;
// one 4-byte store where `pairs` (d, the row stride and the base even).
__device__ __forceinline__ void store_pair(uint16_t* row, int c, int d, float x0, float x1,
                                           bool pairs) {
  if (pairs) {
    if (c < d) *reinterpret_cast<uint32_t*>(row + c) = pack2(x0, x1);
  } else {
    if (c < d) row[c] = from_float(x0);
    if (c + 1 < d) row[c + 1] = from_float(x1);
  }
}

__device__ __forceinline__ bool pairs_ok(const uint16_t* base, long long row_stride, int d) {
  return ((d | row_stride) & 1) == 0 && (reinterpret_cast<uintptr_t>(base) & 3) == 0;
}

// ---- mbarriers and TMA ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the async proxy (wgmma) before a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One view of a (b, h, n, d) bf16 tensor for TMA: the tensor map (d first,
// then n, h, b in the order of their strides) and the slots of n, h and b in
// its coordinates (2 bits each).
struct View {
  CUtensorMap map;
  int slots;
};

// Fetch a view's tensor map ahead of its first copy (it lives in the
// kernel's parameters; the first copy would otherwise wait for it).
__device__ __forceinline__ void prefetch_view(const View& view) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&view.map))
               : "memory");
}

// Box (64 columns, 64 rows) of the view at column c, rows r.., head h,
// batch b into `dst` (a panel), completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const View& view, int c, int r, int h,
                                         int b, uint64_t* bar) {
  const int sr = view.slots & 3, sh = (view.slots >> 2) & 3;
  int x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = (i + 1 == sr) ? r : (i + 1 == sh) ? h : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&view.map)), "r"(c), "r"(x[0]), "r"(x[1]), "r"(x[2]),
      "r"(smem_addr(bar))
      : "memory");
}

// Rows [r0, r0 + 64) of an (n, d) bf16 matrix with row stride `stride`
// (elements) into a swizzled tile of width DP by 2-byte loads and stores
// (any d, alignment and stride), zero past n and past d; the 128 threads
// take part. The caller fences (fence_proxy_async) and synchronizes before
// a product reads the tile.
template <int DP>
__device__ __forceinline__ void stage_tile(uint8_t* tile, const uint16_t* src, long long stride,
                                           int r0, int n, int d) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kR * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const bool ok = r0 + r < n && c < d;
    *reinterpret_cast<uint16_t*>(tile + swizzled(r, c)) = ok ? src[(r0 + r) * stride + c] : 0;
  }
}

// 64 consecutive 4-byte values src[r0..r0+64) into dst, asynchronously,
// zero past n; threads [first, first + 64) copy.
__device__ __forceinline__ void stage_row64(float* dst, const float* src, int r0, int n,
                                            int first) {
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < kR) {
    const int r = r0 + i;
    cp_async4(dst + i, r < n ? src + r : src, r < n);
  }
}

// ---- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, once: the
// library links no -lcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Whether TMA takes a (b, h, n, d) bf16 view at `ptr` with element strides
// s: d % 8 == 0, a 16-byte aligned base, and the stride of every dimension
// longer than 1 a multiple of 8 elements (16 bytes).
inline bool tma_ok(const void* ptr, Strides s, int batch, int heads, int n, int d) {
  return d % 8 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (batch == 1 || s.b % 8 == 0) && (heads == 1 || s.h % 8 == 0) && (n == 1 || s.n % 8 == 0);
}

// The TMA view of a (b, h, n, d) bf16 tensor: a 4-d map over (d, and n, h,
// b ordered by stride, dimensions of extent 1 last), boxes of 64 x 64 with
// the 128-byte swizzle, zero fill out of bounds (rows past n, columns past
// d). Returns false where the driver refuses it.
inline bool encode_view(View* view, const void* ptr, Strides s, int batch, int heads, int n,
                        int d) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long ext[3] = {n, heads, batch}, st[3] = {s.n, s.h, s.b};
  int order[3] = {0, 1, 2};
  auto before = [&](int i, int j) {  // extent-1 dimensions last, else by stride
    if ((ext[i] == 1) != (ext[j] == 1)) return ext[j] == 1;
    return ext[i] != 1 && st[i] < st[j];
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(order[j], order[j - 1]); --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0}, strides[3];
  cuuint64_t span = static_cast<cuuint64_t>(d) * 2;  // bytes covered so far, for extent-1 dims
  int slots = 0;
  for (int k = 0; k < 3; ++k) {
    const int i = order[k];
    dims[k + 1] = static_cast<cuuint64_t>(ext[i]);
    cuuint64_t bytes = static_cast<cuuint64_t>(st[i]) * 2;
    if (ext[i] == 1) bytes = (span + 15) / 16 * 16;
    strides[k] = bytes;
    span = bytes * dims[k + 1] > span ? bytes * dims[k + 1] : span;
    slots |= (k + 1) << (2 * i);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  cuuint32_t boxes[4] = {64, 1, 1, 1};  // 64 columns; 64 rows in the n dimension's slot
  boxes[slots & 3] = kR;
  view->slots = slots;
  return encode(&view->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The element strides (b, h, n) of `count` views, three per view.
inline void read_strides(Strides* s, const long long* strides, int count) {
  for (int i = 0; i < count; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The TMA views of the `count` inputs where every one passes tma_ok (*tma
// true), else none (*tma false: the launch takes the plain-load variant).
// Returns false where the driver refuses a view.
inline bool encode_views(View* views, bool* tma, const void* const* inputs, const Strides* s,
                         int count, int batch, int heads, int n, int d) {
  *tma = true;
  for (int i = 0; i < count; ++i) *tma = *tma && tma_ok(inputs[i], s[i], batch, heads, n, d);
  for (int i = 0; *tma && i < count; ++i)
    if (!encode_view(&views[i], inputs[i], s[i], batch, heads, n, d)) return false;
  return true;
}

// The variant a launcher runs: go(DP, kTma), DP the tile width of d
// (std::integral_constant 64 for d <= 64, else 128) and kTma whether the
// inputs have TMA views (std::true_type or std::false_type).
template <typename Go>
cudaError_t with_variant(int d, bool tma, Go go) {
  using W64 = std::integral_constant<int, 64>;
  using W128 = std::integral_constant<int, 128>;
  if (d <= 64) return tma ? go(W64{}, std::true_type{}) : go(W64{}, std::false_type{});
  return tma ? go(W128{}, std::true_type{}) : go(W128{}, std::false_type{});
}

// One launch of Kernel(args...) on a grid of (batch * heads, ceil(n / 64))
// blocks of 128 threads with `smem` bytes of dynamic shared memory.
template <auto Kernel, typename... Args>
cudaError_t launch(int smem, int batch, int heads, int n, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim =
      dim3(static_cast<unsigned>(batch * heads), static_cast<unsigned>((n + kR - 1) / kR));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  err = cudaLaunchKernelEx(&config, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace wg
}  // namespace flash
