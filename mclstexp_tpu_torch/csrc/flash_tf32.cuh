// Building blocks of the fp32 flash-attention kernels that work on 64-row
// warpgroup tiles (sm_90a): wgmma.mma_async in tf32 with fp32 accumulators,
// every product in the 3xTF32 split, on tiles that TMA copies from split
// copies of the inputs, which the split pass (flash_tf32_split, below) writes
// ahead of each pass.
//
// Why split copies. A tf32 wgmma reads both shared-memory operands K-major
// only (the transpose flags exist for f16 and bf16 alone), and 3xTF32 needs
// every value as a tf32 big part and the tf32 small part of the rest (see
// flash_common.cuh). So each pass first writes, per (batch, head), the big
// and small parts of what its products read:
//   * the row form of x (b, h, n, d): float [b h][2][n_pad][DP], part 0 the
//     big parts, part 1 the small ones, zero past n and past d: the K-major
//     operand of a product that sums over d (q k^T, dout v^T);
//   * the column form: float [b h][2][DP][n_pad], x transposed, with the
//     rows of x in each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7
//     (col_pos): the K-major B operand of a product that sums over rows of
//     x (p v, p^T dout, ds^T q, ds k).
// n_pad is n rounded up to 64 and DP is d rounded up to 32 or 64, so every
// tile lies inside its array: no TMA box reaches past an edge, and inputs of
// any alignment and stride reach the kernels through one plain-load pass.
//
// The order of the column form is what lets a score tile feed the next
// product from registers. The wgmma accumulator of thread (warp w, lane 4g +
// t) holds row 16w + g (+8) at columns 8j + 2t and 8j + 2t + 1 of slice j;
// the register A operand of k8 slice j (tf32, m64k8) wants columns t and
// t + 4. With the rows of the B operand in the column form's order, logical
// column t is physical 2t and t + 4 is 2t + 1: the A operand is the
// thread's own accumulator registers (split_a), with no shuffle.
//
// Tiles in shared memory are the TMA's 128-byte swizzle: 32 fp32 columns
// (128 bytes) a panel, row r at r * 128 and its 16-byte chunk c at c ^ (r &
// 7), panels 1024-aligned and `rows` * 128 bytes apart; a wgmma descriptor
// (layout type 1) reads k8 slice kk at panel kk / 4, 32 bytes * (kk % 4)
// into the row (desc).
//
// Products. product_ss (A and B from shared memory) and product_rs (A from
// registers) issue the three terms of 3xTF32 as wgmma chains into one
// accumulator that starts at zero, the two small terms over all k8 slices
// first and big * big last: the tensor cores' fp32 sums truncate, and the
// small terms summed before the large ones lose nothing the split keeps. A
// chain never runs longer than one tile; running sums across tiles are
// fp32 adds (or the forward's fma with the rescale).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace flash {
namespace tf {

constexpr int kR = 64;         // owned rows: one warpgroup's wgmma M
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // depth of the ring of walked tiles

// n rounded up to whole tiles of 64: the split copies' rows
__host__ __device__ constexpr long long pad_rows(int n) { return (n + kR - 1LL) / kR * kR; }

// position of row r of x in the column form (within its group of 8: even
// rows 2t at t, odd rows 2t + 1 at t + 4), and its inverse
__host__ __device__ __forceinline__ int col_pos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}
__host__ __device__ __forceinline__ int col_row(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}

// The shapes the kernels take: 1 <= d <= 64, n >= 1 with at most 65535
// tiles of 64, b h <= 65535 (the split pass's grid).
inline bool shape_ok(int batch, int heads, int n, int d) {
  if (batch < 1 || heads < 1 || n < 1 || d < 1 || d > 64) return false;
  return pad_rows(n) / kR <= 65535 && static_cast<long long>(batch) * heads <= 65535;
}

// ---- descriptors and products ----------------------------------------------------

// k8 slice kk of a K-major tile of `ROWS` rows
template <int ROWS>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int kk) {
  return wg::desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// d (+)= a * b, m64n32k8 / m64n64k8, tf32 inputs, fp32 accumulators, A and B
// from shared memory
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a * b, m64n32k8 / m64n64k8, A from registers (rows 16w + g (+8),
// columns t (+4) of the k8 slice), B from shared memory
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// acc = A B^T over KS k8 slices in 3xTF32: A the 64-row tile at a (big
// part) and a + a_small (small part), B the BROWS-row tile at b and b +
// b_small; the small terms first, then big * big. Issues only: the caller
// fences before and commits and waits after.
template <int BROWS, int KS, int N>
__device__ __forceinline__ void product_ss(float (&acc)[N], uint32_t a, int a_small, uint32_t b,
                                           int b_small) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_ss(acc, desc<kR>(a + a_small, kk), desc<BROWS>(b, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_ss(acc, desc<kR>(a, kk), desc<BROWS>(b + b_small, kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_ss(acc, desc<kR>(a, kk), desc<BROWS>(b, kk), 1);
}

// acc = A B^T over the first `live` (>= 1) of KS k8 slices in 3xTF32: A in
// registers (big and small parts, split_a), B the BROWS-row tile at b and
// b + b_small; the small terms first. Issues only, as product_ss.
template <int BROWS, int KS, int N>
__device__ __forceinline__ void product_rs(float (&acc)[N], const uint32_t (&big)[KS][4],
                                           const uint32_t (&small)[KS][4], uint32_t b,
                                           int b_small, int live) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < live) mma_rs(acc, small[kk], desc<BROWS>(b, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < live) mma_rs(acc, big[kk], desc<BROWS>(b + b_small, kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < live) mma_rs(acc, big[kk], desc<BROWS>(b, kk), 1);
}

// acc = A B^T over KS k8 slices in 3xTF32 with A's big part in registers
// (load_a) and its small part the 64-row tile at a_small; B as product_ss.
template <int BROWS, int KS, int N>
__device__ __forceinline__ void product_mixed(float (&acc)[N], const uint32_t (&big)[KS][4],
                                              uint32_t a_small, uint32_t b, int b_small) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_ss(acc, desc<kR>(a_small, kk), desc<BROWS>(b, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs(acc, big[kk], desc<BROWS>(b + b_small, kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs(acc, big[kk], desc<BROWS>(b, kk), 1);
}

// The register A operand of the KS k8 slices of a 64-row tile in shared
// memory (the TMA's swizzle, panels of 32 columns): slice kk of thread
// (warp w, lane 4g + t) holds rows 16w + g (+8), columns 8kk + t (+4). Read
// once, where the owned side stays for the whole walk; a warp's 32 reads of
// one register fall in 32 banks.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const uint8_t* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + g;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = r0 + 8 * (x & 1), c = 8 * kk + t + 4 * (x >> 1);
      const int at = (c >> 5) * (kR * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                     ((c & 3) << 2);
      a[kk][x] = *reinterpret_cast<const uint32_t*>(tile + at);
    }
}

// The register A operands (big and small parts) of the KS k8 slices of a
// 64 x 8KS fp32 accumulator x: slice j takes the thread's columns 8j + 2t
// (as logical column t) and 8j + 2t + 1 (as t + 4), which the B operand's
// column form puts there.
template <int KS>
__device__ __forceinline__ void split_a(uint32_t (&big)[KS][4], uint32_t (&small)[KS][4],
                                        const float (&x)[4 * KS]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const float v[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hi, lo;
      split_tf32(v[i], hi, lo);
      big[j][i] = __float_as_uint(hi);
      small[j][i] = __float_as_uint(lo);
    }
  }
}

// Keeps the compiler from computing register A operands between the
// asynchronous products that read them: the operands are complete before
// wgmma_fence (each kernel ran ~1% faster with it at (1, 16, 4096, 64)).
template <int KS>
__device__ __forceinline__ void fence_a(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[kk][x])::"memory");
}

// ---- TMA ------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Box (32 columns, the map's rows) at column x, row y of matrix z into
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

// All `rows` rows of a tile of `cols` (a multiple of 32) columns at column
// x0, row y of matrix z: one box per panel, panel p at dst + p * rows * 128.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int rows,
                                         int cols, int x0, int y, int z, uint64_t* bar) {
  for (int p = 0; p < cols / 32; ++p) tma_load(dst + p * rows * 128, map, x0 + 32 * p, y, z, bar);
}

// W 4-byte values src[r0..r0+W) into dst, asynchronously, zero past n;
// threads [first, first + W) copy.
template <int W>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int r0, int n,
                                          int first) {
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < W) {
    const int r = r0 + i;
    cp_async4(dst + i, r < n ? src + r : src, r < n);
  }
}

// ---- host ---------------------------------------------------------------------

// The TMA map of `count` back-to-back fp32 matrices of rows x cols (the
// split copies: count = 2 b h), boxes of 32 columns x box_rows rows, the
// 128-byte swizzle. False where cuTensorMapEncodeTiled refuses it.
inline bool encode_matrices(CUtensorMap* map, const void* base, int count, long long rows,
                            long long cols, int box_rows) {
  const wg::EncodeTiled encode = wg::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(count)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows * cols) * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The row form of a split copy (n_pad x DP matrices) in boxes of box_rows
// rows, and the column form (DP x n_pad) in boxes of 32 rows of x by DP.
inline bool encode_rows(CUtensorMap* map, const void* base, int bh, int n, int dp, int box_rows) {
  return encode_matrices(map, base, 2 * bh, pad_rows(n), dp, box_rows);
}
inline bool encode_cols(CUtensorMap* map, const void* base, int bh, int n, int dp) {
  return encode_matrices(map, base, 2 * bh, dp, pad_rows(n), dp);
}

// go(DP) for the tile width of d: std::integral_constant 32 or 64
template <typename Go>
cudaError_t with_width(int d, Go go) {
  if (d <= 32) return go(std::integral_constant<int, 32>{});
  return go(std::integral_constant<int, 64>{});
}

// ---- the split pass -------------------------------------------------------------

constexpr int kSplitRows = 32;
constexpr int kSplitThreads = 256;
constexpr int kMaxJobs = 4;

// One input of the split pass: its split copies in the row form (`rows`)
// and in the column form (`cols`), either null to skip.
struct SplitJob {
  const float* src;
  Strides s;
  float* rows;
  float* cols;
};
struct SplitJobs {
  SplitJob job[kMaxJobs];
};

// Rows [32 x, 32 x + 32) of one (batch, head) of input z into its split
// copies; zero past n and past d. A plain-load pass: any alignment and
// strides (the last dimension contiguous).
template <int DP>
__global__ void __launch_bounds__(kSplitThreads)
    flash_tf32_split(const __grid_constant__ SplitJobs jobs, int heads, int n, int d) {
  __shared__ float tile[kSplitRows][DP + 1];
  const SplitJob& job = jobs.job[blockIdx.z];
  const long long bh = blockIdx.y;
  const long long b = bh / heads, h = bh - b * heads;
  const int r0 = blockIdx.x * kSplitRows;
  const float* src = job.src + b * job.s.b + h * job.s.h;
  for (int i = threadIdx.x; i < kSplitRows * DP; i += kSplitThreads) {
    const int r = i / DP, c = i % DP;
    tile[r][c] = r0 + r < n && c < d ? src[(r0 + r) * job.s.n + c] : 0.f;
  }
  __syncthreads();
  const long long n_pad = pad_rows(n), plane = n_pad * DP;  // one part of one head
  if (job.rows != nullptr) {
    float* big = job.rows + 2 * bh * plane + static_cast<long long>(r0) * DP;
    for (int i = threadIdx.x; i < kSplitRows * DP; i += kSplitThreads) {
      float hi, lo;
      split_tf32(tile[i / DP][i % DP], hi, lo);
      big[i] = hi;
      big[plane + i] = lo;
    }
  }
  if (job.cols != nullptr) {
    float* big = job.cols + 2 * bh * plane + r0;
    for (int i = threadIdx.x; i < kSplitRows * DP; i += kSplitThreads) {
      const int c = i / kSplitRows, p = i % kSplitRows;  // row c of x^T, position r0 + p
      float hi, lo;
      split_tf32(tile[col_row(p)][c], hi, lo);
      big[c * n_pad + p] = hi;
      big[plane + c * n_pad + p] = lo;
    }
  }
}

// Floats of one split copy (either form) of a (b, h, n, d) input.
inline long long copy_floats(int batch, int heads, int n, int dp) {
  return 2LL * batch * heads * pad_rows(n) * dp;
}

// One launch of the split pass over jobs[0..count).
template <int DP>
cudaError_t split(const SplitJobs& jobs, int count, int batch, int heads, int n, int d,
                  cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(pad_rows(n) / kSplitRows),
                  static_cast<unsigned>(batch * heads), static_cast<unsigned>(count));
  flash_tf32_split<DP><<<grid, kSplitThreads, 0, stream>>>(jobs, heads, n, d);
  return cudaGetLastError();
}

}  // namespace tf
}  // namespace flash
