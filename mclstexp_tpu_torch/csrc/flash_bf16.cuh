// Building blocks of the bfloat16 flash-attention dQ kernel for Hopper
// (sm_90a; the bf16 forward and dK/dV are warpgroup kernels built from
// flash_wgmma.cuh): bf16 tiles in shared memory, multiplied on the tensor
// cores with mma.sync m16n8k16 on bf16 operands with fp32 accumulators, one
// pass per product where the fp32 kernels' 3xTF32 takes three.
//
// Tiles. A tile is kRows x D bf16 values (D = 32, 64 or 128), row r at
// r * (D + 8): each row is padded by one 16-byte chunk, so the row stride is
// D / 2 + 4 words and the fragment reads below fall in distinct banks
// (8 rows of 4 words: 4g + t; 4 rows of 8 words: 8t + g / 2) without a
// swizzle. Values are kept as their raw 16 bits (uint16_t).
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16; lane = 4 g + t):
//   A 16 x 16, row major: a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g,
//     2t + 8..), a3 = (g + 8, 2t + 8..);
//   B 16 x 8: b0 = (rows 2t, 2t + 1; column g), b1 = (rows 2t + 8, 2t + 9);
//   C 16 x 8 fp32: c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..).
// Each 32-bit register holds two bf16 values, the lower index in the lower
// half.
//
// The C entry points, plan and launch are flash_common.cuh's; the kernels
// are their own (not a type parameter of the fp32 ones), so the fp32
// kernels compile to what they did.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {
namespace bf16 {

constexpr int kPad = 8;  // bf16 values of padding per tile row: one 16-byte chunk

template <int D>
struct Tile {
  static constexpr int kStride = D + kPad;        // bf16 values per row
  static constexpr int kElems = kRows * kStride;  // bf16 values of a tile
};

// round to nearest even, what XLA's convert (and the library's astype) does
__device__ __forceinline__ uint16_t from_float(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [r0, r0 + kRows) of an (n, d) bf16 matrix with row stride `stride`
// (elements; the last dimension contiguous) into a tile of width D, zero
// past n and past d; all kThreads threads take part. kVec: 16-byte
// cp.async copies (8 values), which need d % 8 == 0, a 16-byte aligned src
// and stride % 8 == 0 (the launcher checks); otherwise 2-byte loads and
// stores, synchronous (cp.async has no 2-byte form). Either way the values
// are visible to other threads after the caller's cp_async_wait and a
// barrier.
template <int D, bool kVec>
__device__ __forceinline__ void stage_rows(uint16_t* tile, const uint16_t* src, long long stride,
                                           int r0, int n, int d) {
  constexpr int S = Tile<D>::kStride;
  constexpr int kWidth = kVec ? 8 : 1;  // values per copy
  constexpr int kCopies = kRows * D / kWidth;  // 128 at D = 32 with kVec: half the threads
#pragma unroll 4
  for (int i = threadIdx.x; i < kCopies; i += kThreads) {
    const int r = i / (D / kWidth), c = i % (D / kWidth) * kWidth;
    const bool ok = r0 + r < n && c < d;
    if constexpr (kVec) {
      cp_async16(tile + r * S + c, ok ? src + (r0 + r) * stride + c : src, ok);
    } else {
      tile[r * S + c] = ok ? src[(r0 + r) * stride + c] : uint16_t{0};
    }
  }
}

// one 32-bit word of a tile: values (r, c) and (r, c + 1), c even
__device__ __forceinline__ uint32_t word(const uint16_t* tile, int stride, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(tile + r * stride + c);
}

// values (r, c) and (r + 1, c) as one register (the B layout down a column)
__device__ __forceinline__ uint32_t column_pair(const uint16_t* tile, int stride, int r, int c) {
  return static_cast<uint32_t>(tile[r * stride + c]) |
         (static_cast<uint32_t>(tile[(r + 1) * stride + c]) << 16);
}

// A, 16 x 16 at rows m0.., columns k0.. of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile, int stride, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  a[0] = word(tile, stride, m0 + g, k0 + 2 * t);
  a[1] = word(tile, stride, m0 + g + 8, k0 + 2 * t);
  a[2] = word(tile, stride, m0 + g, k0 + 2 * t + 8);
  a[3] = word(tile, stride, m0 + g + 8, k0 + 2 * t + 8);
}

// B, 16 x 8, B[k][j] = tile[n0 + j][k0 + k] (a product with a tile's
// transpose): two words of row n0 + g
__device__ __forceinline__ void load_b_t(uint32_t (&b)[2], const uint16_t* tile, int stride,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  b[0] = word(tile, stride, n0 + g, k0 + 2 * t);
  b[1] = word(tile, stride, n0 + g, k0 + 2 * t + 8);
}

// B, 16 x 8, B[k][j] = tile[k0 + k][n0 + j]: pairs down column n0 + g
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const uint16_t* tile, int stride, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  b[0] = column_pair(tile, stride, k0 + 2 * t, n0 + g);
  b[1] = column_pair(tile, stride, k0 + 2 * t + 8, n0 + g);
}

// c += a * b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's kN accumulator fragments of 16 x 8 into a row-major fp32 block
// of width W at rows m0.., columns c0..
template <int W, int kN>
__device__ __forceinline__ void store_acc(float* block, const float (&acc)[kN][4], int m0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(block + (m0 + g) * W + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(block + (m0 + g + 8) * W + c) = make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace bf16
}  // namespace flash
