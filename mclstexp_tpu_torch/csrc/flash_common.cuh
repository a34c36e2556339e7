// Building blocks of the flash-attention kernels for Hopper (sm_90a): fp32
// tiles in shared memory, staged by cp.async, multiplied on the tensor cores
// with mma.sync m16n8k8 in the 3xTF32 split, which keeps fp32 accuracy.
//
// 3xTF32. A tf32 operand keeps 10 of fp32's 23 mantissa bits. Each fp32
// value x is split into big = rna_tf32(x) and small = rna_tf32(x - big)
// (x - big is exact in fp32), and a product a*b is accumulated in fp32 as
// big_a*big_b + (small_a*big_b + big_a*small_b); the dropped
// small_a*small_b is ~2^-22 of the product. One TF32 product keeps ~3
// decimal digits. The rounding is explicit: mma reads raw fp32 bits as tf32
// by truncation. Values are split once, where they land in shared memory:
// a tile keeps its big parts in place (as floats whose low 13 bits are 0)
// and its small parts in a second tile.
//
// Tiles. A tile is `rows` x D floats (D a power of two, >= 32), row r at
// r * D, with the 4-float chunks of row r permuted by an XOR with
// (r & 3) << 3 | ((r >> 2) & 1) << 2. Both fragment reads of m16n8k8 (8
// rows x 4 columns, and 4 rows x 8 columns, per warp) then fall in 32
// different banks, and chunks stay whole: a chunk is one 16-byte copy and
// one ldmatrix row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// index of element (r, c) in a tile of row width D
template <int D>
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * D + (c ^ (((r & 3) << 3) | (((r >> 2) & 1) << 2)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read but must be a mapped address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight; the
// thread then sees its own copies (other threads' after a barrier)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as its tf32 big part and the tf32 small part of the rest
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(x - __uint_as_float(b)));
  big = __uint_as_float(b);
  small = __uint_as_float(s);
}

// Rows [r0, r0 + ROWS) of an (n, d) fp32 matrix with row stride `stride`
// (elements; the last dimension contiguous) into tile `hi`, zero past n
// and past d; all THREADS threads of the block take part. kVec: 16-byte
// copies, which need d % 4 == 0 and a 16-byte aligned src with stride % 4
// == 0 (the launcher checks); otherwise 4-byte copies.
template <int ROWS, int D, int THREADS, bool kVec>
__device__ __forceinline__ void stage_rows(float* hi, const float* src, long long stride,
                                           int r0, int n, int d) {
  constexpr int kWidth = kVec ? 4 : 1;  // floats per copy
  static_assert(ROWS * D % (THREADS * kWidth) == 0, "whole copies per thread");
#pragma unroll 4
  for (int it = 0; it < ROWS * D / kWidth / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / (D / kWidth), c = i % (D / kWidth) * kWidth;
    const bool ok = r0 + r < n && c < d;
    const float* from = ok ? src + (r0 + r) * stride + c : src;
    if constexpr (kVec) {
      cp_async16(hi + tile_at<D>(r, c), from, ok);
    } else {
      cp_async4(hi + tile_at<D>(r, c), from, ok);
    }
  }
}

// The values this thread staged with stage_rows<ROWS, D, THREADS, kVec>
// (the same walk), once cp_async_wait says they landed: each becomes its
// big part in place, its small part at the same index of `lo`.
template <int ROWS, int D, int THREADS, bool kVec>
__device__ __forceinline__ void split_staged(float* hi, float* lo) {
  if constexpr (kVec) {
#pragma unroll
    for (int it = 0; it < ROWS * D / 4 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int at = tile_at<D>(i / (D / 4), i % (D / 4) * 4);
      float4 x = *reinterpret_cast<float4*>(hi + at), s;
      split_tf32(x.x, x.x, s.x);
      split_tf32(x.y, x.y, s.y);
      split_tf32(x.z, x.z, s.z);
      split_tf32(x.w, x.w, s.w);
      *reinterpret_cast<float4*>(hi + at) = x;
      *reinterpret_cast<float4*>(lo + at) = s;
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * D / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int at = tile_at<D>(i / D, i % D);
      split_tf32(hi[at], hi[at], lo[at]);
    }
  }
}

// an mma operand fragment as its tf32 big and small parts
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

// ldmatrix of 8 x 8 b16 matrices reads 8 rows of 16 bytes each: read as
// 32-bit values, thread 4 * g + t gets row g, column t of an 8 x 4 block,
// the tf32 fragment layout of mma.m16n8k8. "memory": the tiles are written
// by other threads between barriers.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row))
               : "memory");
}

// Fragments of mma.m16n8k8 (lane = 4 * g + t) from a split tile (hi, lo)
// of width W. The swizzle's XOR touches column bits 2-4 only, so a thread
// computes its addresses once: for columns 8j + col (j = 0..3) of its row,
// and the fragment at column k0 (a multiple of 8) sits at
// off[(k0 >> 3) & 3] + (k0 & ~31), which unrolled loops turn into
// immediates.
template <int W>
struct Frag {
  int off[4];
  __device__ __forceinline__ Frag(int row, int col) {
#pragma unroll
    for (int j = 0; j < 4; ++j) off[j] = tile_at<W>(row, 8 * j + col);
  }
  __device__ __forceinline__ int at(int k0) const { return off[(k0 >> 3) & 3] + (k0 & ~31); }
};

// A, 16 x 8 row-major, rows m0 + g (+8), columns k0 + t (+4): ldmatrix x4,
// lane l giving row l & 7 of matrix l >> 3 (rows +8, then columns +4).
template <int W>
__device__ __forceinline__ Frag<W> frag_a(int m0) {
  const int lane = threadIdx.x & 31;
  return Frag<W>(m0 + (lane & 15), (lane >> 4) << 2);
}

// B, 8 x 8 (k x n), where B[k][n] = tile[n0 + n][k0 + k] (a product with a
// tile's transpose): ldmatrix x2.
template <int W>
__device__ __forceinline__ Frag<W> frag_bt(int n0) {
  const int lane = threadIdx.x & 31;
  return Frag<W>(n0 + (lane & 7), ((lane >> 3) & 1) << 2);
}

template <int W>
__device__ __forceinline__ Split<4> load_a(const float* hi, const float* lo, const Frag<W>& f,
                                           int k0) {
  Split<4> s;
  ldsm_x4(s.big, hi + f.at(k0));
  ldsm_x4(s.small, lo + f.at(k0));
  return s;
}

template <int W>
__device__ __forceinline__ Split<2> load_b_t(const float* hi, const float* lo,
                                             const Frag<W>& f, int k0) {
  Split<2> s;
  ldsm_x2(s.big, hi + f.at(k0));
  ldsm_x2(s.small, lo + f.at(k0));
  return s;
}

// B, 8 x 8 (k x n), where B[k][n] = tile[k0 + k][n0 + n]: rows k0 + t (+4),
// column n0 + g; for k0 a multiple of 8 the row's swizzle is that of t, so
// the fragment at k0 sits k0 * W past the one at 0.
template <int W>
struct FragB {
  int o0, o1;
  __device__ __forceinline__ FragB() {}
  __device__ __forceinline__ explicit FragB(int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    o0 = tile_at<W>(t, n0 + g);
    o1 = tile_at<W>(t + 4, n0 + g);
  }
};

template <int W>
__device__ __forceinline__ Split<2> load_b(const float* hi, const float* lo, const FragB<W>& f,
                                           int k0) {
  const int a0 = f.o0 + k0 * W, a1 = f.o1 + k0 * W;
  return Split<2>{{__float_as_uint(hi[a0]), __float_as_uint(hi[a1])},
                  {__float_as_uint(lo[a0]), __float_as_uint(lo[a1])}};
}

// c += a * b on the tensor cores; no side effects, so the compiler may
// schedule it freely around the loads.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a * b in 3xTF32 on 16 x 8 fp32 fragments (element i at row g + 8 *
// (i >> 1), column 2 * t + (i & 1)), in three accumulators: acc[0] +=
// a.big * b.big, acc[1] += a.small * b.big, acc[2] += a.big * b.small; the
// product is acc[0] + (acc[1] + acc[2]) (``sum3``). The tensor cores' fp32
// sums truncate (each mma may drop the low bits of its inputs below the
// largest one's last place), so a long chain into one accumulator drifts
// toward zero; three chains keep the small terms beside sums of their own
// size, and run side by side. Callers keep chains short (a tile) and add
// tiles with fp32 adds.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[3][4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(acc[1], a.small, b.big);
  mma_tf32(acc[2], a.big, b.small);
  mma_tf32(acc[0], a.big, b.big);
}

__device__ __forceinline__ float sum3(const float (&acc)[3][4], int i) {
  return acc[0][i] + (acc[1][i] + acc[2][i]);
}

}  // namespace flash
