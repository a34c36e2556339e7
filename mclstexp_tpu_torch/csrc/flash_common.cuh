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
// by truncation. A value is split either once, where it lands in shared
// memory (a tile keeps its big parts in place, as floats whose low 13 bits
// are 0, and its small parts in a second tile), or in registers where its
// fragment is read from a raw tile (split_pair), which halves the tile's
// shared-memory traffic when few warps read each value.
//
// Tiles. A tile is `rows` x D floats (D a power of two, >= 32), row r at
// r * D, with the 4-float chunks of row r permuted by an XOR with
// (r & 3) << 3 | ((r >> 2) & 1) << 2. Both fragment reads of m16n8k8 (8
// rows x 4 columns, and 4 rows x 8 columns, per warp) then fall in 32
// different banks, and chunks stay whole: a chunk is one 16-byte copy and
// one ldmatrix row.
//
// The plan and the launch. Every flash kernel owns blocks of kRows = 32
// rows (queries or keys) and splits its walk over the other side's tiles
// among `split` CTAs of one thread-block cluster (1 <= split <= 8, the
// portable cluster size, and at most the number of tiles); the caller's
// plan (ops/flash_attention.cluster_plan) picks split. Segment ids, where
// given, are staged beside the walked tiles of their rows (stage_ids); a
// thread reads those of the rows it owns once. launch_cluster
// launches a kernel on a grid of (batch * heads * split, ceil(n / 32))
// blocks of kThreads in clusters of (split, 1, 1), after allowing its
// dynamic shared memory once per kernel variant and device.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace flash {

constexpr int kRows = 32;      // rows of every tile, owned or walked
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxSplit = 8;   // the portable cluster size

struct Strides {
  long long b, h, n;  // in elements; the head dimension is contiguous
};

// The shapes and plans the kernels take: 1 <= d <= 128, n >= 1 with at most
// 65535 tiles, rows == 32 and 1 <= split <= min(8, tiles).
inline bool plan_ok(int batch, int heads, int n, int d, int rows, int split) {
  if (batch < 1 || heads < 1 || n < 1 || d < 1 || d > 128 || rows != kRows) return false;
  const long long tiles = (static_cast<long long>(n) + kRows - 1) / kRows;
  return tiles <= 65535 && split >= 1 && split <= kMaxSplit && split <= tiles &&
         static_cast<long long>(batch) * heads * split <= 0x7fffffffLL;
}

// 16-byte staging: d and the strides (3 per input) multiples of 4 floats,
// and every input 16-byte aligned.
inline bool vec_ok(const void* const* ptrs, const long long* strides, int count, int d) {
  if (d % 4 != 0) return false;
  for (int i = 0; i < count; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 4 != 0) return false;
  }
  return true;
}

// Allow `bytes` of dynamic shared memory to Kernel, once per device (the
// attribute belongs to the kernel in that device's context); later calls
// return the first call's result.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t result[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kDevices)
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  std::call_once(once[device], [&] {
    result[device] =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
  return result[device];
}

// One launch of Kernel(args...) on a grid of (batch * heads * split,
// ceil(n / 32)) blocks of kThreads in clusters of (split, 1, 1), with
// `smem_floats` floats of dynamic shared memory. Returns the launch's error
// or cudaGetLastError().
template <auto Kernel, typename... Args>
cudaError_t launch_cluster(int smem_floats, int batch, int heads, int n, int split,
                           cudaStream_t stream, Args... args) {
  const size_t smem = static_cast<size_t>(smem_floats) * sizeof(float);
  cudaError_t err = allow_smem<Kernel>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch * heads * split),
                        static_cast<unsigned>((n + kRows - 1) / kRows));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the D and staging variant for d and the inputs, then fn<D, kVec>(...)
#define FLASH_DISPATCH(fn, vec, d, ...)                                              \
  ((d) <= 32   ? ((vec) ? fn<32, true>(__VA_ARGS__) : fn<32, false>(__VA_ARGS__))    \
   : (d) <= 64 ? ((vec) ? fn<64, true>(__VA_ARGS__) : fn<64, false>(__VA_ARGS__))    \
               : ((vec) ? fn<128, true>(__VA_ARGS__) : fn<128, false>(__VA_ARGS__)))

// The segment-id variant: go(std::true_type{}) for non-null ids, else
// go(std::false_type{}); each kernel takes it as its kSeg template flag, so
// a launch without ids runs code without the branch.
template <typename Go>
cudaError_t with_segments(const int* seg, Go go) {
  return seg != nullptr ? go(std::true_type{}) : go(std::false_type{});
}

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

// Scores in log2 units: exp(x) = exp2(x log2 e); m back in natural units
// by ln 2.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// exp(m_i - m) for maxima in log2 units: the weight of a partial (m_i, l_i,
// acc_i) in a merge to max m; 0 for a part that saw no valid key.
__device__ __forceinline__ float weight(float m_i, float m) {
  return m_i == -INFINITY ? 0.f : exp2f(m_i - m);
}

// The backward kernels' row stats: m, l and di of rows [r0, r0 + 32) of
// one head into dst[0..32), [32..64), [64..96); zero past n.
__device__ __forceinline__ void stage_row_stats(float* dst, const float* m, const float* l,
                                                const float* di, int r0, int n) {
  const int i = threadIdx.x;
  if (i < 3 * kRows) {
    const float* src = i < kRows ? m : (i < 2 * kRows ? l : di);
    const int r = r0 + i % kRows;
    cp_async4(dst + i, r < n ? src + r : src, r < n);
  }
}

// l -> 1/l in staged row stats, by the threads that staged l (after their
// cp_async_wait): p is then one multiply. Rows past n give inf, masked.
__device__ __forceinline__ void invert_l(float* stats) {
  if (threadIdx.x >= kRows && threadIdx.x < 2 * kRows)
    stats[threadIdx.x] = 1.f / stats[threadIdx.x];
}

// The ids of owned rows i and i + 8 (0 past n: such rows are masked and
// not written).
__device__ __forceinline__ int2 owned_ids(const int* ids, int i, int n) {
  return int2{i < n ? ids[i] : 0, i + 8 < n ? ids[i + 8] : 0};
}

// The segment ids of rows [r0, r0 + 32) (`ids`: one batch row's n ids) into
// dst[0..32), asynchronously, zero past n; threads [first, first + 32) copy.
__device__ __forceinline__ void stage_ids(int* dst, const int* ids, int r0, int n, int first) {
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < kRows) {
    const int r = r0 + i;
    cp_async4(reinterpret_cast<float*>(dst + i),
              reinterpret_cast<const float*>(r < n ? ids + r : ids), r < n);
  }
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

// Two raw fp32 fragment values split into their tf32 parts in registers.
__device__ __forceinline__ Split<2> split_pair(float x0, float x1) {
  float b0, s0, b1, s1;
  split_tf32(x0, b0, s0);
  split_tf32(x1, b1, s1);
  return Split<2>{{__float_as_uint(b0), __float_as_uint(b1)},
                  {__float_as_uint(s0), __float_as_uint(s1)}};
}

// load_b_t's fragment from a tile that holds raw fp32 values (not split in
// shared memory): one ldmatrix, then the split in registers.
template <int W>
__device__ __forceinline__ Split<2> load_b_t_raw(const float* tile, const Frag<W>& f, int k0) {
  uint32_t r[2];
  ldsm_x2(r, tile + f.at(k0));
  return split_pair(__uint_as_float(r[0]), __uint_as_float(r[1]));
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

// A warp's kN accumulator fragments of 16 x 8 into a tile of width D at
// rows m0.., columns c0..
template <int D, int kN>
__device__ __forceinline__ void store_acc(float* tile, const float (&acc)[kN][4], int m0,
                                          int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(tile + tile_at<D>(m0 + g, c)) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(tile + tile_at<D>(m0 + g + 8, c)) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace flash
