// The fp32 linear maps of the slide models at large shapes, for Hopper
// (sm_90a): C = A B^T (+ bias) on the tensor cores in 3xTF32 with fp32
// accumulators, after a pass that splits both operands.
//
// It replaces no TPU kernel: the JAX package leaves every dense product to
// XLA (core/layers.py's DenseT, baselines/layers.py's GraphSAGE linear), and
// so did the port, through cuBLAS. With TF32 off, as the port's fp32 models
// need it, cuBLAS runs these products as SIMT FFMA sgemm, near the card's 67
// TFLOP/s fp32 ceiling and away from its tensor cores. The 3xTF32 split
// (csrc/flash_common.cuh) keeps fp32 accuracy on them, as the fp32 flash
// kernels do: every value as a tf32 big part and the tf32 small part of the
// rest, and each product as small * big + big * small + big * big.
//
// Bound. 2 M N K operations; in 3xTF32 the tensor cores issue three products
// for each, so at (M, N, K) = (4096, 3072, 1024) the 77.3 GFLOP issued take
// 0.156 ms at the TF32 peak of 495 TFLOP/s, against 29 MB of inputs and
// outputs (9 us at 3.35 TB/s). The split pass reads each operand once and
// writes its two parts (~84 MB at that shape, ~25 us).
//
// The K-major constraint and the split. A tf32 wgmma reads both
// shared-memory operands K-major. Y = X W^T reads X and W as stored, but the
// backward's dX = dY W needs W^T and dW = dY^T X needs both transposed. So
// the split pass (gemm_tf32_split) writes, for each operand, its big and
// small parts in the layout its product reads: [2][rows][depth], rows padded
// to 128 and depth to 32 with zeros, as stored or transposed (a 32 x 32 tile
// through shared memory). Its copies are the TMA's to copy whatever the
// input's alignment or row stride (785 floats, 3,140 bytes, is none TMA
// takes).
//
// Design (gemm_tf32_3x). One persistent CTA per SM walks the work units:
// output tiles of 128 x 128 in column-major order of tiles (CTAs side by
// side share B), each over all of K or, where too few tiles would fill the
// card, over one of `splits` slices of K (the caller's plan). A producer
// warp keeps a ring of 3 stages of 32-deep tiles (both parts of A's and B's
// 128 rows, 64 KB a stage) in flight by TMA, with an mbarrier per stage for
// each direction. Two consumer warpgroups own 64 rows each: per stage, 4 k8
// slices x 3 products of m64n128k8 wgmma (small * big, big * small, then big
// * big) into a fresh accumulator, which is added to the running sum in
// fp32 (round to nearest) once they complete, and the stage handed back.
// So the sum over K rounds as a sum of 32-deep blocks, not as the tensor
// cores' own accumulation, which truncates: at (4096, 3072, 1024), against
// float64, accumulating the whole depth in the tensor cores erred 12x as
// much as cuBLAS's fp32 product, a fresh accumulator a stage 0.3x, for 12%
// more time (PERF.md section 6). The epilogue adds the bias and writes the
// tile straight from the registers while the producer already fills the
// ring for the next unit. A unit over a slice of K writes its partial sum
// to a workspace, and gemm_tf32_reduce adds the slices in order: no
// atomics, the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "flash_common.cuh"
#include "flash_tf32.cuh"

namespace {

namespace tf = flash::tf;
namespace wg = flash::wg;

constexpr int kBM = 128;  // rows of an output tile: two consumer warpgroups of 64
constexpr int kBN = 128;  // its columns
constexpr int kBK = 32;   // depth of a stage: one 128-byte swizzle panel of fp32
constexpr int kStages = 3;
constexpr int kAcc = kBN / 2;  // accumulators a consumer thread holds
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 32;   // and one producer warp
constexpr int kReleases = kConsumerThreads / 32;  // arrivals that free a stage: one per warp

// ---- products ---------------------------------------------------------------------

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC64(i) ACC16(i), ACC16(i + 16), ACC16(i + 32), ACC16(i + 48)

// d (+)= a * b, m64n128k8, tf32 inputs, fp32 accumulators, A and B from
// shared memory (K-major)
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : ACC64(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef ACC64
#undef ACC16
#undef ACC4

// ---- the product --------------------------------------------------------------------

// A consumer warpgroup's 64 x 128 sums (+ bias) into rows r0.., columns n0..
// of dst (row stride ld), those below m and n: register 4j + 2h + e of
// thread (warp w, lane 4g + t) holds row 16w + g + 8h, column 8j + 2t + e.
__device__ __forceinline__ void store_tile(const float (&r)[kAcc], float* dst, long long ld,
                                           const float* bias, int m, int n, int r0, int n0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool pairs = ((ld | n) & 1) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * w + g + 8 * h;
    if (row >= m) continue;
    float* line = dst + row * ld;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= n) continue;
      float x0 = r[4 * j + 2 * h], x1 = r[4 * j + 2 * h + 1];
      if (bias != nullptr) {
        x0 += bias[col];
        if (col + 1 < n) x1 += bias[col + 1];
      }
      if (pairs) {
        *reinterpret_cast<float2*>(line + col) = make_float2(x0, x1);
      } else {
        line[col] = x0;
        if (col + 1 < n) line[col + 1] = x1;
      }
    }
  }
}

struct Layout {  // byte offsets in dynamic shared memory (after 1024-byte alignment)
  static constexpr int kA = kBM * kBK * 4;  // one part of an A tile
  static constexpr int kB = kBN * kBK * 4;  // one part of a B tile
  static constexpr int kStage = 2 * kA + 2 * kB;
  static constexpr int kBars = kStages * kStage;  // full[kStages], then empty[kStages]
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;
};

// The work units: tiles_m x tiles_n output tiles, each over `splits` slices
// of the depth's k-blocks.
struct Work {
  int tiles_m, tiles_n, splits, kblocks;
  __device__ __forceinline__ int units() const { return tiles_m * tiles_n * splits; }
  // unit u: tile rows m0, columns n0, slice `split`, k-blocks [kb0, kb1);
  // tiles in column-major order, so CTAs side by side share B's rows
  __device__ __forceinline__ void unit(int u, int& m0, int& n0, int& split, int& kb0,
                                       int& kb1) const {
    const int tiles = tiles_m * tiles_n;
    split = u / tiles;
    const int rest = u - split * tiles;
    n0 = rest / tiles_m * kBN;
    m0 = (rest % tiles_m) * kBM;
    kb0 = static_cast<int>(static_cast<long long>(split) * kblocks / splits);
    kb1 = static_cast<int>(static_cast<long long>(split + 1) * kblocks / splits);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_3x(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap, float* __restrict__ out,
                 long long ldo, const float* __restrict__ bias, int m, int n, Work work) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = work.units();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, kReleases);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {  // the producer warp
    if (lane == 0) {
      tf::prefetch_map(&amap);
      tf::prefetch_map(&bmap);
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0, split, kb0, kb1;
        work.unit(u, m0, n0, split, kb0, kb1);
        for (int kb = kb0; kb < kb1; ++kb) {
          wg::mbar_wait(empty + s, phase ^ 1);  // a fresh barrier passes parity 1
          wg::mbar_expect_tx(full + s, L::kStage);
          const uint32_t at = base + s * L::kStage;
          for (int part = 0; part < 2; ++part) {
            tf::tma_load(at + part * L::kA, &amap, kb * kBK, m0, part, full + s);
            tf::tma_load(at + 2 * L::kA + part * L::kB, &bmap, kb * kBK, n0, part, full + s);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 c .. 64 c + 63 of each tile
  const int c = warp >> 2;
  int s = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, n0, split, kb0, kb1;
    work.unit(u, m0, n0, split, kb0, kb1);
    float acc[kAcc], sum[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sum[i] = 0.f;
    for (int kb = kb0; kb < kb1; ++kb) {
      wg::mbar_wait(full + s, phase);
      const uint32_t a = base + s * L::kStage + c * (64 * 128);
      const uint32_t b = base + s * L::kStage + 2 * L::kA;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)  // a fresh accumulator: small * big first
        mma(acc, tf::desc<kBM>(a + L::kA, kk), tf::desc<kBN>(b, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        mma(acc, tf::desc<kBM>(a, kk), tf::desc<kBN>(b + L::kB, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        mma(acc, tf::desc<kBM>(a, kk), tf::desc<kBN>(b, kk), 1);
      wg::wgmma_commit();
      wg::wgmma_wait();
      wg::fence_regs(acc);
      if (lane == 0) wg::mbar_arrive(empty + s);  // the stage is read: hand it back
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sum[i] += acc[i];
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    // this slice's partial sum where splits > 1 ([splits][m][n], the caller's ldo = n)
    store_tile(sum, out + static_cast<long long>(split) * m * ldo, ldo, bias, m, n,
               m0 + 64 * c, n0);
  }
}

// out = the sum of the `splits` partial products in ws ([splits][m][n]), in
// order, plus the bias
__global__ void __launch_bounds__(256)
    gemm_tf32_reduce(const float* __restrict__ ws, int splits, int m, int n,
                     float* __restrict__ out, long long ldo, const float* __restrict__ bias) {
  const long long total = static_cast<long long>(m) * n;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += 256LL * gridDim.x) {
    float x = ws[i];
    for (int s = 1; s < splits; ++s) x += ws[s * total + i];
    const long long row = i / n, col = i - row * n;
    out[row * ldo + col] = bias != nullptr ? x + bias[col] : x;
  }
}

// ---- the split pass -----------------------------------------------------------------
//
// flash_tf32.cuh has a split pass of its own (flash_tf32_split): per (batch,
// head), a slice of at most 64 columns, written in its row and its column
// form at once. This one takes a whole matrix of any width (37,632 for the
// patch embedding) and row stride, as stored or transposed through a 32 x
// 32 tile. The two stay apart until the flash wrappers move onto this
// generic pass, one (batch, head) an operand.

constexpr int kMaxOperands = 4;

// One operand: the rows x cols fp32 matrix at src (row stride ld, columns
// contiguous), written as [2][out_rows][out_cols] (big parts, then small) at
// dst, transposed where `trans` (then row i of the copy is column i of src),
// zero past the source's edges. out_rows and out_cols are multiples of 32;
// `first` is the operand's first block of the launch.
struct Operand {
  const float* src;
  long long ld;
  int rows, cols, trans, out_rows, out_cols, first;
  float* dst;
};
struct Operands {
  Operand op[kMaxOperands];
  int count;
};

// One 32 x 32 tile of one operand's copy a block: 32 x 8 threads, 4 rows each.
__global__ void __launch_bounds__(256) gemm_tf32_split(const __grid_constant__ Operands ops) {
  __shared__ float tile[32][33];
  int j = 0;
  while (j + 1 < ops.count && static_cast<int>(blockIdx.x) >= ops.op[j + 1].first) ++j;
  const Operand& op = ops.op[j];
  const int local = blockIdx.x - op.first, across = op.out_cols / 32;
  const int r0 = local / across * 32, c0 = local % across * 32;  // the tile of the copy
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long plane = static_cast<long long>(op.out_rows) * op.out_cols;
  float* big = op.dst;
  if (op.trans) {  // copy (r, c) = src (c, r): read rows c0.. of src, write rows r0.. of the copy
    for (int i = ty; i < 32; i += 8) {
      const int sr = c0 + i, sc = r0 + tx;
      tile[i][tx] = sr < op.rows && sc < op.cols ? op.src[sr * op.ld + sc] : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      float hi, lo;
      flash::split_tf32(tile[tx][i], hi, lo);
      const long long at = static_cast<long long>(r0 + i) * op.out_cols + c0 + tx;
      big[at] = hi;
      big[plane + at] = lo;
    }
  } else {
    for (int i = ty; i < 32; i += 8) {
      const int r = r0 + i, col = c0 + tx;
      float hi, lo;
      flash::split_tf32(r < op.rows && col < op.cols ? op.src[r * op.ld + col] : 0.f, hi, lo);
      const long long at = static_cast<long long>(r) * op.out_cols + col;
      big[at] = hi;
      big[plane + at] = lo;
    }
  }
}

// ---- launch -------------------------------------------------------------------------

long long pad(long long x, int to) { return (x + to - 1) / to * to; }

// The streaming multiprocessors of `device`, read once per device.
int card_sms(int device) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static int sms[kDevices];
  if (device < 0 || device >= kDevices) return 0;
  std::call_once(once[device], [&] {
    if (cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess)
      sms[device] = 0;
  });
  return sms[device];
}

// out (m x n, row stride n) = operand a's copy times operand b's, transposed
// (+ bias), over `splits` slices of the depth (partial sums in ws).
struct Product {
  int a, b;
  float* out;
  const float* bias;
  int m, n, splits;
};

// The copy of src (rows x cols, row stride ld), or of its transpose, at dst:
// rows padded to a tile, depth to a stage.
Operand operand(const void* src, long long ld, int rows, int cols, bool trans, float* dst) {
  const int copy_rows = trans ? cols : rows, depth = trans ? rows : cols;
  return {static_cast<const float*>(src), ld, rows, cols, trans ? 1 : 0,
          static_cast<int>(pad(copy_rows, kBM)), static_cast<int>(pad(depth, kBK)), 0, dst};
}

// One split launch over ops, then each product (a 3xTF32 launch, and the
// sum of its slices where it has more than one), on `stream`. The copies
// lie back to back from `scratch` (their dst is set here), the partial sums
// after them; `floats` must hold both. Returns the first CUDA error.
cudaError_t launch(Operands& ops, const Product* products, int count, float* scratch,
                   long long floats, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  long long at = 0, blocks = 0, partials = 0;
  for (int i = 0; i < ops.count; ++i) {
    Operand& op = ops.op[i];
    if (op.src == nullptr || op.ld < op.cols) return cudaErrorInvalidValue;
    op.dst = scratch + at;
    op.first = static_cast<int>(blocks);
    at += 2LL * op.out_rows * op.out_cols;
    blocks += static_cast<long long>(op.out_rows / 32) * (op.out_cols / 32);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  for (int i = 0; i < count; ++i) {
    const Product& p = products[i];
    const int depth = ops.op[p.a].out_cols;
    if (p.out == nullptr || p.splits < 1 || p.splits > depth / kBK ||
        ops.op[p.b].out_cols != depth)
      return cudaErrorInvalidValue;
    if (p.splits > 1) {
      const long long need = static_cast<long long>(p.splits) * p.m * p.n;
      partials = need > partials ? need : partials;
    }
  }
  if (floats < at + partials) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int sms = card_sms(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  err = flash::allow_smem<&gemm_tf32_3x>(Layout::kBytes);
  if (err != cudaSuccess) return err;
  gemm_tf32_split<<<static_cast<unsigned>(blocks), dim3(32, 8), 0, stream>>>(ops);
  err = cudaGetLastError();
  float* ws = scratch + at;
  for (int i = 0; i < count && err == cudaSuccess; ++i) {
    const Product& p = products[i];
    const Operand &a = ops.op[p.a], &b = ops.op[p.b];
    CUtensorMap maps[2];
    if (!tf::encode_matrices(&maps[0], a.dst, 2, a.out_rows, a.out_cols, kBM) ||
        !tf::encode_matrices(&maps[1], b.dst, 2, b.out_rows, b.out_cols, kBN))
      return cudaErrorInvalidValue;
    const Work work = {(p.m + kBM - 1) / kBM, (p.n + kBN - 1) / kBN, p.splits,
                       a.out_cols / kBK};
    const int units = work.tiles_m * work.tiles_n * p.splits;
    const bool sliced = p.splits > 1;
    gemm_tf32_3x<<<units < sms ? units : sms, kThreads, Layout::kBytes, stream>>>(
        maps[0], maps[1], sliced ? ws : p.out, p.n, sliced ? nullptr : p.bias, p.m, p.n, work);
    err = cudaGetLastError();
    if (err != cudaSuccess || !sliced) continue;
    const long long total = static_cast<long long>(p.m) * p.n;
    const long long grid = (total + 255) / 256;
    gemm_tf32_reduce<<<static_cast<unsigned>(grid < 4 * sms ? grid : 4 * sms), 256, 0,
                       stream>>>(ws, p.splits, p.m, p.n, p.out, p.n, p.bias);
    err = cudaGetLastError();
  }
  return err;
}

bool extents_ok(int m, int n, int k) {
  return m >= 1 && n >= 1 && k >= 1 && pad(m, kBM) <= 0x7fffffffLL &&
         pad(n, kBM) <= 0x7fffffffLL && pad(k, kBM) <= 0x7fffffffLL;
}

}  // namespace

// y (m x n, contiguous) = x w^T (+ bias) in 3xTF32: x (m x k, row stride
// ldx), w (n x k, row stride ldw), bias null or n floats. `scratch` holds
// the split copies of x and w ([2][pad128(m)][pad32(k)], then
// [2][pad128(n)][pad32(k)]) and, where the product is summed over `splits`
// > 1 slices of the depth, their partial sums (splits * m * n floats):
// `floats` in all, as ops/linear.py's forward_plan counts them. One split
// launch, then the product's (one, or two with slices) on `stream`; returns
// the first CUDA error (0 on success).
extern "C" int linear_tf32_fwd_launch(const void* x, long long ldx, const void* w, long long ldw,
                                      const void* bias, void* y, void* scratch, long long floats,
                                      int m, int n, int k, int splits, void* stream) {
  if (!extents_ok(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  Operands ops = {};
  ops.count = 2;
  ops.op[0] = operand(x, ldx, m, k, false, nullptr);
  ops.op[1] = operand(w, ldw, n, k, false, nullptr);
  const Product p = {0, 1, static_cast<float*>(y), static_cast<const float*>(bias), m, n, splits};
  return static_cast<int>(launch(ops, &p, 1, static_cast<float*>(scratch), floats,
                                 static_cast<cudaStream_t>(stream)));
}

// The backward of y = x w^T: dx (m x k, contiguous) = dy w where splits_dx
// > 0, dw (n x k, contiguous) = dy^T x where splits_dw > 0, for dy (m x n,
// row stride lddy) and x, w as in the forward. `scratch` holds, for dx, the
// split copies of dy and w^T ([2][pad128(m)][pad32(n)], [2][pad128(k)][pad32(n)]),
// then, for dw, those of dy^T and x^T ([2][pad128(n)][pad32(m)],
// [2][pad128(k)][pad32(m)]), then the partial sums of the product with the
// most (splits * rows * cols floats, where splits > 1): `floats` in all, as
// ops/linear.py's backward_plan counts them. One split launch, then the
// products; returns the first CUDA error (0 on success).
extern "C" int linear_tf32_bwd_launch(const void* x, long long ldx, const void* w, long long ldw,
                                      const void* dy, long long lddy, void* dx, void* dw,
                                      void* scratch, long long floats, int m, int n, int k,
                                      int splits_dx, int splits_dw, void* stream) {
  if (!extents_ok(m, n, k) || (splits_dx < 1 && splits_dw < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Operands ops = {};
  Product products[2];
  int count = 0;
  if (splits_dx > 0) {
    ops.op[ops.count++] = operand(dy, lddy, m, n, false, nullptr);
    ops.op[ops.count++] = operand(w, ldw, n, k, true, nullptr);
    products[count++] = {ops.count - 2, ops.count - 1, static_cast<float*>(dx), nullptr, m, k,
                         splits_dx};
  }
  if (splits_dw > 0) {
    ops.op[ops.count++] = operand(dy, lddy, m, n, true, nullptr);
    ops.op[ops.count++] = operand(x, ldx, m, k, true, nullptr);
    products[count++] = {ops.count - 2, ops.count - 1, static_cast<float*>(dw), nullptr, n, k,
                         splits_dw};
  }
  return static_cast<int>(launch(ops, products, count, static_cast<float*>(scratch), floats,
                                 static_cast<cudaStream_t>(stream)));
}
