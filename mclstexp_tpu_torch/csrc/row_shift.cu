// Per-row pixel shift, the building block of the Paeth shear rotation, for
// Hopper (sm_90a). Replaces the TPU kernel
// mclstexp_tpu/ops/pallas_shift.py::_row_shift_kernel (wrapper row_shift).
//
//   out[b, y, x, :] = in[b, y, x - k[b, y], :]
//   zero where x - k leaves [0, W); k clamped to [-W/2, W/2].
//
// Bound: pure data movement. Each output element is written once and each
// input element that lands in the output read once: at most 2 *
// B*H*W*C*itemsize bytes plus B*H*4 bytes of shifts. At the flagship shape
// (128, 224, 224, 3) that is 154 MB in f32 (46 us at 3.35 TB/s) and 77 MB in
// bf16 (23 us); shifts that push pixels out of the row need fewer reads.
//
// Two layouts of the same function:
//  * rows: the image is a contiguous (B, H, W, C) buffer; memory row (b, y)
//    moves by k[b, y] * C elements. Kernel shift_rows16: one block per
//    memory row, thread t owns the row's 16-byte chunks t, t + blockDim, ...;
//    a chunk's source starts k * C * itemsize bytes back, at any residue mod
//    16, so it is loaded with realign::load (realign.cuh: the one or two
//    aligned words holding its valid bytes, shifted into place, the bytes
//    shifted in from outside the row zeroed) and stored as 16 bytes; chunks
//    with no valid byte are zero stores and read nothing. Where a memory row
//    is no multiple of 16 bytes or a buffer is unaligned, shift_rows: one
//    block per memory row, one element per thread per access.
//  * cols: the image is the (1, 2)-transpose of a contiguous (B, W, H, C)
//    buffer T (the column shear of the Paeth rotation). In T's memory order
//    the shift reads T_in[b, r - k[b, s], s, :] for T_out[b, r, s, :], so the
//    transposed view is shifted without copying it. Each output memory row
//    gathers its pixels from as many source rows as there are distinct
//    shifts, so a kernel that reads straight from device memory reads
//    scattered pixels (12 bytes each in f32) and its time depends on the
//    shifts. Kernel shift_cols_band: one block per (image b, band of
//    band_px consecutive pixels s). The block copies the band's whole column
//    (rows x band_px * C elements, one contiguous run per memory row) into
//    shared memory with 16-byte cp.async, then writes every output memory
//    row's band segment with 16-byte stores, each element read from shared
//    memory at row r - k[s] (k loaded and clamped once per element a
//    thread owns). Each input byte is read from device memory once and each
//    output byte written once, whatever the shifts. The wrapper's plan
//    (ops/row_shift.py::shift_plan) picks band_px (a 192-byte band row at
//    most, 43 KB of shared memory per block at the flagship: five blocks per
//    SM, so one block's loads overlap another's stores) and the threads
//    (whole band rows per pass). Where the band's column does not fit in 48
//    KB of shared memory, or rows are no multiple of 16 bytes, shift_cols
//    runs: one block per output memory row, each element read from its
//    source row.
// Elements move as raw 16- or 32-bit words, so the copy is bit-exact.

#include <cstdint>
#include <cuda_runtime.h>

#include "realign.cuh"

namespace {

// The kernels, as the wrapper's plan names them (ops/row_shift.py KERNELS).
enum Kernel { kShiftRows = 0, kShiftRows16 = 1, kShiftCols = 2, kShiftColsBand = 3 };

constexpr int kBandSmemMax = 48 * 1024;  // dynamic shared memory without an opt-in

// rows: number of memory rows per image; row_px: pixels per memory row.
template <typename T>
__global__ void shift_rows(const T* __restrict__ in, T* __restrict__ out,
                           const int* __restrict__ shifts, int row_px, int channels) {
  const long long row = blockIdx.x;  // b * rows + y
  const int n = row_px * channels;
  const int half = row_px / 2;
  const int k = min(max(shifts[row], -half), half);
  const int off = k * channels;
  const T* src = in + row * n;
  T* dst = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i - off;
    dst[i] = (j >= 0 && j < n) ? src[j] : T(0);
  }
}

// Bytes, whatever the element type: a shift is whole pixels of px_bytes.
__global__ void shift_rows16(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                             const int* __restrict__ shifts, int row_px, int px_bytes) {
  const long long row = blockIdx.x;  // b * rows + y
  const long long n = static_cast<long long>(row_px) * px_bytes;
  const int half = row_px / 2;
  const long long off = static_cast<long long>(min(max(shifts[row], -half), half)) * px_bytes;
  const uintptr_t src = reinterpret_cast<uintptr_t>(in + row * n);
  uint4* dst = reinterpret_cast<uint4*>(out + row * n);
  const int chunks = static_cast<int>(n / 16);
  for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
    // Output bytes [16j, 16j + 16) read source bytes 16j - off + q, valid
    // where they fall in [0, n).
    const long long q0 = 16LL * j;
    const long long vlo = max(off - q0, 0LL), vhi = min(n + off - q0, 16LL);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (vlo < vhi) {
      v = realign::load(src + static_cast<uintptr_t>(q0 - off), static_cast<int>(vlo),
                        static_cast<int>(vhi));
    }
    dst[j] = v;
  }
}

template <typename T>
__global__ void shift_cols(const T* __restrict__ in, T* __restrict__ out,
                           const int* __restrict__ shifts, int rows, int row_px,
                           int channels) {
  const long long row = blockIdx.x;  // b * rows + r
  const long long b = row / rows;
  const int r = static_cast<int>(row - b * rows);
  const int n = row_px * channels;
  const int half = rows / 2;
  const int* kb = shifts + b * row_px;
  const T* img = in + b * rows * n;
  T* dst = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = min(max(kb[i / channels], -half), half);
    const int sr = r - k;
    dst[i] = (sr >= 0 && sr < rows) ? img[static_cast<long long>(sr) * n + i] : T(0);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One block per (b, band). Thread t owns the 16-byte chunk j = t % lanes of
// every band row r = t / lanes + i * (blockDim / lanes), where lanes =
// band_px * C * itemsize / 16: the same chunks when it loads and when it
// stores, so its V elements' offsets and shifts are computed once.
template <typename T>
__global__ void shift_cols_band(const T* __restrict__ in, T* __restrict__ out,
                                const int* __restrict__ shifts, int rows, int row_px,
                                int channels, int band_px) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* band = reinterpret_cast<T*>(smem);
  const int nbands = (row_px + band_px - 1) / band_px;
  const long long b = blockIdx.x / nbands;
  const int s0 = static_cast<int>(blockIdx.x - b * nbands) * band_px;
  const int band_elems = min(band_px, row_px - s0) * channels;  // one band row here
  const int chunks = band_elems / V;
  const int lanes = band_px * channels / V;
  const int j = threadIdx.x % lanes;
  const int rstep = blockDim.x / lanes;
  const long long pitch = static_cast<long long>(row_px) * channels;
  const long long base = b * rows * pitch + static_cast<long long>(s0) * channels;
  if (j < chunks) {
    for (int r = threadIdx.x / lanes; r < rows; r += rstep) {
      cp_async16(band + r * band_elems + j * V, in + base + r * pitch + j * V);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (j >= chunks) return;

  const int half = rows / 2;
  int e[V], k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    e[i] = j * V + i;
    k[i] = min(max(shifts[b * row_px + s0 + e[i] / channels], -half), half);
  }
  for (int r = threadIdx.x / lanes; r < rows; r += rstep) {
    union {
      uint4 v;
      T t[V];
    } o;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int sr = r - k[i];
      o.t[i] = (sr >= 0 && sr < rows) ? band[sr * band_elems + e[i]] : T(0);
    }
    *reinterpret_cast<uint4*>(out + base + r * pitch + j * V) = o.v;
  }
}

// The 16-byte paths' conditions: 16-byte aligned buffers and memory rows of
// whole 16-byte chunks; for the band path also band rows of whole chunks,
// whole band rows per pass and the band's column within kBandSmemMax.
bool chunks_ok(const void* in, const void* out, int row_px, long long px_bytes) {
  return reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 && (row_px * px_bytes) % 16 == 0;
}

bool band_ok(int rows, int row_px, long long px_bytes, int band_px, int threads) {
  return band_px > 0 && band_px <= row_px && (band_px * px_bytes) % 16 == 0 &&
         threads % (band_px * px_bytes / 16) == 0 &&
         static_cast<long long>(rows) * band_px * px_bytes <= kBandSmemMax;
}

template <typename T>
int launch(const void* in, void* out, const int* shifts, int batch, int rows, int row_px,
           int channels, int kernel, int band_px, int threads, cudaStream_t stream) {
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const long long px_bytes = static_cast<long long>(channels) * sizeof(T);
  const long long memory_rows = static_cast<long long>(batch) * rows;
  const long long bands = band_px > 0 ? (row_px + band_px - 1) / band_px : 0;
  const bool ok =
      (kernel == kShiftRows || kernel == kShiftCols) ? band_px == 0 :
      kernel == kShiftRows16 ? band_px == 0 && chunks_ok(in, out, row_px, px_bytes) :
      kernel == kShiftColsBand ? chunks_ok(in, out, row_px, px_bytes) &&
                                 band_ok(rows, row_px, px_bytes, band_px, threads) :
      false;
  if (!ok || threads <= 0 || threads > 1024 || memory_rows > 0x7fffffffLL ||
      batch * bands > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto grid = static_cast<unsigned>(memory_rows);
  if (kernel == kShiftRows) {
    shift_rows<T><<<grid, threads, 0, stream>>>(src, dst, shifts, row_px, channels);
  } else if (kernel == kShiftRows16) {
    shift_rows16<<<grid, threads, 0, stream>>>(static_cast<const uint8_t*>(in),
                                               static_cast<uint8_t*>(out), shifts, row_px,
                                               static_cast<int>(px_bytes));
  } else if (kernel == kShiftCols) {
    shift_cols<T><<<grid, threads, 0, stream>>>(src, dst, shifts, rows, row_px, channels);
  } else {
    const size_t smem = static_cast<size_t>(rows) * band_px * px_bytes;
    shift_cols_band<T><<<static_cast<unsigned>(batch * bands), threads, smem, stream>>>(
        src, dst, shifts, rows, row_px, channels, band_px);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in/out: device buffers of batch * rows * row_px * channels elements of
// itemsize bytes (4: f32, 2: bf16); shifts: device int32, (batch, rows) for
// the row layout's kernels and (batch, row_px) for the column layout's.
// kernel: 0 shift_rows, 1 shift_rows16, 2 shift_cols, 3 shift_cols_band
// (bands of band_px pixels; band_px is 0 for the others); threads per
// block. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int row_shift_launch(const void* in, void* out, const int* shifts, int batch,
                                int rows, int row_px, int channels, int itemsize, int kernel,
                                int band_px, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    return launch<uint32_t>(in, out, shifts, batch, rows, row_px, channels, kernel, band_px,
                            threads, s);
  }
  if (itemsize == 2) {
    return launch<uint16_t>(in, out, shifts, batch, rows, row_px, channels, kernel, band_px,
                            threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
