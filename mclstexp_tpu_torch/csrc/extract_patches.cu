// Patch gather from a whole-slide image, for Hopper (sm_90a). Replaces the
// TPU kernels of mclstexp_tpu/ops/pallas_patches.py: _patch_kernel (wrapper
// extract_patches_pallas) and _patch_kernel_bytes (wrapper
// extract_patches_pallas_bytes). The two differ only in how they tile the
// slide for the TPU's DMA and vector units; one kernel serves both here.
//
//   out[i, py, px, c] = slide[y_i - r + py, x_i - r + px, c]     r = P / 2
//
// zero where the source row or column lies outside the slide, and zero for
// py or px >= 2r (the last row and column at odd P): the crop box is
// [center - r, center + r), as the data layer's host cutter
// extract_patches_np fills it, for every center and every P.
//
// Bound: pure data movement. Each output byte is written once and each of
// its in-slide source bytes read once: at most 2 * N * P * P * C bytes (at
// the Visium capture area's 4,992 spots and P = 224, C = 3: 1.50 GB, 0.45 ms
// at 3.35 TB/s), less where patches reach past the slide.
//
// Design: the TPU kernels DMA an aligned window per patch into VMEM and roll
// the sub-tile residual into place. Here, gather_rows16 (where a patch row,
// P * C bytes, is whole 16-byte chunks, so every output row starts 16-byte
// aligned) gives each block one patch and a block of rows_per_cta output
// rows; thread t owns chunk t % lanes of rows t / lanes, t / lanes + rstep,
// ... (lanes = the row's chunks, rstep = threads / lanes: whole rows per
// pass). A chunk's source run starts at any byte of a slide row, so the
// thread loads it with realign::load (realign.cuh): the one or two aligned
// 16-byte words that hold its valid bytes, shifted right by the start's
// residue, the bytes outside the slide or past 2r zeroed; then it stores 16
// bytes. Rows outside the slide are 16-byte zero stores. Only aligned words
// that hold a byte of the slide are read: such a word lies inside the
// slide's allocation, so the slide itself needs no alignment. Where P * C is no
// multiple of 16 (C = 1 or 3 at odd P), gather_bytes runs: one block per
// (patch, 8 rows), one byte per thread per access. The valid byte range of
// a patch row is computed once per block. Offsets are 64-bit: a center may
// be -2147483648 (a missing spot's floor(NaN)) and a slide may hold ~2^31
// bytes. The launch plan (threads, rows per block) is
// ops/patches.py::patch_plan.

#include <cstdint>
#include <cuda_runtime.h>

#include "realign.cuh"

namespace {

// The crop of patch i: its top-left source pixel (x0, y0) and the bytes
// [blo, bhi) of an output row that come from the slide (empty when none).
struct Crop {
  long long x0, y0, blo, bhi, r;
};

__device__ __forceinline__ Crop crop_of(const long long* centers, long long i, long long w,
                                        int channels, int patch) {
  Crop c;
  c.r = patch / 2;
  c.x0 = centers[2 * i] - c.r;
  c.y0 = centers[2 * i + 1] - c.r;
  // Valid columns px: px < 2r and 0 <= x0 + px < w.
  const long long px_lo = c.x0 < 0 ? -c.x0 : 0;
  const long long px_hi = min(2 * c.r, w - c.x0);
  c.blo = px_lo * channels;
  c.bhi = px_hi > px_lo ? px_hi * channels : c.blo;
  return c;
}

__global__ void gather_bytes(const uint8_t* __restrict__ slide,
                             const long long* __restrict__ centers, uint8_t* __restrict__ out,
                             long long h, long long w, int channels, int patch,
                             int rows_per_cta) {
  const long long i = blockIdx.x;
  const Crop c = crop_of(centers, i, w, channels, patch);
  const long long row_bytes = static_cast<long long>(patch) * channels;
  const int py_end = min(static_cast<int>(blockIdx.y + 1) * rows_per_cta, patch);
  for (int py = blockIdx.y * rows_per_cta; py < py_end; ++py) {
    const long long sy = c.y0 + py;
    uint8_t* dst = out + (i * patch + py) * row_bytes;
    if (py < 2 * c.r && sy >= 0 && sy < h) {
      // Only bytes j in [blo, bhi) are read: their offset is in the slide.
      const long long src = (sy * w + c.x0) * channels;
      for (long long j = threadIdx.x; j < row_bytes; j += blockDim.x) {
        dst[j] = (j >= c.blo && j < c.bhi) ? slide[src + j] : uint8_t(0);
      }
    } else {
      for (long long j = threadIdx.x; j < row_bytes; j += blockDim.x) dst[j] = 0;
    }
  }
}

__global__ void gather_rows16(const uint8_t* __restrict__ slide,
                              const long long* __restrict__ centers, uint8_t* __restrict__ out,
                              long long h, long long w, int channels, int patch,
                              int rows_per_cta) {
  const long long i = blockIdx.x;
  const Crop c = crop_of(centers, i, w, channels, patch);
  const long long row_bytes = static_cast<long long>(patch) * channels;
  const int chunks = static_cast<int>(row_bytes / 16);
  const int lanes = min(chunks, static_cast<int>(blockDim.x));
  const int rstep = blockDim.x / lanes;
  const int jt = threadIdx.x % lanes;
  const int py0 = blockIdx.y * rows_per_cta;
  const int py_end = min(py0 + rows_per_cta, patch);
  for (int py = py0 + threadIdx.x / lanes; py < py_end; py += rstep) {
    const long long sy = c.y0 + py;
    uint4* dst = reinterpret_cast<uint4*>(out + (i * patch + py) * row_bytes);
    const bool in_slide = py < 2 * c.r && sy >= 0 && sy < h;
    // The address of output byte 0's source (outside the slide where x0 <
    // 0); only valid bytes are read.
    const uintptr_t src = in_slide ? reinterpret_cast<uintptr_t>(slide) +
                                         static_cast<uintptr_t>((sy * w + c.x0) * channels)
                                   : 0;
    for (int j = jt; j < chunks; j += lanes) {
      const long long q0 = 16LL * j;
      const long long vlo = max(c.blo - q0, 0LL), vhi = min(c.bhi - q0, 16LL);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (in_slide && vlo < vhi) {
        v = realign::load(src + static_cast<uintptr_t>(q0), static_cast<int>(vlo),
                          static_cast<int>(vhi));
      }
      dst[j] = v;
    }
  }
}

}  // namespace

// slide: device (h, w, channels) uint8, contiguous; centers: device (n, 2)
// int64 (x, y); out: device (n, patch, patch, channels) uint8. rows16 != 0
// runs gather_rows16 (patch * channels a multiple of 16, out 16-byte
// aligned), else gather_bytes; each block owns one patch and rows_per_cta
// output rows with `threads` threads. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int extract_patches_launch(const void* slide, const void* centers, void* out,
                                      long long n, long long h, long long w, int channels,
                                      int patch, int rows16, int threads, int rows_per_cta,
                                      void* stream) {
  const long long row_bytes = static_cast<long long>(patch) * channels;
  if (n <= 0 || patch <= 0 || channels <= 0 || n > 0x7fffffffLL || threads <= 0 ||
      threads > 1024 || rows_per_cta <= 0 ||
      (patch + static_cast<long long>(rows_per_cta) - 1) / rows_per_cta > 65535 ||
      (rows16 && (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(n),
                  static_cast<unsigned int>((patch + rows_per_cta - 1) / rows_per_cta));
  const auto* src = static_cast<const uint8_t*>(slide);
  const auto* xy = static_cast<const long long*>(centers);
  auto* dst = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows16) {
    gather_rows16<<<grid, threads, 0, s>>>(src, xy, dst, h, w, channels, patch, rows_per_cta);
  } else {
    gather_bytes<<<grid, threads, 0, s>>>(src, xy, dst, h, w, channels, patch, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}
