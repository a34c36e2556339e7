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
// the sub-tile residual into place. Here each CTA owns one (patch, block of
// kRows rows); its threads walk each output row's P * C bytes, so stores are
// coalesced and loads read one contiguous run of a slide row. The valid
// column range of a patch is computed once, so the inner loop has one
// compare pair and no division. Offsets are 64-bit: a center may be
// -2147483648 (a missing spot's floor(NaN)) and a slide may hold ~2^31 bytes.
// Byte loads and stores; wider accesses across unaligned starts are a later
// optimisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;  // output rows per CTA

__global__ void extract_patches_kernel(const uint8_t* __restrict__ slide,
                                       const long long* __restrict__ centers,
                                       uint8_t* __restrict__ out, long long h, long long w,
                                       int channels, int patch) {
  const long long i = blockIdx.x;
  const long long r = patch / 2;
  const long long x0 = centers[2 * i] - r;
  const long long y0 = centers[2 * i + 1] - r;
  const long long row_bytes = static_cast<long long>(patch) * channels;
  // Valid columns px: px < 2r and 0 <= x0 + px < w, as a byte range [blo, bhi).
  const long long px_lo = x0 < 0 ? -x0 : 0;
  const long long px_hi = min(2 * r, w - x0);
  const long long blo = px_lo * channels;
  const long long bhi = px_hi > px_lo ? px_hi * channels : blo;
  const int py_end = min(static_cast<int>(blockIdx.y + 1) * kRows, patch);
  for (int py = blockIdx.y * kRows; py < py_end; ++py) {
    const long long sy = y0 + py;
    uint8_t* dst = out + (i * patch + py) * row_bytes;
    if (py < 2 * r && sy >= 0 && sy < h) {
      // Only bytes j in [blo, bhi) are read: their offset is in the slide.
      const long long src = (sy * w + x0) * channels;
      for (long long j = threadIdx.x; j < row_bytes; j += blockDim.x) {
        dst[j] = (j >= blo && j < bhi) ? slide[src + j] : uint8_t(0);
      }
    } else {
      for (long long j = threadIdx.x; j < row_bytes; j += blockDim.x) dst[j] = 0;
    }
  }
}

}  // namespace

// slide: device (h, w, channels) uint8, contiguous; centers: device (n, 2)
// int64 (x, y); out: device (n, patch, patch, channels) uint8. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int extract_patches_launch(const void* slide, const void* centers, void* out,
                                      long long n, long long h, long long w, int channels,
                                      int patch, void* stream) {
  if (n <= 0 || patch <= 0 || channels <= 0 || n > 0x7fffffffLL ||
      (patch + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(n), static_cast<unsigned int>((patch + kRows - 1) / kRows));
  extract_patches_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slide), static_cast<const long long*>(centers),
      static_cast<uint8_t*>(out), h, w, channels, patch);
  return static_cast<int>(cudaGetLastError());
}
