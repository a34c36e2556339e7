// Per-row pixel shift, the building block of the Paeth shear rotation, for
// Hopper (sm_90a). Replaces the TPU kernel
// mclstexp_tpu/ops/pallas_shift.py::_row_shift_kernel (wrapper row_shift).
//
//   out[b, y, x, :] = in[b, y, x - k[b, y], :]
//   zero where x - k leaves [0, W); k clamped to [-W/2, W/2].
//
// Bound: pure data movement. Each element is read once and written once,
// 2 * B*H*W*C*itemsize bytes plus B*H*4 bytes of shifts. At the flagship
// shape (128, 224, 224, 3) that is 154 MB in f32 (46 us at 3.35 TB/s) and
// 77 MB in bf16 (23 us).
//
// Design: one block per memory row; the block's threads stride over that
// row's elements, so stores are coalesced and loads read a contiguous run of
// the source. The TPU kernel rolls a zero-padded lane axis; here each output
// element reads its source or writes 0, and nothing is padded. The copy is
// bit-exact (elements move as raw 16- or 32-bit words).
//
// Two layouts of the same function:
//  * rows: the image is a contiguous (B, H, W, C) buffer; memory row (b, y)
//    moves by k[b, y] * C elements.
//  * cols: the image is the (1, 2)-transpose of a contiguous (B, W, H, C)
//    buffer T (the column shear of the Paeth rotation). In T's memory order
//    the shift reads T_in[b, r - k[b, s], s, :] for T_out[b, r, s, :], so the
//    transposed view is shifted without copying it; neighbouring threads
//    read neighbouring pixels of rows that differ by at most one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
void launch(const void* in, void* out, const int* shifts, int batch, int rows,
            int row_px, int channels, int col_mode, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(batch) * static_cast<unsigned int>(rows));
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (col_mode) {
    shift_cols<T><<<grid, kThreads, 0, stream>>>(src, dst, shifts, rows, row_px, channels);
  } else {
    shift_rows<T><<<grid, kThreads, 0, stream>>>(src, dst, shifts, row_px, channels);
  }
}

}  // namespace

// in/out: device buffers of batch * rows * row_px * channels elements of
// itemsize bytes (4: f32, 2: bf16); shifts: device int32, (batch, rows) in
// row mode and (batch, row_px) in column mode. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int row_shift_launch(const void* in, void* out, const int* shifts, int batch,
                                int rows, int row_px, int channels, int itemsize,
                                int col_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    launch<uint32_t>(in, out, shifts, batch, rows, row_px, channels, col_mode, s);
  } else if (itemsize == 2) {
    launch<uint16_t>(in, out, shifts, batch, rows, row_px, channels, col_mode, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
