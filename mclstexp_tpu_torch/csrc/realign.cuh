// A 16-byte load from any byte address, for the data-movement kernels
// (row_shift.cu's shift_rows16, extract_patches.cu's gather_rows16): their
// output is whole aligned 16-byte chunks, but the source run of a chunk
// starts at any byte. The chunk is read as the one or two aligned 16-byte
// words that hold its valid bytes, shifted right by the start's residue
// (word selects, then a funnel shift), with the bytes outside the valid
// range zeroed. Only words that hold a valid byte are read, so a caller whose
// valid bytes lie in one device allocation reads nothing outside it (device
// allocations are 256-byte aligned).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace realign {

// The bytes n of a 32-bit word below byte n (n in 0..4) set.
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return static_cast<uint32_t>((1ull << (8 * n)) - 1);
}

// 16 bytes from address a: byte q is *(a + q) for q in [vlo, vhi), 0
// otherwise (0 <= vlo < vhi <= 16).
__device__ __forceinline__ uint4 load(uintptr_t a, int vlo, int vhi) {
  const uintptr_t base = a & ~static_cast<uintptr_t>(15);
  const int o = static_cast<int>(a - base);
  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  if (o + vlo < 16) lo = __ldg(reinterpret_cast<const uint4*>(base));
  if (o + vhi > 16) hi = __ldg(reinterpret_cast<const uint4*>(base + 16));
  const uint32_t win[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  // The window shifted right by o bytes: o / 4 whole words, then o % 4 bytes.
  const int ws = o >> 2, bits = (o & 3) * 8;
  uint32_t u[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    u[t] = ws == 0 ? win[t] : ws == 1 ? win[t + 1] : ws == 2 ? win[t + 2] : win[t + 3];
  }
  uint32_t v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] = __funnelshift_r(u[m], u[m + 1], bits);
  if (vlo > 0 || vhi < 16) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int lo_m = min(max(vlo - 4 * m, 0), 4), hi_m = min(max(vhi - 4 * m, 0), 4);
      v[m] &= low_bytes(hi_m) & ~low_bytes(lo_m);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace realign
