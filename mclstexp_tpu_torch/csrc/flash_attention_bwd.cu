// Flash-attention backward for Hopper (sm_90a), fp32: the gradients of
// out = softmax(q k^T * scale) v with respect to q, k and v. Replaces the two
// TPU kernels of jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0)
// that jax.grad reaches through the spot tower with attn_backend="flash"
// (mclstexp_tpu/core/layers.py:201-219):
//   _flash_attention_bwd_dkv (pallas_call :1121, kernel :796) -> flash_bwd_dkv
//   _flash_attention_bwd_dq  (pallas_call :1456, kernel :1146) -> flash_bwd_dq
//
// Both recompute the probabilities from the forward's residuals, the row max
// m and row sum l (csrc/flash_attention.cu), so no (n, n) matrix reaches
// device memory, and take di = rowsum(out * dout) from the caller (the JAX
// library computes it outside its kernels too, :273-275):
//   p  = exp(s - m) / l,    s = q k^T * scale
//   dp = dout v^T,          ds = p * (dp - di) * scale
//   dv = p^T dout,  dk = ds^T q,  dq = ds k
//
// Bound: at the training shape (b=1, h=8, n=128, d=64) dK/dV moves q, k, v,
// dout in and dk, dv out (6*b*h*n*d*4 bytes, 1.6 MB) plus l, m, di and does
// 8*b*h*n^2*d flops (67 MFLOP); dQ moves 5*b*h*n*d*4 bytes and does
// 6*b*h*n^2*d flops. At 3.35 TB/s and the fp32 peak of 67 TFLOP/s outside
// the tensor cores both bounds are about a microsecond: at this size the
// kernels are bound by latency (few CTAs, each walking its tiles in turn),
// not by bytes or flops. Tensor cores, cp.async and more CTAs are later
// work; these kernels are the simple, exact form.
//
// Design. The TPU kernels carry their sums across a sequential grid
// dimension in VMEM scratch (dk_scratch/dv_scratch, dq_scratch). Here a loop
// inside the CTA takes that dimension's place, the sums stay in registers,
// and each output row is written once: no atomics, so every run gives the
// same bits.
//   flash_bwd_dkv: one CTA per (batch*head, block of R keys). It stages its
//     K and V rows in shared memory once, then walks all queries in tiles of
//     T rows (q, dout, m, 1/l, di staged per tile). Each key row is owned by
//     8 consecutive lanes of one warp: every lane computes T/8 scores and
//     dp values of the row, writes p and ds to shared memory, and then
//     accumulates D/8 columns of dv += p^T dout and dk += ds^T q.
//   flash_bwd_dq: one CTA per (batch*head, block of R queries), the same
//     layout with the roles swapped: it stages its q and dout rows once and
//     walks the keys in tiles of T rows, accumulating dq += ds k.
// R = T = 32 rows at d <= 64 (256 threads), 16 at d = 128 (128 threads),
// so that static shared memory stays under 48 KB. Any n: query rows past n
// get p = 0, key rows past n are zero-filled and not written. Any d <= 128:
// the tile width D is 32, 64 or 128 and columns past d are zero-filled.
// Inputs are read through strides with the last dimension contiguous (the
// views of the qkv projection's (b, n, 3, h, d) buffer in place); l, m and
// di are contiguous (b, h, n); outputs are written through their strides.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 8;  // threads per owned row

struct Strides {
  long long b, h, n;  // in elements; the head dimension is contiguous
};

template <int D>
struct Tile {
  static constexpr int R = D > 64 ? 16 : 32;  // rows owned by a CTA
  static constexpr int T = R;                 // rows of the other side per tile
  static constexpr int kThreads = R * kLanes;
};

// rows [r0, r0 + ROWS) of a (n, d) matrix with row stride `stride` into
// shared memory, zero past n and past d.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const float* __restrict__ src,
                                          long long stride, int r0, int n, int d) {
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[r][c] = (g < n && c < d) ? src[g * stride + c] : 0.f;
  }
}

// dot of two shared-memory rows of width D
template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int e = 0; e < D; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
    flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ l, const float* __restrict__ m,
                  const float* __restrict__ di, float* __restrict__ dk,
                  float* __restrict__ dv, Strides sq, Strides sk, Strides sv, Strides sdo,
                  Strides sdk, Strides sdv, int heads, int n, int d, float scale) {
  constexpr int R = Tile<D>::R, T = Tile<D>::T;
  constexpr int kScores = T / kLanes;  // query scores per thread per tile
  constexpr int kCols = D / kLanes;    // dk and dv columns per thread
  // Rows padded by one word, so the 8 rows a warp reads at once in the dot
  // products fall in different banks.
  __shared__ float ks[R][D + 1];
  __shared__ float vs[R][D + 1];
  __shared__ float qs[T][D + 1];
  __shared__ float dos[T][D + 1];
  __shared__ float ps[R][T + 1];
  __shared__ float dss[R][T + 1];
  __shared__ float ms[T], linv[T], dis[T];

  const int bh = blockIdx.x;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int k0 = blockIdx.y * R;
  const int row = threadIdx.x / kLanes;  // the key row this thread works on
  const int lane = threadIdx.x % kLanes;
  const long long rb = static_cast<long long>(bh) * n;  // l, m, di of this head

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  load_rows<R, D>(ks, k + b * sk.b + h * sk.h, sk.n, k0, n, d);
  load_rows<R, D>(vs, v + b * sv.b + h * sv.h, sv.n, k0, n, d);

  float acc_dk[kCols], acc_dv[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc_dk[e] = acc_dv[e] = 0.f;

  for (int q0 = 0; q0 < n; q0 += T) {
    __syncthreads();  // the previous tile's qs/dos/ps/dss are no longer read
    load_rows<T, D>(qs, qb, sq.n, q0, n, d);
    load_rows<T, D>(dos, dob, sdo.n, q0, n, d);
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const int qi = q0 + i;
      const bool ok = qi < n;
      ms[i] = ok ? m[rb + qi] : 0.f;
      linv[i] = ok ? 1.f / l[rb + qi] : 0.f;
      dis[i] = ok ? di[rb + qi] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kScores; ++t) {
      const int c = lane + kLanes * t;  // query row in the tile
      const float s = dot<D>(ks[row], qs[c]) * scale;
      const float dp = dot<D>(vs[row], dos[c]);
      const float p = (q0 + c < n) ? expf(s - ms[c]) * linv[c] : 0.f;
      ps[row][c] = p;
      dss[row][c] = p * (dp - dis[c]) * scale;
    }
    __syncwarp();  // a row's p and ds are written and read by one warp

    const int qmax = min(T, n - q0);
    for (int c = 0; c < qmax; ++c) {
      const float p = ps[row][c];
      const float ds = dss[row][c];
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int col = lane + kLanes * e;
        acc_dv[e] = fmaf(p, dos[c][col], acc_dv[e]);
        acc_dk[e] = fmaf(ds, qs[c][col], acc_dk[e]);
      }
    }
  }

  const int kj = k0 + row;
  if (kj < n) {
    float* dkb = dk + b * sdk.b + h * sdk.h + kj * sdk.n;
    float* dvb = dv + b * sdv.b + h * sdv.h + kj * sdv.n;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = lane + kLanes * e;
      if (col < d) {
        dkb[col] = acc_dk[e];
        dvb[col] = acc_dv[e];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ l, const float* __restrict__ m,
                 const float* __restrict__ di, float* __restrict__ dq, Strides sq, Strides sk,
                 Strides sv, Strides sdo, Strides sdq, int heads, int n, int d, float scale) {
  constexpr int R = Tile<D>::R, T = Tile<D>::T;
  constexpr int kScores = T / kLanes;  // key scores per thread per tile
  constexpr int kCols = D / kLanes;    // dq columns per thread
  __shared__ float qs[R][D + 1];
  __shared__ float dos[R][D + 1];
  __shared__ float ks[T][D + 1];
  __shared__ float vs[T][D + 1];
  __shared__ float dss[R][T + 1];

  const int bh = blockIdx.x;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int q0 = blockIdx.y * R;
  const int row = threadIdx.x / kLanes;  // the query row this thread works on
  const int lane = threadIdx.x % kLanes;
  const int qi = q0 + row;
  const long long rb = static_cast<long long>(bh) * n;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  load_rows<R, D>(qs, q + b * sq.b + h * sq.h, sq.n, q0, n, d);
  load_rows<R, D>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, n, d);
  const bool live = qi < n;
  const float mi = live ? m[rb + qi] : 0.f;
  const float linv = live ? 1.f / l[rb + qi] : 0.f;
  const float dii = live ? di[rb + qi] : 0.f;

  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += T) {
    __syncthreads();  // the previous tile's ks/vs/dss are no longer read
    load_rows<T, D>(ks, kb, sk.n, k0, n, d);
    load_rows<T, D>(vs, vb, sv.n, k0, n, d);
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kScores; ++t) {
      const int c = lane + kLanes * t;  // key row in the tile
      const float s = dot<D>(qs[row], ks[c]) * scale;
      const float dp = dot<D>(dos[row], vs[c]);
      const float p = (live && k0 + c < n) ? expf(s - mi) * linv : 0.f;
      dss[row][c] = p * (dp - dii) * scale;
    }
    __syncwarp();  // a row's ds is written and read by one warp

    const int kmax = min(T, n - k0);
    for (int c = 0; c < kmax; ++c) {
      const float ds = dss[row][c];
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] = fmaf(ds, ks[c][lane + kLanes * e], acc[e]);
    }
  }

  if (live) {
    float* dqb = dq + b * sdq.b + h * sdq.h + qi * sdq.n;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = lane + kLanes * e;
      if (col < d) dqb[col] = acc[e];
    }
  }
}

template <int D>
dim3 grid_of(int batch, int heads, int n) {
  return dim3(static_cast<unsigned int>(batch) * static_cast<unsigned int>(heads),
              static_cast<unsigned int>((n + Tile<D>::R - 1) / Tile<D>::R));
}

bool valid(int batch, int heads, int n, int d) {
  const int rows = d > 64 ? Tile<128>::R : Tile<64>::R;
  return batch >= 1 && heads >= 1 && n >= 1 && d >= 1 && d <= 128 &&
         (n + rows - 1) / rows <= 65535;
}

template <int D>
void launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                const float* l, const float* m, const float* di, float* dk, float* dv,
                const Strides* s, int batch, int heads, int n, int d, float scale,
                cudaStream_t stream) {
  flash_bwd_dkv<D><<<grid_of<D>(batch, heads, n), Tile<D>::kThreads, 0, stream>>>(
      q, k, v, dout, l, m, di, dk, dv, s[0], s[1], s[2], s[3], s[4], s[5], heads, n, d,
      scale);
}

template <int D>
void launch_dq(const float* q, const float* k, const float* v, const float* dout,
               const float* l, const float* m, const float* di, float* dq, const Strides* s,
               int batch, int heads, int n, int d, float scale, cudaStream_t stream) {
  flash_bwd_dq<D><<<grid_of<D>(batch, heads, n), Tile<D>::kThreads, 0, stream>>>(
      q, k, v, dout, l, m, di, dq, s[0], s[1], s[2], s[3], s[4], heads, n, d, scale);
}

}  // namespace

// q, k, v, dout: device fp32 buffers read as (batch, heads, n, d) through
// the given element strides (3 per tensor: batch, head, row; the last
// dimension contiguous); l, m, di: contiguous fp32 (batch, heads, n); dk,
// dv: written as (batch, heads, n, d) through their strides. 1 <= d <= 128,
// n >= 1. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dk, void* dv, const long long* strides, int batch,
    int heads, int n, int d, float scale, void* stream) {
  if (!valid(batch, heads, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int i = 0; i < 6; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* dif = static_cast<const float*>(di);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) {
    launch_dkv<32>(qf, kf, vf, dof, lf, mf, dif, dkf, dvf, s, batch, heads, n, d, scale, st);
  } else if (d <= 64) {
    launch_dkv<64>(qf, kf, vf, dof, lf, mf, dif, dkf, dvf, s, batch, heads, n, d, scale, st);
  } else {
    launch_dkv<128>(qf, kf, vf, dof, lf, mf, dif, dkf, dvf, s, batch, heads, n, d, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same inputs; dq written as (batch, heads, n, d) through its strides
// (5 stride triples: q, k, v, dout, dq).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* l,
    const void* m, const void* di, void* dq, const long long* strides, int batch, int heads,
    int n, int d, float scale, void* stream) {
  if (!valid(batch, heads, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[5];
  for (int i = 0; i < 5; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* dif = static_cast<const float*>(di);
  float* dqf = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) {
    launch_dq<32>(qf, kf, vf, dof, lf, mf, dif, dqf, s, batch, heads, n, d, scale, st);
  } else if (d <= 64) {
    launch_dq<64>(qf, kf, vf, dof, lf, mf, dif, dqf, s, batch, heads, n, d, scale, st);
  } else {
    launch_dq<128>(qf, kf, vf, dof, lf, mf, dif, dqf, s, batch, heads, n, d, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}
