// Flash-attention forward for Hopper (sm_90a), fp32. Replaces the TPU kernel
// that the spot tower reaches with attn_backend="flash":
// jax.experimental.pallas.ops.tpu.flash_attention (flash_attention ->
// _flash_attention_impl), called at mclstexp_tpu/core/layers.py:201-219.
//
//   out[b, i, h, :] = sum_j softmax_j(q[b, h, i, :] . k[b, h, j, :] * scale) v[b, h, j, :]
//
// What it computes is the TPU kernel's function: an online softmax over key
// tiles, so no (n, n) matrix ever reaches device memory, with running max
// and sum in fp32 and the output normalized once at the end. Segment ids
// (the key mask) are not supported yet; the wrapper raises for them.
//
// Residuals: given non-null `l_out` and `m_out`, the kernel also writes each
// row's final max m and sum l = sum_j exp(s_j - m) as contiguous fp32
// (b, h, n) arrays, what the TPU kernel keeps with save_residuals for its
// backward (csrc/flash_attention_bwd.cu recomputes p = exp(s - m) / l from
// them). With null pointers it writes the output only.
//
// Bound: at the spot tower's shapes (b=1, h=8, d=64, n=32 on the eval
// sweep, n=128 at train) the kernel moves 4*b*h*n*d*4 bytes (q, k, v read,
// out written; 262 KB at n=32) and does 4*b*h*n^2*d flops (2.1 MFLOP at
// n=32). Both take well under a microsecond at 3.35 TB/s and 67 TFLOP/s
// (fp32, no tensor cores), so at these sizes a launch is bound by its fixed
// latency, not by bytes or flops. Making it fast at long sequences (wgmma,
// TMA, bf16 tensor cores) is later work.
//
// Design: one CTA per (batch*head, block of 32 query rows), 256 threads,
// 8 threads per query row. The CTA stages its Q tile once, then walks the
// keys in tiles of BK rows staged in shared memory (K and V). Each thread
// computes BK/8 scores of its row, the 8 threads of a row (consecutive
// lanes of one warp) reduce the tile max and sum with shuffles, write the
// probabilities to shared memory, and accumulate D/8 output columns in
// registers. Any n: rows past n and keys past n are masked (keys score
// -inf, rows are not written). Any d <= 128: the tile width D is 32, 64 or
// 128 and columns past d are zero-filled on load. Plain fp32 FMA math.
//
// q, k, v are read through strides, so the three views of the (b, n, 3, h,
// d) buffer that the qkv projection produces are read in place, with no
// transpose copied; the output is written as a contiguous (b, n, h, d)
// buffer, the layout the output projection reads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kThreads = 256;
constexpr int kRowLanes = kThreads / kBlockQ;  // 8 threads per query row

struct Strides {
  long long b, h, n;  // in elements; the head dimension is contiguous
};

// Keys per tile: 32, or 16 at D=128 so that static shared memory stays
// under 48 KB.
template <int D>
struct Tile {
  static constexpr int kBlockK = D > 64 ? 16 : 32;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ l_out,
              float* __restrict__ m_out, Strides sq, Strides sk, Strides sv, Strides so,
              int heads, int n, int d, float scale) {
  constexpr int BK = Tile<D>::kBlockK;
  constexpr int kScores = BK / kRowLanes;  // scores per thread per tile
  constexpr int kCols = D / kRowLanes;     // output columns per thread
  // Rows padded by one word: the 4 rows of a warp (q) and the 8 key rows a
  // warp reads at once (k) fall in different banks.
  __shared__ float qs[kBlockQ][D + 1];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[kBlockQ][BK + 1];

  const int bh = blockIdx.x;
  const long long b = bh / heads;
  const long long h = bh - b * heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kRowLanes;
  const int lane = tid % kRowLanes;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    qs[r][c] = (qi < n && c < d) ? qb[qi * sq.n + c] : 0.f;
  }

  float m = -INFINITY;  // running max of this row's scores
  float l = 0.f;        // running sum of exp(score - m)
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool ok = kj < n && c < d;
      ks[r][c] = ok ? kb[kj * sk.n + c] : 0.f;
      vs[r][c] = ok ? vb[kj * sv.n + c] : 0.f;
    }
    __syncthreads();

    float s[kScores];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int c = lane + kRowLanes * j;
      float dot = 0.f;
#pragma unroll 16
      for (int t = 0; t < D; ++t) dot = fmaf(qs[row][t], ks[c][t], dot);
      s[j] = (k0 + c < n) ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    // Every tile holds at least one key < n, so m_new is finite; on the
    // first tile m is -inf and alpha is 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const float p = expf(s[j] - m_new);
      ps[row][lane + kRowLanes * j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's probabilities are written and read by one warp

#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] *= alpha;
    const int kmax = min(BK, n - k0);
    for (int c = 0; c < kmax; ++c) {
      const float p = ps[row][c];
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] = fmaf(p, vs[c][lane + kRowLanes * e], acc[e]);
    }
  }

  const int qi = q0 + row;
  if (qi < n) {
    const float inv = 1.f / l;
    float* ob = out + b * so.b + h * so.h + qi * so.n;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = lane + kRowLanes * e;
      if (col < d) ob[col] = acc[e] * inv;
    }
    // Every lane of the row holds the same m and l (reduced by shuffles).
    if (l_out != nullptr && lane == 0) {
      const long long r = static_cast<long long>(bh) * n + qi;
      l_out[r] = l;
      m_out[r] = m;
    }
  }
}

template <int D>
void launch(const float* q, const float* k, const float* v, float* out, float* l_out,
            float* m_out, Strides sq, Strides sk, Strides sv, Strides so, int batch, int heads,
            int n, int d, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(batch) * static_cast<unsigned int>(heads),
                  static_cast<unsigned int>((n + kBlockQ - 1) / kBlockQ));
  flash_fwd<D><<<grid, kThreads, 0, stream>>>(q, k, v, out, l_out, m_out, sq, sk, sv, so,
                                              heads, n, d, scale);
}

}  // namespace

// q, k, v: device fp32 buffers read as (batch, heads, n, d) through the
// given element strides (the last dimension contiguous); out: written as
// (batch, heads, n, d) through its strides; l_out, m_out: null, or both
// contiguous fp32 (batch, heads, n) buffers for the residuals. 1 <= d <=
// 128, n >= 1, ceil(n / 32) <= 65535. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* l_out, void* m_out,
    long long sq_b, long long sq_h, long long sq_n, long long sk_b, long long sk_h,
    long long sk_n, long long sv_b, long long sv_h, long long sv_n, long long so_b,
    long long so_h, long long so_n, int batch, int heads, int n, int d, float scale,
    void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || d < 1 || d > 128 ||
      (n + kBlockQ - 1) / kBlockQ > 65535 || (l_out == nullptr) != (m_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{sq_b, sq_h, sq_n}, sk{sk_b, sk_h, sk_n}, sv{sv_b, sv_h, sv_n},
      so{so_b, so_h, so_n};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(l_out);
  float* mf = static_cast<float*>(m_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) {
    launch<32>(qf, kf, vf, of, lf, mf, sq, sk, sv, so, batch, heads, n, d, scale, s);
  } else if (d <= 64) {
    launch<64>(qf, kf, vf, of, lf, mf, sq, sk, sv, so, batch, heads, n, d, scale, s);
  } else {
    launch<128>(qf, kf, vf, of, lf, mf, sq, sk, sv, so, batch, heads, n, d, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
