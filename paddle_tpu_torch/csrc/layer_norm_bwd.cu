// Row LayerNorm backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_layernorm.py
// _bwd_kernel (pallas_call in _ln_bwd). Same function: from the forward's
// saved f32 mean and rstd, x̂ = (x - mean)·rstd, g·dy, and
//   dx = (g·dy - mean(g·dy) - x̂·mean(g·dy·x̂))·rstd        (in x's dtype)
// plus per-block f32 partials Σ dy·x̂ (dγ) and Σ dy (dβ) over the block's rows,
// which the wrapper sums, as _ln_bwd sums its grid's partials. gamma may be
// absent (null): ones, as fused_layer_norm fills them. Rows of any length.
//
// What bounds it on the H100: ~12 flops per element against x and dy read and
// dx written (6-12 bytes), far below the card's ~295 flops/byte balance, so
// device memory bounds it. What the design does about it: one warp per row
// for dx, neighbouring lanes on neighbouring elements (coalesced), the row's
// two means by warp shuffles; then the block's 256 threads walk the columns
// of its 8 rows for the partials, re-reading x and dy while they are still in
// L1/L2, so device memory sees about one read of x and dy, one write of dx and
// a (n/8, h) f32 pair of partials.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dg_part,
              float* __restrict__ db_part, int n, int h) {
  __shared__ float s_mean[kRowsPerBlock], s_rstd[kRowsPerBlock];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row = row0 + warp;
  if (row < n) {  // whole warp together: the shuffles stay full-mask
    const size_t off = (size_t)row * h;
    const float mu = mean[row], rs = rstd[row];
    float c1 = 0.f, c2 = 0.f;
    for (int i = lane; i < h; i += 32) {
      const float xh = (to_f(x[off + i]) - mu) * rs;
      const float wdy = to_f(dy[off + i]) * (gamma ? to_f(gamma[i]) : 1.f);
      c1 += wdy;
      c2 = fmaf(wdy, xh, c2);
    }
    c1 = warp_sum(c1) / (float)h;
    c2 = warp_sum(c2) / (float)h;
    for (int i = lane; i < h; i += 32) {
      const float xh = (to_f(x[off + i]) - mu) * rs;
      const float wdy = to_f(dy[off + i]) * (gamma ? to_f(gamma[i]) : 1.f);
      dx[off + i] = from_f<T>((wdy - c1 - xh * c2) * rs);
    }
    if (lane == 0) {
      s_mean[warp] = mu;
      s_rstd[warp] = rs;
    }
  }
  __syncthreads();
  const int rows = min(kRowsPerBlock, n - row0);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    float g = 0.f, b = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t off = (size_t)(row0 + r) * h + i;
      const float d = to_f(dy[off]);
      g = fmaf(d, (to_f(x[off]) - s_mean[r]) * s_rstd[r], g);
      b += d;
    }
    dg_part[(size_t)blockIdx.x * h + i] = g;
    db_part[(size_t)blockIdx.x * h + i] = b;
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* mean, const void* rstd,
                   const void* dy, void* dx, void* dg_part, void* db_part, int n, int h,
                   cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_bwd_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), n, h);
  return cudaGetLastError();
}

}  // namespace

// Rows of partials a launch writes for n rows: the wrapper sizes dg_part and
// db_part (partial_rows, h) f32 with it.
extern "C" int layer_norm_bwd_partial_rows(int n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. x, dy, dx (n, h); gamma (h,) or
// null; mean, rstd (n,) f32; dg_part, db_part (partial_rows, h) f32. Returns a
// cudaError_t.
extern "C" int layer_norm_bwd(const void* x, const void* gamma, const void* mean,
                              const void* rstd, const void* dy, void* dx, void* dg_part,
                              void* db_part, int n, int h, int x_dtype, int w_dtype,
                              void* stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, gamma, mean, rstd, dy, dx, dg_part, db_part, n, h, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, gamma, mean, rstd, dy, dx, dg_part, db_part,
                                             n, h, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, gamma, mean, rstd, dy, dx, dg_part, db_part,
                                             n, h, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, mean, rstd, dy, dx, dg_part,
                                                     db_part, n, h, s);
  return (int)cudaErrorInvalidValue;
}
