// Row LayerNorm forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_layernorm.py
// _fwd_kernel (pallas_call in _ln_fwd). Same function: per row of x (n, h),
// f32 mean, f32 variance as the mean of squared deviations (two passes, as
// the reference does), rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma
// + beta in the input dtype; mean and rstd are written out in f32. Rows of
// any length are taken.
//
// What bounds it on the H100: it does ~8 flops per element against 2-4 bytes
// read and 2-4 bytes written, far below the card's ~295 flops/byte balance, so
// device memory bounds it. What the design does about it: one warp per row,
// neighbouring lanes on neighbouring elements (coalesced), warp-shuffle
// reductions with no shared memory and no second kernel; the row is read
// three times, and the re-reads of a 1.5-3 KB row hit L1/L2, so device
// memory sees roughly one read of x and one write of y. gamma/beta may be
// absent (null) and may have a dtype of their own.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
              T* __restrict__ y, float* __restrict__ mean, float* __restrict__ rstd, int n,
              int h, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n) return;  // whole warp leaves together: the shuffles stay full-mask
  const T* xr = x + (size_t)row * h;
  T* yr = y + (size_t)row * h;

  float s = 0.f;
  for (int i = lane; i < h; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / (float)h;
  float ss = 0.f;
  for (int i = lane; i < h; i += 32) {
    const float c = to_f(xr[i]) - mu;
    ss = fmaf(c, c, ss);
  }
  const float rs = rsqrtf(warp_sum(ss) / (float)h + eps);
  for (int i = lane; i < h; i += 32) {
    float v = (to_f(xr[i]) - mu) * rs;
    if (gamma) v *= to_f(gamma[i]);
    if (beta) v += to_f(beta[i]);
    yr[i] = from_f<T>(v);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                   void* rstd, int n, int h, float eps, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma), static_cast<const W*>(beta),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), n, h, eps);
  return cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. x, y (n, h); gamma, beta (h,) or null;
// mean, rstd (n,) f32. Returns a cudaError_t.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              void* mean, void* rstd, int n, int h, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, gamma, beta, y, mean, rstd, n, h, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, n, h, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps,
                                                     s);
  return (int)cudaErrorInvalidValue;
}
