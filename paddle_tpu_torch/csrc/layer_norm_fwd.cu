// Row LayerNorm forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_layernorm.py
// _fwd_kernel (:26, pallas_call in _ln_fwd :76). Same function: per row of x
// (n, h), f32 mean, f32 variance as the mean of squared deviations from it
// (two passes, as the reference does; never E[x²] - mean²), rstd =
// rsqrt(var + eps), y = (x - mean) * rstd * gamma + beta in the input dtype;
// mean and rstd are written out in f32. Rows of any length are taken.
// gamma/beta may be absent (null) and may have a dtype of their own.
//
// What bounds it on the H100: ~8 flops per element against 2-4 bytes read and
// 2-4 bytes written, far below the card's ~295 flops/byte balance, so device
// memory: at (1024, 768) 6.3 MB in f32, 1.9 µs at 3.35 TB/s (3.1 MB, 0.9 µs
// in bf16). At the shapes the port runs (128-1024 rows of 768) a call is so
// small that one round trip to memory and the launch weigh as much.
//
// What the design does about it:
// - One warp per row, and the grid spreads the rows over the SMs:
//   ceil(n / SMs) warps per block, up to 8, so n = 128 (serving bucket 1)
//   is 128 blocks of one warp, not 32 of four. A grid past what can be
//   resident at once is cut to that, and each warp takes rows in a stride.
// - A row of up to 1024 elements is read once into registers, every load of
//   a lane issued before the first is used: 16-byte loads where the rows are
//   whole 16-byte chunks and x, y, gamma and beta are 16-byte aligned, else
//   one element per lane and load. The mean, then the squared deviations
//   from it, come from those registers, summed in eight short chains of
//   adds, and y goes out in 16-byte stores. The next row's loads are issued
//   right after this row's stores.
// - gamma and beta of x's width are staged once per block in shared memory,
//   16 bytes a lane, all loads in flight at once, while the first row's loads
//   are in flight; every warp's rows read them from there. (Staged per warp,
//   the 8 warps of a block would fetch them 8 times: at (1024, 768) f32
//   6.3 MB from L2, twice x itself; per block 0.8 MB.) Of another width
//   (bf16 x with f32 gamma) each element is read where it is used, from L1.
// - Longer rows stream: the mean, the deviations and y each read the row
//   (the second and third reads mostly from L1/L2).
// What is left at the serving and training shapes is mostly fixed: on the
// H100 a call of it takes 1.4-1.9 µs more than a one-element fill_
// (chip_smoke.py phase 6), and the fill_ itself about 5 µs.
#include <math.h>
#include <stdint.h>

#include "ln_rows.cuh"

namespace {

constexpr int kMaxWarps = 8;      // warps per block, each on one row at a time
constexpr int kMaxCached = 1024;  // longest row held in registers

// 16 bytes of W holding 1.0 in every element: gamma where it is absent.
template <typename W>
__device__ __forceinline__ uint4 ones16();
template <>
__device__ __forceinline__ uint4 ones16<float>() {
  return make_uint4(0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u);
}
template <>
__device__ __forceinline__ uint4 ones16<__nv_bfloat16>() {
  return make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
}

// beta[c] as f32, or 0 where beta is absent (null).
template <typename W>
__device__ __forceinline__ float beta_at(const W* beta, int c) {
  return beta ? load_f(beta + c) : 0.f;
}

// A row held in registers: CH chunks per lane of V elements each; chunk j of
// a lane holds columns (32 j + lane)·V .. + V - 1. V = 16 bytes of T (the row
// is whole 16-byte chunks), in xv; or 1, in xs. Columns past h hold 0.
template <typename T, int V, int CH>
__device__ __forceinline__ void load_row(const T* __restrict__ x, uint4 (&xv)[CH],
                                         float (&xs)[CH], int h, int lane) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c0 = (32 * j + lane) * V;
    if constexpr (V > 1)
      xv[j] = c0 < h ? __ldg(reinterpret_cast<const uint4*>(x + c0)) : make_uint4(0, 0, 0, 0);
    else
      xs[j] = c0 < h ? load_f(x + c0) : 0.f;
  }
}

template <typename T, int V, int CH>
__device__ __forceinline__ float row_elem(const uint4 (&xv)[CH], const float (&xs)[CH], int j,
                                          int e) {
  if constexpr (V > 1)
    return lane_elem<T>(xv[j], e);
  else
    return xs[j];
}

// Eight partial sums added in a fixed tree.
__device__ __forceinline__ float sum8(const float (&a)[8]) {
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// mean, rstd and y of a row loaded by load_row. The lane's sums go to eight
// partial sums in turn (eight short chains of adds, not one long one). GS:
// gamma and beta are in shared memory (sg, sb: 16 bytes of W = T per chunk),
// else read from device memory where they are used.
template <typename T, typename W, int V, int CH, bool GS>
__device__ __forceinline__ void finish_row(const uint4 (&xv)[CH], const float (&xs)[CH],
                                           const W* __restrict__ gamma,
                                           const W* __restrict__ beta, const W* sg,
                                           const W* sb, T* __restrict__ y, int h, float eps,
                                           int lane, float& mu, float& rs) {
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[(j * V + e) & 7] += row_elem<T, V, CH>(xv, xs, j, e);
  mu = warp_sum(sum8(acc)) / (float)h;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if ((32 * j + lane) * V < h) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = row_elem<T, V, CH>(xv, xs, j, e) - mu;
        acc[(j * V + e) & 7] = fmaf(c, c, acc[(j * V + e) & 7]);
      }
    }
  rs = rsqrtf(warp_sum(sum8(acc)) / (float)h + eps);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c0 = (32 * j + lane) * V;
    if (c0 < h) {
      if constexpr (V > 1) {
        uint4 gc = make_uint4(0, 0, 0, 0), bc = make_uint4(0, 0, 0, 0);
        if constexpr (GS) {
          gc = *reinterpret_cast<const uint4*>(sg + c0);
          bc = *reinterpret_cast<const uint4*>(sb + c0);
        }
        uint4 out = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float g, b;
          if constexpr (GS) {
            g = lane_elem<W>(gc, e);
            b = lane_elem<W>(bc, e);
          } else {
            g = gamma_at(gamma, c0 + e);
            b = beta_at(beta, c0 + e);
          }
          set_elem<T>(out, e, (row_elem<T, V, CH>(xv, xs, j, e) - mu) * rs * g + b);
        }
        *reinterpret_cast<uint4*>(y + c0) = out;
      } else {
        y[c0] = from_f<T>((xs[j] - mu) * rs * gamma_at(gamma, c0) + beta_at(beta, c0));
      }
    }
  }
}

// A row of any length, streamed: read for the mean, again for the squared
// deviations, and again for y.
template <typename T, typename W>
__device__ __forceinline__ void row_streamed(const T* __restrict__ x, const W* __restrict__ gamma,
                                             const W* __restrict__ beta, T* __restrict__ y,
                                             int h, float eps, int lane, float& mu, float& rs) {
  float s = 0.f;
#pragma unroll 4
  for (int c = lane; c < h; c += 32) s += to_f(x[c]);
  mu = warp_sum(s) / (float)h;
  float ss = 0.f;
#pragma unroll 4
  for (int c = lane; c < h; c += 32) {
    const float d = to_f(x[c]) - mu;
    ss = fmaf(d, d, ss);
  }
  rs = rsqrtf(warp_sum(ss) / (float)h + eps);
  for (int c = lane; c < h; c += 32)
    y[c] = from_f<T>((to_f(x[c]) - mu) * rs * gamma_at(gamma, c) + beta_at(beta, c));
}

// PATH 0: rows in registers with 16-byte accesses; 1: in registers, one
// element per lane and access; 2: streamed. Dynamic shared memory: gamma then
// beta, h elements of W each, where they have x's width on PATH 0.
template <typename T, typename W, int PATH>
__global__ void __launch_bounds__(32 * kMaxWarps)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
              T* __restrict__ y, float* __restrict__ mean, float* __restrict__ rstd, int n,
              int h, float eps) {
  constexpr int V = PATH == 0 ? 16 / (int)sizeof(T) : 1;
  constexpr int CH = kMaxCached / (32 * V);
  constexpr bool GS = PATH == 0 && sizeof(W) == sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  W* sg = reinterpret_cast<W*>(smem);
  W* sb = sg + h;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if constexpr (PATH == 2) {
    for (; row < n; row += warps) {  // whole warps: the shuffles stay full-mask
      float mu, rs;
      const size_t off = (size_t)row * h;
      row_streamed<T, W>(x + off, gamma, beta, y + off, h, eps, lane, mu, rs);
      if (lane == 0) {
        mean[row] = mu;
        rstd[row] = rs;
      }
    }
  } else {
    uint4 xv[CH];
    float xs[CH];
    // the first row's loads in flight while the block stages gamma and beta
    if (row < n) load_row<T, V, CH>(x + (size_t)row * h, xv, xs, h, lane);
    if constexpr (GS) {
      // warp w stages chunks w, w + nw, ... of the lanes' pattern, all of its
      // loads in flight at once, then one barrier
      const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
      uint4 gc[CH], bc[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c0 = (32 * j + lane) * V;
        if (j % nw == w && c0 < h) {
          gc[j] = gamma ? __ldg(reinterpret_cast<const uint4*>(gamma + c0)) : ones16<W>();
          bc[j] = beta ? __ldg(reinterpret_cast<const uint4*>(beta + c0)) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c0 = (32 * j + lane) * V;
        if (j % nw == w && c0 < h) {
          *reinterpret_cast<uint4*>(sg + c0) = gc[j];
          *reinterpret_cast<uint4*>(sb + c0) = bc[j];
        }
      }
      __syncthreads();
    }
    while (row < n) {  // whole warps: the shuffles stay full-mask
      float mu, rs;
      finish_row<T, W, V, CH, GS>(xv, xs, gamma, beta, sg, sb, y + (size_t)row * h, h, eps,
                                  lane, mu, rs);
      if (lane == 0) {
        mean[row] = mu;
        rstd[row] = rs;
      }
      row += warps;
      if (row < n) load_row<T, V, CH>(x + (size_t)row * h, xv, xs, h, lane);
    }
  }
}

// The launch's shape for n rows of h elements on a card of `sms` SMs; the
// launch may cut `blocks` further to what can be resident at once.
struct Plan {
  int path, warps, blocks;
};

Plan plan(int n, int h, int vec, int sms) {
  Plan p;
  p.path = h > kMaxCached ? 2 : (vec ? 0 : 1);
  // the rows spread over the SMs: one block per SM while n <= 8·SMs
  p.warps = (n + sms - 1) / sms;
  if (p.warps > kMaxWarps) p.warps = kMaxWarps;
  p.blocks = (n + p.warps - 1) / p.warps;
  return p;
}

template <typename T, typename W, int PATH>
cudaError_t launch_path(Plan p, int sms, const void* x, const void* gamma, const void* beta,
                        void* y, void* mean, void* rstd, int n, int h, float eps,
                        cudaStream_t stream) {
  auto kernel = ln_fwd_kernel<T, W, PATH>;
  const int smem = PATH == 0 && sizeof(W) == sizeof(T) ? 2 * h * (int)sizeof(W) : 0;
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * p.warps, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (p.blocks > per_sm * sms) p.blocks = per_sm * sms;  // the warps then stride over the rows
  kernel<<<p.blocks, 32 * p.warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma), static_cast<const W*>(beta),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), n, h, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                   void* rstd, int n, int h, float eps, cudaStream_t stream) {
  const int vec = rows_in_16_bytes(h, (int)sizeof(T),
                                   (uintptr_t)x | (uintptr_t)y | (uintptr_t)gamma |
                                       (uintptr_t)beta);
  const int sms = card_sms();
  const Plan p = plan(n, h, vec, sms);
  if (p.path == 0)
    return launch_path<T, W, 0>(p, sms, x, gamma, beta, y, mean, rstd, n, h, eps, stream);
  if (p.path == 1)
    return launch_path<T, W, 1>(p, sms, x, gamma, beta, y, mean, rstd, n, h, eps, stream);
  return launch_path<T, W, 2>(p, sms, x, gamma, beta, y, mean, rstd, n, h, eps, stream);
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. x, y (n, h); gamma, beta (h,) or null;
// mean, rstd (n,) f32. Returns a cudaError_t.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              void* mean, void* rstd, int n, int h, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_ARGS x, gamma, beta, y, mean, rstd, n, h, eps, s
  if (x_dtype == 0 && w_dtype == 0) return (int)launch<float, float>(LN_ARGS);
  if (x_dtype == 0 && w_dtype == 1) return (int)launch<float, __nv_bfloat16>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 0) return (int)launch<__nv_bfloat16, float>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(LN_ARGS);
#undef LN_ARGS
  return (int)cudaErrorInvalidValue;
}
