// Row LayerNorm backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_layernorm.py
// _bwd_kernel (:39), called by pallas_call in _ln_bwd (:105), and the sum of
// its grid's partial rows that _ln_bwd adds after it. Same function: from the
// forward's saved f32 mean and rstd, x̂ = (x - mean)·rstd, g·dy, and
//   dx = (g·dy - mean(g·dy) - x̂·mean(g·dy·x̂))·rstd        (in x's dtype)
//   dγ = Σ_rows dy·x̂,  dβ = Σ_rows dy                    (f32 sums, in γ's dtype)
// gamma may be absent (null): ones, as fused_layer_norm fills them, and dγ, dβ
// are then f32. Rows of any length.
//
// What bounds it on the H100: ~12 flops per element against x and dy read and
// dx written (6-12 bytes), far below the card's ~295 flops/byte balance, so
// device memory bounds it: at (1024, 768) 9.4 MB in f32, 2.8 µs at 3.35 TB/s
// (4.7 MB, 1.4 µs in bf16).
//
// What the design does about it, in ONE launch that writes dx, dγ and dβ in
// their final dtypes:
// - A grid of at most two blocks per SM walks the rows, one warp per row, each
//   block a contiguous run of rows. A row of up to 1024 elements is read once
//   into registers (16-byte vector loads where h·sizeof(T) is a multiple of 16
//   and the pointers are aligned, else one element per lane and load), all of
//   its loads in flight at once; both means and dx come from those registers.
//   Longer rows are streamed and read twice (the second read mostly from L2).
// - Each warp adds its rows' dy·x̂ and dy into its own column partials in
//   shared memory (its lanes own their columns: no atomics), and the block
//   sums its warps' partials in warp order into one partial row in scratch.
//   (A row too long for shared memory: one warp per block, adding into the
//   block's partial row in scratch directly.)
// - The grid is launched cooperatively, so every block is resident at once,
//   and after one grid barrier each block sums its own slice of the columns
//   over all partial rows, several threads per column with their loads in
//   flight together, their sums then added in a fixed order, and writes that
//   slice of dγ and dβ in γ's dtype. No float atomics: the result is
//   bit-identical from run to run. Why not the last block to finish: one
//   block summing the partial rows is a chain of L2 round trips on one SM
//   (a few µs per level at BERT's shape), longer than the rows themselves;
//   chip_ln_bwd_phases.py stamps the phases.
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "ln_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;         // rows in flight per block, one warp each
constexpr int kMaxCached = 1024;  // longest row held in registers
constexpr int kSmemBudget = 96 * 1024;  // shared partials per block: two blocks per SM
constexpr int kSmemMax = 200 * 1024;    // one warp's partials, at most

// One row held in registers: CH chunks per lane of V elements each; chunk j
// of a lane holds columns (32 j + lane)·V .. + V - 1. V = 16 bytes of T (the
// row is whole 16-byte chunks), or 1.
template <typename T, typename W, int V, int CH>
__device__ __forceinline__ void row_cached(const T* __restrict__ x, const W* __restrict__ gamma,
                                           const T* __restrict__ dy, T* __restrict__ dx,
                                           float* part, float mu, float rs, int h, int lane) {
  // gw: gamma of these columns, loaded beside x and dy when the row comes in
  // 16-byte chunks (else read where it is used, to stay inside 128 registers)
  float xf[CH][V], df[CH][V], gw[CH][V];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c0 = (32 * j + lane) * V;
    if constexpr (V > 1) {
      uint4 xr = make_uint4(0, 0, 0, 0), dr = make_uint4(0, 0, 0, 0);
      if (c0 < h) {
        xr = __ldg(reinterpret_cast<const uint4*>(x + c0));
        dr = __ldg(reinterpret_cast<const uint4*>(dy + c0));
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xf[j][e] = lane_elem<T>(xr, e);
        df[j][e] = lane_elem<T>(dr, e);
        gw[j][e] = c0 < h ? gamma_at(gamma, c0 + e) : 0.f;
      }
    } else {
      xf[j][0] = c0 < h ? to_f(x[c0]) : 0.f;
      df[j][0] = c0 < h ? to_f(dy[c0]) : 0.f;
    }
  }
  float c1 = 0.f, c2 = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c0 = (32 * j + lane) * V;
    if (c0 < h) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (xf[j][e] - mu) * rs;
        const float wdy = df[j][e] * (V > 1 ? gw[j][e] : gamma_at(gamma, c0 + e));
        c1 += wdy;
        c2 = fmaf(wdy, xh, c2);
      }
    }
  }
  c1 = warp_sum(c1) / (float)h;
  c2 = warp_sum(c2) / (float)h;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c0 = (32 * j + lane) * V;
    if (c0 < h) {
      uint4 out = make_uint4(0, 0, 0, 0);
      float xh[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xh[e] = (xf[j][e] - mu) * rs;
        const float wdy = df[j][e] * (V > 1 ? gw[j][e] : gamma_at(gamma, c0 + e));
        const float d = (wdy - c1 - xh[e] * c2) * rs;
        if constexpr (V > 1)
          set_elem<T>(out, e, d);
        else
          dx[c0] = from_f<T>(d);
      }
      if constexpr (V > 1) {
        *reinterpret_cast<uint4*>(dx + c0) = out;
        // 16 bytes per lane and access: neighbouring lanes on neighbouring banks
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          float4* pg = reinterpret_cast<float4*>(part + c0 + e);
          float4* pb = reinterpret_cast<float4*>(part + h + c0 + e);
          float4 a = *pg, b = *pb;
          a.x = fmaf(df[j][e], xh[e], a.x);
          a.y = fmaf(df[j][e + 1], xh[e + 1], a.y);
          a.z = fmaf(df[j][e + 2], xh[e + 2], a.z);
          a.w = fmaf(df[j][e + 3], xh[e + 3], a.w);
          b.x += df[j][e];
          b.y += df[j][e + 1];
          b.z += df[j][e + 2];
          b.w += df[j][e + 3];
          *pg = a;
          *pb = b;
        }
      } else {
        part[c0] = fmaf(df[j][0], xh[0], part[c0]);
        part[h + c0] += df[j][0];
      }
    }
  }
}

// A row of any length, streamed: read once for the means, again for dx.
template <typename T, typename W>
__device__ __forceinline__ void row_streamed(const T* __restrict__ x, const W* __restrict__ gamma,
                                             const T* __restrict__ dy, T* __restrict__ dx,
                                             float* part, float mu, float rs, int h, int lane) {
  float c1 = 0.f, c2 = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float xh = (to_f(x[c]) - mu) * rs;
    const float wdy = to_f(dy[c]) * gamma_at(gamma, c);
    c1 += wdy;
    c2 = fmaf(wdy, xh, c2);
  }
  c1 = warp_sum(c1) / (float)h;
  c2 = warp_sum(c2) / (float)h;
  for (int c = lane; c < h; c += 32) {
    const float xh = (to_f(x[c]) - mu) * rs;
    const float d = to_f(dy[c]);
    dx[c] = from_f<T>((d * gamma_at(gamma, c) - c1 - xh * c2) * rs);
    part[c] = fmaf(d, xh, part[c]);
    part[h + c] += d;
  }
}

// The columns a lane owns in its warp's partials, as the row functions add to
// them, set to zero.
template <int V>
__device__ __forceinline__ void zero_owned(float* part, int h, int lane) {
  for (int c0 = lane * V; c0 < h; c0 += 32 * V)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      part[c0 + e] = 0.f;
      part[h + c0 + e] = 0.f;
    }
}

// This block's share of the sum over the grid's partial rows (nb, 2h): a
// slice of the 2h columns, each summed over all nb rows by K threads (rows
// k, k + K, ...: their loads independent, in flight together), the K sums
// then added in k order. dγ is the first h columns, dβ the second, in W.
template <typename W>
__device__ __forceinline__ void sum_columns(const float* part, int h, W* dg, W* db) {
  __shared__ float red[32 * kWarps];
  const int nb = gridDim.x, cols = 2 * h;
  const int per = (cols + nb - 1) / nb;
  const int c_begin = blockIdx.x * per, c_end = min(cols, c_begin + per);
  for (int cb = c_begin; cb < c_end; cb += blockDim.x) {
    const int nc = min((int)blockDim.x, c_end - cb);
    const int k_threads = blockDim.x / nc;
    const int j = threadIdx.x % nc, k = threadIdx.x / nc;
    float s = 0.f;
    if (k < k_threads) {
      const float* src = part + cb + j;
      for (int r0 = k; r0 < nb; r0 += 8 * k_threads) {  // eight loads in flight
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + i * k_threads;
          v[i] = r < nb ? __ldcg(src + (size_t)r * cols) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s += v[i];
      }
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < nc) {
      float t = 0.f;
      for (int kk = 0; kk < k_threads; ++kk) t += red[kk * nc + threadIdx.x];
      const int c = cb + threadIdx.x;
      if (c < h)
        dg[c] = from_f<W>(t);
      else
        db[c - h] = from_f<W>(t);
    }
    __syncthreads();
  }
}

// PATH 0: rows in registers with 16-byte loads; 1: in registers, one element
// per load; 2: streamed. smem_parts: the warps' partials in shared memory
// (else one warp, adding into the block's partial row in scratch).
template <typename T, typename W, int PATH>
__global__ void __launch_bounds__(32 * kWarps, 2)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
              W* __restrict__ dg, W* __restrict__ db, int n, int h, int rows_per_block,
              int smem_parts) {
  constexpr int kV = PATH == 0 ? 16 / (int)sizeof(T) : 1;
  extern __shared__ __align__(16) float sparts[];  // per warp: Σdy·x̂ over h columns, then Σdy
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* block_part = part + (size_t)blockIdx.x * 2 * h;
  float* mine = smem_parts ? sparts + (size_t)warp * 2 * h : block_part;
  zero_owned<kV>(mine, h, lane);
  const int r0 = blockIdx.x * rows_per_block, r1 = min(n, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += nw) {  // whole warp: shuffles stay full-mask
    const size_t off = (size_t)row * h;
    const float mu = mean[row], rs = rstd[row];
    if constexpr (PATH < 2)
      row_cached<T, W, kV, kMaxCached / (32 * kV)>(x + off, gamma, dy + off, dx + off, mine, mu,
                                                   rs, h, lane);
    else
      row_streamed<T, W>(x + off, gamma, dy + off, dx + off, mine, mu, rs, h, lane);
  }
  __syncthreads();
  if (smem_parts)
    for (int c = threadIdx.x; c < 2 * h; c += blockDim.x) {
      float w_part[kWarps];  // independent loads, added in warp order
#pragma unroll
      for (int w = 0; w < kWarps; ++w) w_part[w] = w < nw ? sparts[(size_t)w * 2 * h + c] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += w_part[w];
      block_part[c] = s;
    }
  // every block's partial row is written and visible (a cooperative launch:
  // all blocks are resident at once), then each sums its slice of columns
  cg::this_grid().sync();
  sum_columns<W>(part, h, dg, db);
}

// The launch's shape for n rows of h elements on a card of `sms` SMs; the
// launch may cut `blocks` further to what can be resident at once.
struct Plan {
  int path, warps, smem, blocks, rows_per_block;
};

Plan plan(int n, int h, int vec, int sms) {
  Plan p;
  p.path = h > kMaxCached ? 2 : (vec ? 0 : 1);
  const int row_bytes = 2 * h * (int)sizeof(float);
  p.warps = kWarps;
  while (p.warps > 1 && p.warps * row_bytes > kSmemBudget) --p.warps;
  // a row whose partials do not fit a block's shared memory: one warp, in scratch
  p.smem = row_bytes <= kSmemMax ? p.warps * row_bytes : 0;
  const int want = (n + p.warps - 1) / p.warps;
  p.blocks = want < 2 * sms ? want : 2 * sms;
  p.rows_per_block = (n + p.blocks - 1) / p.blocks;
  return p;
}

template <typename T, typename W, int PATH>
cudaError_t launch_path(Plan p, int sms, const void* x, const void* gamma, const void* mean,
                        const void* rstd, const void* dy, void* dx, void* scratch, void* dg,
                        void* db, int n, int h, cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<T, W, PATH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * p.warps, p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (p.blocks > per_sm * sms) {  // the grid barrier needs every block resident
    p.blocks = per_sm * sms;
    p.rows_per_block = (n + p.blocks - 1) / p.blocks;
  }
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(gamma);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* part = static_cast<float*>(scratch);
  W* dgp = static_cast<W*>(dg);
  W* dbp = static_cast<W*>(db);
  int smem_parts = p.smem > 0;
  void* args[] = {&xp, &gp, &mp, &rp, &dyp, &dxp, &part, &dgp, &dbp,
                  &n,  &h,  &p.rows_per_block, &smem_parts};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.blocks), dim3(32 * p.warps),
                                     args, p.smem, stream);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* mean, const void* rstd,
                   const void* dy, void* dx, void* scratch, void* dg, void* db, int n, int h,
                   cudaStream_t stream) {
  const int vec =
      rows_in_16_bytes(h, (int)sizeof(T), (uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx);
  const int sms = card_sms();
  const Plan p = plan(n, h, vec, sms);
  if (p.path == 0)
    return launch_path<T, W, 0>(p, sms, x, gamma, mean, rstd, dy, dx, scratch, dg, db, n, h,
                                stream);
  if (p.path == 1)
    return launch_path<T, W, 1>(p, sms, x, gamma, mean, rstd, dy, dx, scratch, dg, db, n, h,
                                stream);
  return launch_path<T, W, 2>(p, sms, x, gamma, mean, rstd, dy, dx, scratch, dg, db, n, h,
                              stream);
}

}  // namespace

// f32 scratch elements a launch on the current device needs for n rows of h:
// the blocks' partial rows. Returns a cudaError_t.
extern "C" int layer_norm_bwd_workspace(int n, int h, long long* scratch_floats) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, h, 1, card_sms());
  *scratch_floats = (long long)p.blocks * 2 * h;
  return (int)cudaSuccess;
}

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. x, dy, dx (n, h); gamma (h,) or
// null (then w_dtype 0); mean, rstd (n,) f32; scratch as layer_norm_bwd_workspace
// gives it; dg, db (h,) in w_dtype. Returns a cudaError_t.
extern "C" int layer_norm_bwd(const void* x, const void* gamma, const void* mean,
                              const void* rstd, const void* dy, void* dx, void* scratch,
                              void* dg, void* db, int n, int h, int x_dtype, int w_dtype,
                              void* stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_ARGS x, gamma, mean, rstd, dy, dx, scratch, dg, db, n, h, s
  if (x_dtype == 0 && w_dtype == 0) return (int)launch<float, float>(LN_ARGS);
  if (x_dtype == 0 && w_dtype == 1) return (int)launch<float, __nv_bfloat16>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 0) return (int)launch<__nv_bfloat16, float>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(LN_ARGS);
#undef LN_ARGS
  return (int)cudaErrorInvalidValue;
}
