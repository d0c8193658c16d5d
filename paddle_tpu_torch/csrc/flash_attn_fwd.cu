// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_attention.py
// _fwd_kernel / _fwd_kernel_nokpm (pallas_call in _fwd_call). It computes
// the same function: FlashAttention-2 online softmax over key tiles with
// f32 running max, sum and accumulator; an optional additive key-padding
// mask (B, Tk) shared by the H heads; causal masking (row >= col, absolute
// indices); counter-hash dropout whose bits equal the reference's; rows whose
// every key is masked give O = 0 and lse = -1e30.
//
// What bounds it on the H100: at BERT's shapes (T = 128, D = 64) the work is
// ~4·T²·D flops per (batch, head), small against the tensor-core peak, and the
// bytes (q, k, v, o read or written once) are a few MB. This first version
// does its products on the CUDA cores in f32, so it is bound by f32 FMA
// issue, not by memory. What the design does about it: one block of 256
// threads per (64-row q tile, batch·head), K/V tiles of 64 rows staged in
// shared memory as f32 (dynamic shared memory, up to ~113 KB at D = 128), four
// threads per q row, so the (T, T) score matrix never reaches device memory.
// Tensor cores (wgmma) and TMA are left for a later change.
//
// Dropout: the keep bit of score (row, col) is the reference's murmur3 hash
// in the REFERENCE's tile coordinates (row / ref_bq, col / ref_bk, row %
// ref_bq, col % ref_bk), whatever tile this kernel uses; the wrapper passes
// the (ref_bq, ref_bk) that paddle_tpu's flash_attention would pick. The hash
// lives in flash_common.cuh, shared with the backward kernels.
#include "flash_common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;  // 256
constexpr int kMaxD = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kpm, T* __restrict__ o, float* __restrict__ lse,
                 int heads, int tq, int tk, int d, float sm_scale, int causal,
                 int use_dropout, uint32_t threshold, float inv_keep, int seed,
                 int ref_bq, int ref_bk) {
  extern __shared__ float smem[];
  const int ld = d + 1;  // +1 float per row keeps the 8 rows of a warp on distinct banks
  float* qs = smem;
  float* ks = qs + kBlockQ * ld;
  float* vs = ks + kBlockK * ld;
  float* ps = vs + kBlockK * ld;  // kBlockQ x (kBlockK + 1)
  const int pld = kBlockK + 1;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int lane = tid % kThreadsPerRow;
  const int grow = q0 + row;

  const T* qb = q + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const float* kpm_row = kpm ? kpm + (size_t)(bh / heads) * tk : nullptr;
  const uint32_t seed_bh = fold_bh_seed(seed, bh);

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    qs[r * ld + c] = (q0 + r < tq) ? to_f(qb[(size_t)(q0 + r) * d + c]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kMaxD / kThreadsPerRow];
#pragma unroll
  for (int j = 0; j < kMaxD / kThreadsPerRow; ++j) acc[j] = 0.f;

  // causal: key tiles past the tile's last row are masked for every row
  const int k_end = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous K/V/P tile
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const bool in = k0 + r < tk;
      ks[r * ld + c] = in ? to_f(kb[(size_t)(k0 + r) * d + c]) : 0.f;
      vs[r * ld + c] = in ? to_f(vb[(size_t)(k0 + r) * d + c]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK / kThreadsPerRow];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK / kThreadsPerRow; ++j) {
      const int c = lane + kThreadsPerRow * j;
      const int gc = k0 + c;
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot = fmaf(qs[row * ld + e], ks[c * ld + e], dot);
      float sv = dot * sm_scale;
      if (gc >= tk) {
        sv = __int_as_float(0xff800000);  // -inf: past the keys, contributes exactly 0
      } else {
        if (kpm_row) sv += kpm_row[gc];
        if (causal && grow < gc) sv = kNegInf;
      }
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    const float m_new = fmaxf(m, row_max(mx));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / kThreadsPerRow; ++j) {
      const int c = lane + kThreadsPerRow * j;
      const int gc = k0 + c;
      const float p = expf(s[j] - m_new);
      psum += p;
      float pu = p;
      if (use_dropout) {
        pu = dropout_keep(seed_bh, grow, gc, ref_bq, ref_bk, threshold) ? p * inv_keep : 0.f;
      }
      ps[row * pld + c] = pu;
    }
    l = l * alpha + row_sum(psum);
    __syncwarp();  // the four threads of a row (one warp) see each other's P
#pragma unroll
    for (int j = 0; j < kMaxD / kThreadsPerRow; ++j) {
      const int dc = lane + kThreadsPerRow * j;
      if (dc < d) {
        float pv = 0.f;
        for (int c = 0; c < kBlockK; ++c) pv = fmaf(ps[row * pld + c], vs[c * ld + dc], pv);
        acc[j] = acc[j] * alpha + pv;
      }
    }
    m = m_new;
  }

  if (grow < tq) {
    const bool dead = m <= kNegInf * 0.5f;
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = o + ((size_t)bh * tq + grow) * d;
#pragma unroll
    for (int j = 0; j < kMaxD / kThreadsPerRow; ++j) {
      const int dc = lane + kThreadsPerRow * j;
      if (dc < d) orow[dc] = from_f<T>(dead ? 0.f : acc[j] / l_safe);
    }
    if (lane == 0) lse[(size_t)bh * tq + grow] = dead ? kNegInf : m + logf(l_safe);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpm, void* o,
                   void* lse, int bh, int heads, int tq, int tk, int d, float sm_scale,
                   int causal, int use_dropout, unsigned threshold, float inv_keep, int seed,
                   int ref_bq, int ref_bk, cudaStream_t stream) {
  const int smem = (kBlockQ * (d + 1) + 2 * kBlockK * (d + 1) + kBlockQ * (kBlockK + 1)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kpm), static_cast<T*>(o), static_cast<float*>(lse), heads, tq,
      tk, d, sm_scale, causal, use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (bh, tq, d); k, v (bh, tk, d); kpm (bh / heads, tk)
// f32 or null; o like q; lse (bh, tq) f32. Returns a cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* kpm,
                              void* o, void* lse, int bh, int heads, int tq, int tk, int d,
                              float sm_scale, int causal, int use_dropout, unsigned threshold,
                              float inv_keep, int seed, int ref_bq, int ref_bk, int dtype,
                              void* stream) {
  if (d < 1 || d > kMaxD || bh < 1 || heads < 1 || tq < 1 || tk < 1 || ref_bq < 1 ||
      ref_bk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, kpm, o, lse, bh, heads, tq, tk, d, sm_scale, causal,
                              use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, kpm, o, lse, bh, heads, tq, tk, d, sm_scale,
                                      causal, use_dropout, threshold, inv_keep, seed, ref_bq,
                                      ref_bk, s);
  return (int)cudaErrorInvalidValue;
}
