// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas_attention.py
// _bwd_call: _dq_kernel (pallas_call for dQ) and _dkdv_kernel (pallas_call
// for dK, dV and the per-(batch·head) key-padding-mask gradient). The same
// FlashAttention-2 split: each kernel re-forms the probabilities P =
// exp(S - lse) tile by tile from the forward's saved lse (rows whose lse is
// the -1e30 floor are dead: P = 0), so the (T, T) matrices never reach device
// memory, and neither kernel needs atomics.
//
//   flash_bwd_dq_kernel:   one block per (64-row q tile, batch·head); loops over
//                          key tiles: dP = dO·Vᵀ (dropped scores zeroed, kept
//                          ones scaled by 1/(1-p)), dS = P∘(dP - delta),
//                          dQ += dS·K·scale. Causal: key tiles past the q
//                          tile's last row are skipped.
//   flash_bwd_dkdv_kernel: one block per (64-row key tile, batch·head); loops
//                          over q tiles: dV += (P∘keep/(1-p))ᵀ·dO,
//                          dK += dSᵀ·Q·scale, dkpm[key] = Σ_q dS. Causal: q
//                          tiles above the key tile's first key are skipped.
//
// delta = rowsum(dO∘O) in f32 is computed by the wrapper, as _flash_bwd does.
// The dropout keep bits are the forward kernel's (flash_common.cuh), in the
// reference's tile coordinates. Keys past T add nothing and their dK, dV and
// dkpm rows are never written; masked keys carry -1e30 as in the forward.
// bf16 rounds where the reference rounds: dS to the input dtype before the dQ
// and dK products, P∘keep/(1-p) before the dV product; sums are f32.
//
// What bounds it on the H100: at BERT's shapes (T = 128, D = 64) dQ does three
// and dK/dV four T×T×D products per (batch, head), ~3-4 MFLOP against a few
// hundred KB of inputs, so the tensor cores would be bound by bytes; this first
// version does its products in f32 on the CUDA cores, two shared-memory loads
// per FMA, so it is bound by shared-memory bandwidth and FMA issue. What the
// design does about it: tiles of 64 rows staged in dynamic shared memory as f32
// (up to ~160 KB at D = 128), padded rows (+1 float) against bank conflicts,
// four threads per row so the row's reductions are two shuffles. Tensor cores
// (wgmma) and TMA are left for a later change.
#include "flash_common.cuh"

namespace {

constexpr int kBlock = 64;             // rows of a q tile and of a key tile
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlock * kThreadsPerRow;  // 256
constexpr int kMaxD = 128;
constexpr int kCols = kBlock / kThreadsPerRow;     // tile columns per thread
constexpr int kDims = kMaxD / kThreadsPerRow;      // head dims per thread

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int r0, int rows,
                                          int d) {
  for (int i = threadIdx.x; i < kBlock * d; i += kThreads) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] = (r0 + r < rows) ? to_f(src[(size_t)(r0 + r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int e = 0; e < d; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ kpm, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int heads, int tq, int tk, int d, float sm_scale,
                    int causal, int use_dropout, uint32_t threshold, float inv_keep, int seed,
                    int ref_bq, int ref_bk) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int pld = kBlock + 1;
  float* qs = smem;                 // q tile
  float* dos = qs + kBlock * ld;    // dO tile
  float* ks = dos + kBlock * ld;    // key tile
  float* vs = ks + kBlock * ld;     // value tile
  float* dss = vs + kBlock * ld;    // dS, kBlock x pld

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int row = threadIdx.x / kThreadsPerRow;
  const int lane = threadIdx.x % kThreadsPerRow;
  const int grow = q0 + row;
  const size_t qoff = (size_t)bh * tq * d;
  const size_t koff = (size_t)bh * tk * d;
  const float* kpm_row = kpm ? kpm + (size_t)(bh / heads) * tk : nullptr;
  const uint32_t seed_bh = fold_bh_seed(seed, bh);

  load_tile(qs, ld, q + qoff, q0, tq, d);
  load_tile(dos, ld, dout + qoff, q0, tq, d);
  const bool live = grow < tq;
  const float lse_r = live ? lse[(size_t)bh * tq + grow] : kNegInf;
  const float delta_r = live ? delta[(size_t)bh * tq + grow] : 0.f;
  const bool dead = lse_r <= kNegInf * 0.5f;  // also rows past T

  float acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(tk, q0 + kBlock) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // every thread is done with the previous K/V/dS tile
    load_tile(ks, ld, k + koff, k0, tk, d);
    load_tile(vs, ld, v + koff, k0, tk, d);
    __syncthreads();
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + kThreadsPerRow * j;
      const int gc = k0 + c;
      float ds = 0.f;
      if (!dead && gc < tk) {
        float sv = dot(qs + row * ld, ks + c * ld, d) * sm_scale;
        if (kpm_row) sv += kpm_row[gc];
        if (causal && grow < gc) sv = kNegInf;
        const float p = expf(sv - lse_r);
        float dp = dot(dos + row * ld, vs + c * ld, d);
        if (use_dropout)
          dp = dropout_keep(seed_bh, grow, gc, ref_bq, ref_bk, threshold) ? dp * inv_keep : 0.f;
        ds = round_to<T>(p * (dp - delta_r));
      }
      dss[row * pld + c] = ds;
    }
    __syncwarp();  // the four threads of a row (one warp) see each other's dS
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int dc = lane + kThreadsPerRow * j;
      if (dc < d) {
        float s = 0.f;
        for (int c = 0; c < kBlock; ++c) s = fmaf(dss[row * pld + c], ks[c * ld + dc], s);
        acc[j] += s;
      }
    }
  }

  if (live) {
    T* out = dq + qoff + (size_t)grow * d;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int dc = lane + kThreadsPerRow * j;
      if (dc < d) out[dc] = from_f<T>(acc[j] * sm_scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ kpm,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dkpm, int heads, int tq, int tk, int d,
                      float sm_scale, int causal, int use_dropout, uint32_t threshold,
                      float inv_keep, int seed, int ref_bq, int ref_bk) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int pld = kBlock + 1;
  float* ks = smem;                 // this block's key tile
  float* vs = ks + kBlock * ld;     // its value tile
  float* qs = vs + kBlock * ld;     // q tile
  float* dos = qs + kBlock * ld;    // dO tile
  float* pds = dos + kBlock * ld;   // P∘keep/(1-p), key-major: kBlock x pld
  float* dss = pds + kBlock * pld;  // dS, key-major: kBlock x pld
  float* lses = dss + kBlock * pld; // kBlock
  float* deltas = lses + kBlock;    // kBlock

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const int key = threadIdx.x / kThreadsPerRow;
  const int lane = threadIdx.x % kThreadsPerRow;
  const int gkey = k0 + key;
  const size_t qoff = (size_t)bh * tq * d;
  const size_t koff = (size_t)bh * tk * d;
  const bool live = gkey < tk;
  const float kpm_c = (kpm && live) ? kpm[(size_t)(bh / heads) * tk + gkey] : 0.f;
  const uint32_t seed_bh = fold_bh_seed(seed, bh);

  load_tile(ks, ld, k + koff, k0, tk, d);
  load_tile(vs, ld, v + koff, k0, tk, d);

  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  float dkpm_acc = 0.f;

  // causal: a q tile whose last row lies above this tile's first key sees none of it
  const int q_begin = causal ? (k0 / kBlock) * kBlock : 0;
  for (int q0 = q_begin; q0 < tq; q0 += kBlock) {
    __syncthreads();  // every thread is done with the previous q/dO/P/dS tile
    load_tile(qs, ld, q + qoff, q0, tq, d);
    load_tile(dos, ld, dout + qoff, q0, tq, d);
    for (int r = threadIdx.x; r < kBlock; r += kThreads) {
      const bool in = q0 + r < tq;  // rows past T are dead
      lses[r] = in ? lse[(size_t)bh * tq + q0 + r] : kNegInf;
      deltas[r] = in ? delta[(size_t)bh * tq + q0 + r] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kCols; ++j) {
      const int r = lane + kThreadsPerRow * j;
      const int grow = q0 + r;
      const float lse_r = lses[r];
      float pd = 0.f, ds = 0.f;
      if (live && lse_r > kNegInf * 0.5f) {
        float sv = dot(qs + r * ld, ks + key * ld, d) * sm_scale + kpm_c;
        if (causal && grow < gkey) sv = kNegInf;
        const float p = expf(sv - lse_r);
        float dp = dot(dos + r * ld, vs + key * ld, d);
        pd = p;
        if (use_dropout) {
          const bool keep = dropout_keep(seed_bh, grow, gkey, ref_bq, ref_bk, threshold);
          pd = keep ? p * inv_keep : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        const float dsf = p * (dp - deltas[r]);
        dkpm_acc += dsf;  // the reference sums dS before any rounding
        ds = round_to<T>(dsf);
        pd = round_to<T>(pd);
      }
      pds[key * pld + r] = pd;
      dss[key * pld + r] = ds;
    }
    __syncwarp();  // the four threads of a key (one warp) see each other's P and dS
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int dc = lane + kThreadsPerRow * j;
      if (dc < d) {
        float a = 0.f, b = 0.f;
        for (int r = 0; r < kBlock; ++r) {
          a = fmaf(pds[key * pld + r], dos[r * ld + dc], a);
          b = fmaf(dss[key * pld + r], qs[r * ld + dc], b);
        }
        dv_acc[j] += a;
        dk_acc[j] += b;
      }
    }
  }

  dkpm_acc = row_sum(dkpm_acc);  // all lanes: the shuffle needs the full warp
  if (live) {
    T* dkr = dk + koff + (size_t)gkey * d;
    T* dvr = dv + koff + (size_t)gkey * d;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int dc = lane + kThreadsPerRow * j;
      if (dc < d) {
        dkr[dc] = from_f<T>(dk_acc[j] * sm_scale);
        dvr[dc] = from_f<T>(dv_acc[j]);
      }
    }
    if (dkpm && lane == 0) dkpm[(size_t)bh * tk + gkey] = dkpm_acc;
  }
}

struct Args {
  const void *q, *k, *v, *kpm, *dout, *lse, *delta;
  int bh, heads, tq, tk, d;
  float sm_scale;
  int causal, use_dropout;
  unsigned threshold;
  float inv_keep;
  int seed, ref_bq, ref_bk;
};

template <typename T>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  const int smem =
      (4 * kBlock * (a.d + 1) + kBlock * (kBlock + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.tq + kBlock - 1) / kBlock, a.bh);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.kpm), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.heads, a.tq, a.tk, a.d, a.sm_scale, a.causal, a.use_dropout,
      a.threshold, a.inv_keep, a.seed, a.ref_bq, a.ref_bk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, void* dkpm, cudaStream_t stream) {
  const int smem = (4 * kBlock * (a.d + 1) + 2 * kBlock * (kBlock + 1) + 2 * kBlock) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.tk + kBlock - 1) / kBlock, a.bh);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.kpm), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dkpm), a.heads, a.tq,
      a.tk, a.d, a.sm_scale, a.causal, a.use_dropout, a.threshold, a.inv_keep, a.seed,
      a.ref_bq, a.ref_bk);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.d >= 1 && a.d <= kMaxD && a.bh >= 1 && a.heads >= 1 && a.tq >= 1 && a.tk >= 1 &&
         a.ref_bq >= 1 && a.ref_bk >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout (bh, tq, d); k, v (bh, tk, d); kpm
// (bh / heads, tk) f32 or null; lse, delta (bh, tq) f32; dq like q. Returns a
// cudaError_t.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* kpm,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 int bh, int heads, int tq, int tk, int d, float sm_scale,
                                 int causal, int use_dropout, unsigned threshold,
                                 float inv_keep, int seed, int ref_bq, int ref_bk, int dtype,
                                 void* stream) {
  const Args a{q, k, v, kpm, dout, lse, delta, bh, heads, tq, tk, d, sm_scale, causal,
               use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dq<float>(a, dq, s);
  if (dtype == 1) return (int)launch_dq<__nv_bfloat16>(a, dq, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_attn_bwd_dq; dk, dv like k, v; dkpm (bh, tk) f32 per-(batch·head)
// partials, or null when there is no kpm.
extern "C" int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* kpm, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, void* dkpm, int bh,
                                   int heads, int tq, int tk, int d, float sm_scale, int causal,
                                   int use_dropout, unsigned threshold, float inv_keep, int seed,
                                   int ref_bq, int ref_bk, int dtype, void* stream) {
  const Args a{q, k, v, kpm, dout, lse, delta, bh, heads, tq, tk, d, sm_scale, causal,
               use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dkdv<float>(a, dk, dv, dkpm, s);
  if (dtype == 1) return (int)launch_dkdv<__nv_bfloat16>(a, dk, dv, dkpm, s);
  return (int)cudaErrorInvalidValue;
}
