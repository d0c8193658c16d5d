// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_attention.py
// _fwd_kernel (:93; _fwd_kernel_nokpm without a mask), called by pallas_call
// in _fwd_call (:316). It computes the same function: FlashAttention-2 online
// softmax over key tiles with f32 running max, sum and accumulator; an
// optional additive key-padding mask (B, Tk) shared by the H heads; causal
// masking (row >= col, absolute indices; key tiles past the q tile's last row
// are skipped); counter-hash dropout whose keep bits equal the reference's,
// taken in the REFERENCE's tile coordinates (flash_common.cuh; the wrapper
// passes the (ref_bq, ref_bk) that paddle_tpu's flash_attention would pick);
// rows whose every key is masked give O = 0 and lse = -1e30; keys past T add
// exactly 0. bf16 rounds where the reference rounds: P∘keep/(1-p) to the
// input dtype before P·V (packing the A fragment does it, to nearest even),
// while the row sum l is the f32 sum of the unrounded P.
//
// What bounds it on the H100: at BERT's shapes (T = 128, D = 64, B·H = 96)
// it does two T×T×D products, 403 MFLOP, against 6.3 MB of q, k, v and o in
// bf16 (12.6 MB in f32) and the f32 lse: 1.9 µs (bf16) and 3.8 µs (f32) at
// 3.35 TB/s, against 0.4 µs of bf16 tensor-core work and 2.4 µs of 3xTF32
// work at 495/3 TFLOP/s. Both dtypes are bound by bytes on paper; as in the
// backward kernels, a block streams only two key tiles, so its latency (the
// products' mma.sync rate in f32, the per-score work in bf16) sets the time.
//
// What the design does about it (the backward kernels' parts, from
// flash_mma.cuh):
// - One block of 128 threads (four warps × 16 q rows) per (64-row q tile,
//   batch·head): 2 × 96 = 192 blocks at BERT's shape, one wave at two blocks
//   per SM. The scores of a warp's 16 rows stay in its accumulator registers.
// - Q is loaded once by cp.async into shared memory, where mma_abt reads its
//   A fragments; K and V tiles (64 rows at D <= 64, 32 at D = 128) are
//   double-buffered by 16-byte cp.async zero-filled past T and past D, so the
//   next tile's copy overlaps this tile's products; the mask row comes with
//   each key tile. Rows that are not whole 16-byte chunks load element by
//   element.
// - S = Q·Kᵀ and O += P·V run on the tensor cores with mma.sync: m16n8k16 bf16
//   with f32 sums, or in f32 three m16n8k8 TF32 passes (3xTF32), which keeps
//   about f32's accuracy. P feeds P·V from the accumulator registers as the A
//   operand, in f32 through the permuted k order of mma_pb.
// - The online softmax runs in the accumulator registers: row max and row
//   sum by quad shuffles, the MUFU exponential, selects (no branches) for the
//   mask, causal test, keys past T and dropout. O is rescaled by α per tile,
//   divided by l once at the end and written with paired stores; lse is
//   written once per row.
#include "flash_mma.cuh"

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kpm, T* __restrict__ o, float* __restrict__ lse,
                 int heads, int tq, int tk, int d, float sm_scale, int causal,
                 int use_dropout, uint32_t threshold, float inv_keep, int seed, int ref_bq,
                 int ref_bk, int vec) {
  constexpr int kBc = inner_rows(DP);
  constexpr int kLd = row_ld<T, DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // q tile, kRows rows
  T* ks = qs + kRows * kLd;           // two key tiles of kBc rows
  T* vs = ks + 2 * kBc * kLd;         // two value tiles
  float* kpms = reinterpret_cast<float*>(vs + 2 * kBc * kLd);  // two of kBc

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * tq * d;
  const size_t koff = (size_t)bh * tk * d;
  const float* kpm_row = kpm ? kpm + (size_t)(bh / heads) * tk : nullptr;
  const uint32_t seed_bh = fold_bh_seed(seed, bh);

  auto load_k_tile = [&](int k0, int buf) {
    load_tile<T, kBc, DP>(ks + buf * kBc * kLd, k + koff, k0, tk, d, vec);
    load_tile<T, kBc, DP>(vs + buf * kBc * kLd, v + koff, k0, tk, d, vec);
    if (kpm_row)
      for (int c = threadIdx.x; c < kBc; c += kThreads) {
        const bool in = k0 + c < tk;  // keys past T add nothing: checked by index below
        cp_async4(kpms + buf * kBc + c, in ? kpm_row + k0 + c : kpm_row, in);
      }
  };

  // causal: key tiles past the q tile's last row are masked for every row
  const int k_end = causal ? min(tk, q0 + kRows) : tk;
  const int n_tiles = (k_end + kBc - 1) / kBc;
  load_tile<T, kRows, DP>(qs, q + qoff, q0, tq, d, vec);
  load_k_tile(0, 0);
  cp_commit();

  // this thread's rows: g and g + 8 of the warp's 16; running max and sum
  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * warp + g + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  float acc[DP / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBc;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      load_k_tile(k0 + kBc, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + buf * kBc * kLd;
    const T* vt = vs + buf * kBc * kLd;
    const float* kpm_t = kpms + buf * kBc;
    float s[kBc / 8][4] = {};
    mma_abt<kBc / 8, DP>(s, qs + 16 * warp * kLd, kt, lane);
    const uint32_t keep = use_dropout ? keep_bits<kBc / 8>(seed_bh, row[0], row[1], k0, t, false,
                                                           ref_bq, ref_bk, threshold)
                                      : ~0u;  // with inv_keep = 1: every score kept as it is
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // selects, no branches: 4·kBc/8 copies of this body
        const int i = e >> 1;
        const int c = 8 * n + 2 * t + (e & 1);
        const int col = k0 + c;
        float sv = fmaf(s[n][e], sm_scale, kpm_row ? kpm_t[c] : 0.f);
        sv = (causal && row[i] < col) ? kNegInf : sv;
        sv = col < tk ? sv : __int_as_float(0xff800000);  // keys past T: -inf, P = 0
        s[n][e] = sv;
        mx[i] = fmaxf(mx[i], sv);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = row_max(mx[i]);  // >= m[i] >= -1e30: finite
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = __expf(s[n][e] - m[i]);
        psum[i] += p;
        const float kept = (keep >> (4 * n + e)) & 1u ? inv_keep : 0.f;
        s[n][e] = p * kept;  // bf16: rounded by the A pack, as the reference rounds
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_sum(psum[i]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma_pb<kBc / 8, DP>(acc, s, vt, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= tq) continue;
    // fully-masked rows (m never rose above the mask floor) give 0
    const bool dead = m[i] <= kNegInf * 0.5f;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = dead ? 0.f : 1.f / l_safe;
    T* out = o + qoff + (size_t)row[i] * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      store_pair<T>(out, 8 * n + 2 * t, d, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (t == 0) lse[(size_t)bh * tq + row[i]] = dead ? kNegInf : m[i] + logf(l_safe);
  }
}

// The q tile, two double-buffered K and V tiles, and two mask rows.
template <typename T, int DP>
constexpr int fwd_smem_bytes() {
  return (kRows + 4 * inner_rows(DP)) * row_ld<T, DP>() * (int)sizeof(T) +
         2 * inner_rows(DP) * (int)sizeof(float);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpm, void* o,
                   void* lse, int bh, int heads, int tq, int tk, int d, float sm_scale,
                   int causal, int use_dropout, unsigned threshold, float inv_keep, int seed,
                   int ref_bq, int ref_bk, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // whole 16-byte chunks per row, and every operand 16-byte aligned
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = (d * (int)sizeof(T)) % 16 == 0 && (any & 15) == 0;
  dim3 grid((tq + kRows - 1) / kRows, bh);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kpm), static_cast<T*>(o), static_cast<float*>(lse), heads, tq,
      tk, d, sm_scale, causal, use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk, vec);
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
#define FWD_ARGS                                                                             \
  q, k, v, kpm, o, lse, bh, heads, tq, tk, d, sm_scale, causal, use_dropout, threshold,      \
      inv_keep, seed, ref_bq, ref_bk, s
  if (dtype == 0)
    return (int)(d <= 64 ? launch<float, 64>(FWD_ARGS) : launch<float, 128>(FWD_ARGS));
  if (dtype == 1)
    return (int)(d <= 64 ? launch<__nv_bfloat16, 64>(FWD_ARGS)
                         : launch<__nv_bfloat16, 128>(FWD_ARGS));
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// Blocks of the forward kernel that fit on one SM at head dim d and dtype (as
// above), and the dynamic shared memory each takes. Returns a cudaError_t.
extern "C" int flash_attn_fwd_occupancy(int d, int dtype, int* blocks_per_sm, int* smem_bytes) {
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const void* fn;
  if (dtype == 0) {
    fn = d <= 64 ? (const void*)flash_fwd_kernel<float, 64> : (const void*)flash_fwd_kernel<float, 128>;
    *smem_bytes = d <= 64 ? fwd_smem_bytes<float, 64>() : fwd_smem_bytes<float, 128>();
  } else if (dtype == 1) {
    fn = d <= 64 ? (const void*)flash_fwd_kernel<__nv_bfloat16, 64>
                 : (const void*)flash_fwd_kernel<__nv_bfloat16, 128>;
    *smem_bytes =
        d <= 64 ? fwd_smem_bytes<__nv_bfloat16, 64>() : fwd_smem_bytes<__nv_bfloat16, 128>();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads,
                                                            *smem_bytes);
}
