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
//                          key tiles: S = Q·Kᵀ, dP = dO·Vᵀ (dropped scores
//                          zeroed, kept ones scaled by 1/(1-p)), dS =
//                          P∘(dP - delta), dQ += dS·K·scale. Causal: key tiles
//                          past the q tile's last row are skipped.
//   flash_bwd_dkdv_kernel: one block per (64-row key tile, batch·head); loops
//                          over q tiles: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV +=
//                          (P∘keep/(1-p))ᵀ·dO, dK += dSᵀ·Q·scale, dkpm[key] =
//                          Σ_q dS. Causal: q tiles above the key tile's first
//                          key are skipped.
//
// delta = rowsum(dO∘O) in f32 is computed by the wrapper, as _flash_bwd does.
// The dropout keep bits are the forward kernel's (flash_common.cuh), in the
// reference's tile coordinates. Keys past T add nothing and their dK, dV and
// dkpm rows are never written; masked keys carry -1e30 as in the forward.
// bf16 rounds where the reference rounds: dS to the input dtype before the dQ
// and dK products, P∘keep/(1-p) before the dV product; sums are f32.
//
// What bounds it on the H100: at BERT's shapes (T = 128, D = 64, B·H = 96) dQ
// does three and dK/dV four T×T×D products, 604 and 805 MFLOP, against 7.96
// and 9.54 MB of bytes in bf16 (q, k, v, dO, lse, delta read once, the
// gradients written once): 2.4 and 2.8 µs at 3.35 TB/s against 0.6 and 0.8 µs
// of bf16 tensor-core work. In f32 the bytes double (15.8 and 19.0 MB, 4.7 and
// 5.7 µs) and the products run as 3xTF32, three TF32 passes at 495 TFLOP/s:
// 3.7 and 4.9 µs. Both dtypes are bound by bytes on paper. In practice a block
// streams only two inner tiles, so its latency sets the time: in f32 the TF32
// rate of mma.sync (measured at about a quarter of the 495 TFLOP/s that
// wgmma reaches), in bf16 the per-score work between the products.
//
// What the design does about it:
// - Every product runs on the tensor cores with mma.sync: m16n8k16 bf16 with
//   f32 sums, and in f32 m16n8k8 TF32 three times per product (x = big +
//   small, each cvt.rna.tf32; small·big + big·small + big·big), which keeps
//   about f32's accuracy where one TF32 pass keeps three digits. Each pass
//   runs over four n-tiles before the next, so no mma waits on the one before.
//   mma.sync and not wgmma: a warp owns 16 rows, so a block of four warps (128
//   threads) owns a 64-row tile and the scores of those rows stay in its
//   registers; wgmma's tf32 form takes K-major operands from shared memory
//   only, and three of the five products need a transposed operand.
// - The transposes come from registers. The dK/dV kernel computes Sᵀ and
//   dPᵀ with keys as the MMA's M, so Pᵀ and dSᵀ sit in the accumulator
//   layout and feed the next product as its A operand directly, as dS does
//   in the dQ kernel. In bf16 two n-tiles of the accumulator are one A
//   fragment, and packing it is where dS and P∘keep/(1-p) round to bf16. In
//   TF32 the accumulator holds columns (2t, 2t+1) where the A fragment wants
//   (t, t+4), so the k order inside each 8-wide chunk is permuted (slot t <->
//   column 2t, slot t+4 <-> column 2t+1) and the B operand is read from shared
//   memory in the same order. dkpm is the f32 row sum of dSᵀ in that layout, a
//   quad shuffle.
// - The per-score work is branch-free (selects for the mask, causal test,
//   dead rows and dropout; the MUFU exponential, within ~2e-6 relative at
//   these scores), and the dropout keep bits of a tile come from one rolled
//   loop whose hash divides each row and column once: unrolled, 32 copies of
//   the hash made the code too large and the kernels 15-35% slower even
//   without dropout. The f32 A·Bᵀ loop over k is rolled for the same reason.
// - Tiles arrive by 16-byte cp.async, zero-filled past T and past D (D is
//   padded to 64 or 128 inside shared memory), double-buffered over the inner
//   loop so the next tile's copy overlaps this tile's products; the owned
//   tile (Q, dO or K, V) is loaded once, and the dQ kernel's mask row comes
//   with each key tile. Rows are padded by 16 bytes, which makes the f32
//   fragment loads and bf16 ldmatrix conflict-free on banks. Rows whose byte
//   length is not a multiple of 16 (odd D in bf16, D not a multiple of 4 in
//   f32) are loaded element by element instead.
// - Occupancy: 128 threads, at D <= 64 an inner tile of 64 rows and 105 KB of
//   shared memory in f32 (56 KB bf16), so two blocks fit on an SM; at D = 128
//   the inner tile is 32 rows, which keeps the accumulators in registers.
//
// The tile loads, fragments, products, keep bits and stores live in
// flash_mma.cuh, shared with the forward kernel.
#include "flash_mma.cuh"

namespace {

// ---- the kernels ----------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ kpm, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int heads, int tq, int tk, int d, float sm_scale,
                    int causal, int use_dropout, uint32_t threshold, float inv_keep, int seed,
                    int ref_bq, int ref_bk, int heads_total, int head_off, int vec) {
  constexpr int kBc = inner_rows(DP);
  constexpr int kLd = row_ld<T, DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // q tile, kRows rows
  T* dos = qs + kRows * kLd;          // dO tile
  T* ks = dos + kRows * kLd;          // two key tiles of kBc rows
  T* vs = ks + 2 * kBc * kLd;         // two value tiles
  float* kpms = reinterpret_cast<float*>(vs + 2 * kBc * kLd);  // two of kBc

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * tq * d;
  const size_t koff = (size_t)bh * tk * d;
  const float* kpm_row = kpm ? kpm + (size_t)(bh / heads) * tk : nullptr;
  const uint32_t seed_bh = fold_bh_seed(seed, global_bh(bh, heads, heads_total, head_off));

  auto load_k_tile = [&](int k0, int buf) {
    load_tile<T, kBc, DP>(ks + buf * kBc * kLd, k + koff, k0, tk, d, vec);
    load_tile<T, kBc, DP>(vs + buf * kBc * kLd, v + koff, k0, tk, d, vec);
    if (kpm_row)
      for (int c = threadIdx.x; c < kBc; c += kThreads) {
        const bool in = k0 + c < tk;  // keys past T add nothing: checked by index below
        cp_async4(kpms + buf * kBc + c, in ? kpm_row + k0 + c : kpm_row, in);
      }
  };

  const int k_end = causal ? min(tk, q0 + kRows) : tk;
  const int n_tiles = (k_end + kBc - 1) / kBc;
  load_tile<T, kRows, DP>(qs, q + qoff, q0, tq, d, vec);
  load_tile<T, kRows, DP>(dos, dout + qoff, q0, tq, d, vec);
  load_k_tile(0, 0);
  cp_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  int row[2];
  float lse_r[2], delta_r[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * warp + g + 8 * i;
    const bool live = row[i] < tq;
    lse_r[i] = live ? lse[(size_t)bh * tq + row[i]] : kNegInf;
    delta_r[i] = live ? delta[(size_t)bh * tq + row[i]] : 0.f;
    dead[i] = lse_r[i] <= kNegInf * 0.5f;  // also rows past T
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
    float s[kBc / 8][4] = {}, dp[kBc / 8][4] = {};
    mma_abt<kBc / 8, DP>(s, qs + 16 * warp * kLd, kt, lane);
    mma_abt<kBc / 8, DP>(dp, dos + 16 * warp * kLd, vt, lane);
    const uint32_t keep = use_dropout ? keep_bits<kBc / 8>(seed_bh, row[0], row[1], k0, t, false,
                                                           ref_bq, ref_bk, threshold)
                                      : ~0u;  // with inv_keep = 1: every score kept as it is
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
        const float p = __expf(sv - lse_r[i]);
        const float kept = (keep >> (4 * n + e)) & 1u ? inv_keep : 0.f;
        const float ds = p * (dp[n][e] * kept - delta_r[i]);  // bf16: rounded by the A pack
        s[n][e] = (!dead[i] && col < tk) ? ds : 0.f;
      }
    }
    mma_pb<kBc / 8, DP>(acc, s, kt, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= tq) continue;
    T* out = dq + qoff + (size_t)row[i] * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      store_pair<T>(out, 8 * n + 2 * t, d, acc[n][2 * i] * sm_scale,
                    acc[n][2 * i + 1] * sm_scale);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ kpm,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dkpm, int heads, int tq, int tk, int d,
                      float sm_scale, int causal, int use_dropout, uint32_t threshold,
                      float inv_keep, int seed, int ref_bq, int ref_bk, int heads_total,
                      int head_off, int vec) {
  constexpr int kBc = inner_rows(DP);
  constexpr int kLd = row_ld<T, DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // this block's key tile, kRows rows
  T* vs = ks + kRows * kLd;           // its value tile
  T* qs = vs + kRows * kLd;           // two q tiles of kBc rows
  T* dos = qs + 2 * kBc * kLd;        // two dO tiles
  float* lses = reinterpret_cast<float*>(dos + 2 * kBc * kLd);  // two of kBc
  float* deltas = lses + 2 * kBc;                                // two of kBc

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * tq * d;
  const size_t koff = (size_t)bh * tk * d;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* delta_bh = delta + (size_t)bh * tq;
  const uint32_t seed_bh = fold_bh_seed(seed, global_bh(bh, heads, heads_total, head_off));

  auto load_q_tile = [&](int q0, int buf) {
    load_tile<T, kBc, DP>(qs + buf * kBc * kLd, q + qoff, q0, tq, d, vec);
    load_tile<T, kBc, DP>(dos + buf * kBc * kLd, dout + qoff, q0, tq, d, vec);
    for (int r = threadIdx.x; r < kBc; r += kThreads) {
      const bool in = q0 + r < tq;  // rows past T are dead: checked by index below
      cp_async4(lses + buf * kBc + r, in ? lse_bh + q0 + r : lse_bh, in);
      cp_async4(deltas + buf * kBc + r, in ? delta_bh + q0 + r : delta_bh, in);
    }
  };

  // causal: a q tile whose last row lies above this tile's first key sees none of it
  const int q_begin = causal ? (k0 / kBc) * kBc : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + kBc - 1) / kBc : 0;
  load_tile<T, kRows, DP>(ks, k + koff, k0, tk, d, vec);
  load_tile<T, kRows, DP>(vs, v + koff, k0, tk, d, vec);
  if (n_tiles > 0) load_q_tile(q_begin, 0);
  cp_commit();

  // this thread's keys: g and g + 8 of the warp's 16
  int key[2];
  float kpm_c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + 16 * warp + g + 8 * i;
    kpm_c[i] = (kpm && key[i] < tk) ? kpm[(size_t)(bh / heads) * tk + key[i]] : 0.f;
  }

  float dk_acc[DP / 8][4] = {}, dv_acc[DP / 8][4] = {};
  float dkpm_acc[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kBc;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      load_q_tile(q0 + kBc, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* qt = qs + buf * kBc * kLd;
    const T* dot = dos + buf * kBc * kLd;
    const float* lt = lses + buf * kBc;
    const float* dt = deltas + buf * kBc;
    // Sᵀ and dPᵀ: keys are the MMA's rows, q rows its columns
    float s[kBc / 8][4] = {}, dp[kBc / 8][4] = {};
    mma_abt<kBc / 8, DP>(s, ks + 16 * warp * kLd, qt, lane);
    mma_abt<kBc / 8, DP>(dp, vs + 16 * warp * kLd, dot, lane);
    const uint32_t keep = use_dropout ? keep_bits<kBc / 8>(seed_bh, key[0], key[1], q0, t, true,
                                                           ref_bq, ref_bk, threshold)
                                      : ~0u;  // with inv_keep = 1: every score kept as it is
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // selects, no branches: 4·kBc/8 copies of this body
        const int i = e >> 1;
        const int r = 8 * n + 2 * t + (e & 1);
        const int grow = q0 + r;
        const float lse_r = lt[r];
        const bool live = key[i] < tk && grow < tq && lse_r > kNegInf * 0.5f;
        float sv = fmaf(s[n][e], sm_scale, kpm_c[i]);
        sv = (causal && grow < key[i]) ? kNegInf : sv;
        const float p = live ? __expf(sv - lse_r) : 0.f;
        const float kept = (keep >> (4 * n + e)) & 1u ? inv_keep : 0.f;
        const float ds = p * (dp[n][e] * kept - dt[r]);
        dkpm_acc[i] += ds;  // the reference sums dS before any rounding
        dp[n][e] = ds;      // bf16: dS and P∘keep/(1-p) are rounded by the A pack
        s[n][e] = p * kept;
      }
    }
    mma_pb<kBc / 8, DP>(dv_acc, s, dot, lane);
    mma_pb<kBc / 8, DP>(dk_acc, dp, qt, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_wait<0>();  // no copy is left in flight, also when no q tile ran

#pragma unroll
  for (int i = 0; i < 2; ++i) dkpm_acc[i] = row_sum(dkpm_acc[i]);  // all lanes shuffle
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= tk) continue;
    T* dkr = dk + koff + (size_t)key[i] * d;
    T* dvr = dv + koff + (size_t)key[i] * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      store_pair<T>(dkr, c, d, dk_acc[n][2 * i] * sm_scale, dk_acc[n][2 * i + 1] * sm_scale);
      store_pair<T>(dvr, c, d, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
  if (dkpm && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] < tk) dkpm[(size_t)bh * tk + key[i]] = dkpm_acc[i];
  }
}

struct Args {
  const void *q, *k, *v, *kpm, *dout, *lse, *delta;
  int bh, heads, tq, tk, d;
  float sm_scale;
  int causal, use_dropout;
  unsigned threshold;
  float inv_keep;
  int seed, ref_bq, ref_bk, heads_total, head_off;
};

// Two owned tiles, two double-buffered inner tiles, and f32 rows beside
// them: kpm (dQ, two of kBc) or lse and delta (dK/dV, four of kBc).
template <typename T, int DP>
constexpr int tiles_smem_bytes() {
  return (2 * kRows + 4 * inner_rows(DP)) * row_ld<T, DP>() * (int)sizeof(T);
}

template <typename T, int DP>
constexpr int dq_smem_bytes() {
  return tiles_smem_bytes<T, DP>() + 2 * inner_rows(DP) * (int)sizeof(float);
}

template <typename T, int DP>
constexpr int dkdv_smem_bytes() {
  return tiles_smem_bytes<T, DP>() + 4 * inner_rows(DP) * (int)sizeof(float);
}

// Whole 16-byte chunks per row, and every operand 16-byte aligned.
template <typename T>
int vec_ok(const Args& a) {
  const uintptr_t any = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout;
  return (a.d * (int)sizeof(T)) % 16 == 0 && (any & 15) == 0;
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.tq + kRows - 1) / kRows, a.bh);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.kpm), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.heads, a.tq, a.tk, a.d, a.sm_scale, a.causal, a.use_dropout,
      a.threshold, a.inv_keep, a.seed, a.ref_bq, a.ref_bk, a.heads_total, a.head_off,
      vec_ok<T>(a));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, void* dkpm, cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.tk + kRows - 1) / kRows, a.bh);
  flash_bwd_dkdv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.kpm), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dkpm), a.heads, a.tq,
      a.tk, a.d, a.sm_scale, a.causal, a.use_dropout, a.threshold, a.inv_keep, a.seed,
      a.ref_bq, a.ref_bk, a.heads_total, a.head_off, vec_ok<T>(a));
  return cudaGetLastError();
}

// The kernel instance and its shared memory for (kernel, head dim, dtype):
// kernel 0 = dQ, 1 = dK/dV; D <= 64 pads to 64, else to 128.
template <typename T>
void pick(int kernel, int d, const void** fn, int* smem) {
  if (kernel == 0) {
    *fn = d <= 64 ? (const void*)flash_bwd_dq_kernel<T, 64> : (const void*)flash_bwd_dq_kernel<T, 128>;
    *smem = d <= 64 ? dq_smem_bytes<T, 64>() : dq_smem_bytes<T, 128>();
  } else {
    *fn = d <= 64 ? (const void*)flash_bwd_dkdv_kernel<T, 64>
                  : (const void*)flash_bwd_dkdv_kernel<T, 128>;
    *smem = d <= 64 ? dkdv_smem_bytes<T, 64>() : dkdv_smem_bytes<T, 128>();
  }
}

bool valid(const Args& a) {
  return a.d >= 1 && a.d <= kMaxD && a.bh >= 1 && a.heads >= 1 && a.tq >= 1 && a.tk >= 1 &&
         a.ref_bq >= 1 && a.ref_bk >= 1 && a.head_off >= 0 &&
         a.head_off + a.heads <= a.heads_total;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout (bh, tq, d); k, v (bh, tk, d); kpm
// (bh / heads, tk) f32 or null; lse, delta (bh, tq) f32; dq like q. Returns a
// cudaError_t. heads_total and head_off: as flash_attn_fwd's.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* kpm,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 int bh, int heads, int tq, int tk, int d, float sm_scale,
                                 int causal, int use_dropout, unsigned threshold,
                                 float inv_keep, int seed, int ref_bq, int ref_bk,
                                 int heads_total, int head_off, int dtype, void* stream) {
  const Args a{q, k, v, kpm, dout, lse, delta, bh, heads, tq, tk, d, sm_scale, causal,
               use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk, heads_total, head_off};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(d <= 64 ? launch_dq<float, 64>(a, dq, s) : launch_dq<float, 128>(a, dq, s));
  if (dtype == 1)
    return (int)(d <= 64 ? launch_dq<__nv_bfloat16, 64>(a, dq, s)
                         : launch_dq<__nv_bfloat16, 128>(a, dq, s));
  return (int)cudaErrorInvalidValue;
}

// As flash_attn_bwd_dq; dk, dv like k, v; dkpm (bh, tk) f32 per-(batch·head)
// partials, or null when there is no kpm.
extern "C" int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* kpm, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, void* dkpm, int bh,
                                   int heads, int tq, int tk, int d, float sm_scale, int causal,
                                   int use_dropout, unsigned threshold, float inv_keep, int seed,
                                   int ref_bq, int ref_bk, int heads_total, int head_off,
                                   int dtype, void* stream) {
  const Args a{q, k, v, kpm, dout, lse, delta, bh, heads, tq, tk, d, sm_scale, causal,
               use_dropout, threshold, inv_keep, seed, ref_bq, ref_bk, heads_total, head_off};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(d <= 64 ? launch_dkdv<float, 64>(a, dk, dv, dkpm, s)
                         : launch_dkdv<float, 128>(a, dk, dv, dkpm, s));
  if (dtype == 1)
    return (int)(d <= 64 ? launch_dkdv<__nv_bfloat16, 64>(a, dk, dv, dkpm, s)
                         : launch_dkdv<__nv_bfloat16, 128>(a, dk, dv, dkpm, s));
  return (int)cudaErrorInvalidValue;
}

// Blocks of the dQ (kernel 0) or dK/dV (kernel 1) kernel that fit on one SM
// at head dim d and dtype (as above), and the dynamic shared memory each
// takes. Returns a cudaError_t.
extern "C" int flash_attn_bwd_occupancy(int kernel, int d, int dtype, int* blocks_per_sm,
                                        int* smem_bytes) {
  if (d < 1 || d > kMaxD || (kernel != 0 && kernel != 1)) return (int)cudaErrorInvalidValue;
  const void* fn;
  if (dtype == 0)
    pick<float>(kernel, d, &fn, smem_bytes);
  else if (dtype == 1)
    pick<__nv_bfloat16>(kernel, d, &fn, smem_bytes);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads,
                                                            *smem_bytes);
}
