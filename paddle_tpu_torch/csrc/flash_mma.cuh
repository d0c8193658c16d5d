// Shared by the flash-attention kernels on the tensor cores (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the block shape, 16-byte cp.async tile loads zero-filled
// past T and past D, the mma.sync fragments (m16n8k16 bf16, and m16n8k8 TF32
// three times per product for f32: 3xTF32), the two products every kernel is
// built from (A·Bᵀ from shared memory, P·B with P in accumulator registers),
// the dropout keep bits of a score tile, and paired output stores.
#pragma once
#include "flash_common.cuh"

namespace {

constexpr int kRows = 64;  // rows a block owns: q rows (forward, dQ) or keys (dK/dV)
constexpr int kWarps = 4;  // each warp owns 16 of them
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;

// Rows of the tile streamed through the inner loop.
__host__ __device__ constexpr int inner_rows(int dp) { return dp == 128 ? 32 : 64; }

// Elements per shared-memory row: D padded, plus 16 bytes against bank conflicts.
template <typename T, int DP>
__host__ __device__ constexpr int row_ld() {
  return DP + 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared; zero-filled when `in` is false (src then
// only needs to be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major (rows, d) matrix into a (ROWS, row_ld)
// tile; rows past `rows` and columns d..DP-1 read as zeros. `vec`: every row
// starts 16-byte aligned, so whole 16-byte chunks go by cp.async.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int rows, int d,
                                          bool vec) {
  constexpr int kLd = row_ld<T, DP>();
  if (vec) {
    constexpr int kChunk = 16 / (int)sizeof(T);
    constexpr int kPerRow = DP / kChunk;
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
      const bool in = r0 + r < rows && c < d;
      cp_async16(dst + r * kLd + c, in ? src + (size_t)(r0 + r) * d + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * kLd + c] =
          (r0 + r < rows && c < d) ? src[(size_t)(r0 + r) * d + c] : from_f<T>(0.f);
    }
  }
}

// ---- tensor-core fragments ----------------------------------------------
// In every fragment below, lane = 4g + t. An m16n8 accumulator c[4] holds
// (row g, col 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 values: the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[u] += a·b[u] for four n-tiles in 3xTF32 from the split A and the f32
// B pairs (b0[u], b1[u]): small·big, big·small, big·big, each product exact
// in f32, the small·small term (2^-22 relative) dropped. Each pass runs over
// the four tiles before the next, so no mma waits on the one before it.
__device__ __forceinline__ void mma_3xtf32_x4(float (&c0)[4], float (&c1)[4], float (&c2)[4],
                                              float (&c3)[4], const uint32_t (&ab)[4],
                                              const uint32_t (&as)[4], const float (&b0)[4],
                                              const float (&b1)[4]) {
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    split_tf32(b0[u], bb[u][0], bs[u][0]);
    split_tf32(b1[u], bb[u][1], bs[u][1]);
  }
  mma_tf32(c0, as, bb[0][0], bb[0][1]);
  mma_tf32(c1, as, bb[1][0], bb[1][1]);
  mma_tf32(c2, as, bb[2][0], bb[2][1]);
  mma_tf32(c3, as, bb[3][0], bb[3][1]);
  mma_tf32(c0, ab, bs[0][0], bs[0][1]);
  mma_tf32(c1, ab, bs[1][0], bs[1][1]);
  mma_tf32(c2, ab, bs[2][0], bs[2][1]);
  mma_tf32(c3, ab, bs[3][0], bs[3][1]);
  mma_tf32(c0, ab, bb[0][0], bb[0][1]);
  mma_tf32(c1, ab, bb[1][0], bb[1][1]);
  mma_tf32(c2, ab, bb[2][0], bb[2][1]);
  mma_tf32(c3, ab, bb[3][0], bb[3][1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (16 × 8·NT) += A·Bᵀ over DP: A the warp's 16 rows of a row-major tile,
// B the first 8·NT rows of another (S = Q·Kᵀ, dP = dO·Vᵀ and their
// transposes).
template <int NT, int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const float* a, const float* b,
                                        int lane) {
  constexpr int kLd = row_ld<float, DP>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < DP; k0 += 8) {
    uint32_t ab[4], as[4];
    split_tf32(a[g * kLd + k0 + t], ab[0], as[0]);
    split_tf32(a[(g + 8) * kLd + k0 + t], ab[1], as[1]);
    split_tf32(a[g * kLd + k0 + t + 4], ab[2], as[2]);
    split_tf32(a[(g + 8) * kLd + k0 + t + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; n += 4) {
      float b0[4], b1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* bp = b + (8 * (n + u) + g) * kLd + k0 + t;
        b0[u] = bp[0];
        b1[u] = bp[4];
      }
      mma_3xtf32_x4(acc[n], acc[n + 1], acc[n + 2], acc[n + 3], ab, as, b0, b1);
    }
  }
}

template <int NT, int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int kLd = row_ld<__nv_bfloat16, DP>();
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * kLd + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (8 * n + (lane & 7) + (lane >> 4) * 8) * kLd + k0 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 × DP) += P·B: P (16 × 8·KT) in accumulator fragments (dS, Pᵀ, dSᵀ),
// B (8·KT × DP) a row-major tile whose rows are the contraction index
// (dS·K, Pᵀ·dO, dSᵀ·Q).
template <int KT, int DP>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4], const float (&p)[KT][4],
                                       const float* b, int lane) {
  constexpr int kLd = row_ld<float, DP>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    // k slot t <-> column 8j+2t, slot t+4 <-> column 8j+2t+1
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
    const float* bp = b + (8 * j + 2 * t) * kLd + g;
#pragma unroll
    for (int n = 0; n < DP / 8; n += 4) {
      float b0[4], b1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        b0[u] = bp[8 * (n + u)];
        b1[u] = bp[kLd + 8 * (n + u)];
      }
      mma_3xtf32_x4(acc[n], acc[n + 1], acc[n + 2], acc[n + 3], ab, as, b0, b1);
    }
  }
}

template <int KT, int DP>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4], const float (&p)[KT][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int kLd = row_ld<__nv_bfloat16, DP>();
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* bp =
        b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, bp + 8 * n);
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// Keep bits of this thread's 4·NT accumulator elements of a score tile, bit
// 4n + e for element e of n-tile n: rows r_lo (e < 2) and r_hi, columns
// c0 + 8n + 2t + (e & 1); `transposed`: rows are keys and columns q rows.
// The hash of dropout_keep, split into its row and column terms so each row
// and column is divided by its reference tile once; a rolled loop over the
// columns keeps one copy of it in the code.
template <int NT>
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed_bh, int r_lo, int r_hi, int c0,
                                              int t, bool transposed, int ref_bq, int ref_bk,
                                              uint32_t threshold) {
  const int row_tile = transposed ? ref_bk : ref_bq, col_tile = transposed ? ref_bq : ref_bk;
  const uint32_t row_x = transposed ? kHashKj : kHashQi, row_a = transposed ? kHashC : kHashR;
  const uint32_t col_x = transposed ? kHashQi : kHashKj, col_a = transposed ? kHashR : kHashC;
  uint32_t rx[2], ra[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t r = (uint32_t)(i ? r_hi : r_lo);
    rx[i] = seed_bh ^ (r / row_tile) * row_x;
    ra[i] = (r % row_tile) * row_a;
  }
  uint32_t bits = 0;
#pragma unroll 1
  for (int j = 0; j < 2 * NT; ++j) {  // column c0 + 8(j/2) + 2t + j%2
    const uint32_t c = (uint32_t)(c0 + 8 * (j >> 1) + 2 * t + (j & 1));
    const uint32_t cx = (c / col_tile) * col_x, ca = (c % col_tile) * col_a;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      bits |= (uint32_t)(fmix32((rx[i] ^ cx) + ra[i] + ca) >= threshold)
              << (4 * (j >> 1) + 2 * i + (j & 1));
  }
  return bits;
}

// out[c] and out[c + 1] of one row from an accumulator pair; when d is even
// the two share one aligned store (on the H100 measurably faster than a
// store per element, most of all for 2-byte bf16 stores).
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int c, int d, float x0, float x1);

template <>
__device__ __forceinline__ void store_pair<float>(float* out, int c, int d, float x0,
                                                  float x1) {
  if ((d & 1) == 0 && c + 1 < d) {
    *reinterpret_cast<float2*>(out + c) = make_float2(x0, x1);
  } else {
    if (c < d) out[c] = x0;
    if (c + 1 < d) out[c + 1] = x1;
  }
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* out, int c, int d,
                                                          float x0, float x1) {
  if ((d & 1) == 0 && c + 1 < d) {
    *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < d) out[c] = __float2bfloat16(x0);
    if (c + 1 < d) out[c + 1] = __float2bfloat16(x1);
  }
}

}  // namespace
