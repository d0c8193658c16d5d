// Shared by the flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu):
// the dropout hash, so the backward kernels drop exactly the scores the
// forward kernel dropped, and the reductions over one row's four lanes.
#pragma once
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// The hash's multipliers of the tile row qi, the tile column kj, and the row r
// and column c inside the tile.
constexpr uint32_t kHashQi = 0x9E3779B9u, kHashKj = 0x85EBCA6Bu;
constexpr uint32_t kHashR = 0x27D4EB2Fu, kHashC = 0x165667B1u;

// murmur3's fmix32
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// pallas_attention._tile_random_bits for one element (uint32 wraparound).
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t qi, uint32_t kj,
                                                 uint32_t r, uint32_t c) {
  uint32_t h = seed ^ (qi * kHashQi) ^ (kj * kHashKj);
  return fmix32(h + r * kHashR + c * kHashC);
}

// fold_bh_seed: int32 seed + bh * 1000003 with wraparound, read as uint32
__device__ __forceinline__ uint32_t fold_bh_seed(int seed, int bh) {
  return (uint32_t)seed + (uint32_t)bh * 1000003u;
}

// Keep bit of score (row, col): the hash in the REFERENCE's tile coordinates
// (row / ref_bq, col / ref_bk, row % ref_bq, col % ref_bk), whatever tile the
// kernel uses.
__device__ __forceinline__ bool dropout_keep(uint32_t seed_bh, int row, int col, int ref_bq,
                                             int ref_bk, uint32_t threshold) {
  return dropout_bits(seed_bh, (uint32_t)(row / ref_bq), (uint32_t)(col / ref_bk),
                      (uint32_t)(row % ref_bq), (uint32_t)(col % ref_bk)) >= threshold;
}

// Sum / max over the four consecutive lanes that share one row.
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
