// Shared by the two LayerNorm kernel sources (layer_norm_fwd.cu,
// layer_norm_bwd.cu): the accessors of a row held in registers as 16-byte
// chunks, the scalar load, gamma where it may be absent, the test of whether
// the rows can take 16-byte accesses, and the SM count their launches spread
// the rows over.
#pragma once
#include <stdint.h>

#include "common.cuh"

namespace {

// Element e of 16 bytes of T as f32, and the other way.
template <typename T>
__device__ __forceinline__ float lane_elem(const uint4& r, int e);
template <>
__device__ __forceinline__ float lane_elem<float>(const uint4& r, int e) {
  return __uint_as_float((&r.x)[e]);
}
template <>
__device__ __forceinline__ float lane_elem<__nv_bfloat16>(const uint4& r, int e) {
  const uint32_t w = (&r.x)[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T>
__device__ __forceinline__ void set_elem(uint4& r, int e, float x);
template <>
__device__ __forceinline__ void set_elem<float>(uint4& r, int e, float x) {
  (&r.x)[e] = __float_as_uint(x);
}
template <>
__device__ __forceinline__ void set_elem<__nv_bfloat16>(uint4& r, int e, float x) {
  const __nv_bfloat16 b = __float2bfloat16(x);
  const uint32_t bits = (uint32_t)*reinterpret_cast<const unsigned short*>(&b);
  uint32_t& w = (&r.x)[e >> 1];
  w = (e & 1) ? ((w & 0x0000ffffu) | (bits << 16)) : ((w & 0xffff0000u) | bits);
}

// *p as f32, by a plain load: the compiler keeps it under the bounds test
// around it. Not __ldg: cuda_bf16.h's __ldg(const __nv_bfloat16*) is an asm
// statement without side effects, which the compiler may hoist above that
// test, and the LayerNorm backward then read bfloat16 gamma past its end (an
// illegal address where gamma ended a mapping; chip_kernel_bounds.py).
template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  return to_f(*p);
}

// gamma[c] as f32, or 1 where gamma is absent (null).
template <typename W>
__device__ __forceinline__ float gamma_at(const W* gamma, int c) {
  return gamma ? load_f(gamma + c) : 1.f;
}

// Rows of h elements of `elem_bytes` each can be read and written with
// 16-byte accesses: every row is whole 16-byte chunks and every pointer
// (OR-ed into `ptrs`; a null one adds nothing) is 16-byte aligned.
inline bool rows_in_16_bytes(int h, int elem_bytes, uintptr_t ptrs) {
  return (h * elem_bytes) % 16 == 0 && (ptrs & 15) == 0;
}

// SMs of the current device, which the launches spread their rows over.
inline int card_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace
