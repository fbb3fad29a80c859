// Shared pieces of the port's two attention kernels (flash_attention.cu,
// paged_attention.cu): element conversions, warp reductions and the
// masking constant of the reference's online softmax.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

// The reference masks with a large finite negative (not -inf), so a tile
// whose positions are all masked contributes exp(0) = 1 terms until a
// visible score arrives and its correction factor exp(-1e30 - m) wipes
// them; the kernels keep that arithmetic.
constexpr float ATT_NEG_INF = -1e30f;
// A position past the keys (a tile's zero-filled tail) weighs nothing even
// in a row that sees no key, where the masked keys share the weight (the
// reference's softmax over sk masked scores: the mean of V).
constexpr float ATT_NONE = -__builtin_huge_valf();
constexpr unsigned ATT_FULL = 0xffffffffu;

// dtype codes of the C entry points
constexpr int ATT_F32 = 0;
constexpr int ATT_BF16 = 1;

template <typename T> __device__ __forceinline__ float att_load(const T* p);
template <> __device__ __forceinline__ float att_load<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float att_load<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void att_store(T* p, float x);
template <> __device__ __forceinline__ void att_store<float>(float* p, float x) {
  *p = x;
}
template <> __device__ __forceinline__ void att_store<__nv_bfloat16>(
    __nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float att_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(ATT_FULL, x, o));
  return x;
}

__device__ __forceinline__ float att_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(ATT_FULL, x, o);
  return x;
}

__device__ __forceinline__ float att_softcap(float s, float cap) {
  return cap > 0.f ? tanhf(s / cap) * cap : s;
}

// Dynamic shared memory above the default 48 KB must be opted into per
// kernel before the launch.
template <typename K>
inline cudaError_t att_smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
