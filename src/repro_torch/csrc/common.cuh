// Shared definitions of the port's CUDA kernels (plain C interface:
// every exported function takes device pointers, ints and a stream, and
// returns the launch's cudaGetLastError() for the Python wrapper to check).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Rows of one block of the relscan scan's per-block counts
// (kernels/relscan.py BLOCK).
constexpr int RS_BLOCK = 256;

// Comparison codes of the relscan and hash-probe terms
// (kernels/relscan.py OP_CODES).
enum : int { OP_EQ = 0, OP_NE = 1, OP_LT = 2, OP_LE = 3, OP_GT = 4, OP_GE = 5 };

// one bit per nonzero byte of w (bit i = byte i)
__device__ __forceinline__ uint32_t nz_bits4(uint32_t w) {
  const uint32_t f = __vcmpne4(w, 0u) & 0x01010101u;
  return (f * 0x01020408u) >> 24;  // the four byte flags land in bits 24-27
}

// bits 0-3 of b as the bytes 0/1 of a 32-bit word (byte j = bit j)
__device__ __forceinline__ uint32_t bits_to_bytes4(uint32_t b) {
  return ((b & 0xFu) * 0x00204081u) & 0x01010101u;
}

template <int OP>
__device__ __forceinline__ bool cmp_op(int32_t a, int32_t b) {
  if constexpr (OP == OP_EQ) return a == b;
  else if constexpr (OP == OP_NE) return a != b;
  else if constexpr (OP == OP_LT) return a < b;
  else if constexpr (OP == OP_LE) return a <= b;
  else if constexpr (OP == OP_GT) return a > b;
  else return a >= b;
}

__device__ __forceinline__ bool compare(int op, int32_t a, int32_t b) {
  switch (op) {
    case OP_EQ: return a == b;
    case OP_NE: return a != b;
    case OP_LT: return a < b;
    case OP_LE: return a <= b;
    case OP_GT: return a > b;
    default:    return a >= b;
  }
}

// Lanes of one hash-index bucket (kernels/hashidx.py BUCKET_CAP).
constexpr int HX_LANES = 128;
constexpr int32_t HX_EMPTY = -1;
constexpr uint32_t HX_PRIME = 2654435761u;  // Fibonacci hashing multiplier
