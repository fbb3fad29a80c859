// Shared definitions of the port's CUDA kernels (plain C interface:
// every exported function takes device pointers, ints and a stream, and
// returns the launch's cudaGetLastError() for the Python wrapper to check).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Rows handled by one block of the relscan kernels: one row per thread.
constexpr int RS_BLOCK = 256;
constexpr int RS_WARPS = RS_BLOCK / 32;

// Lanes of one hash-index bucket (kernels/hashidx.py BUCKET_CAP).
constexpr int HX_LANES = 128;
constexpr int32_t HX_EMPTY = -1;
constexpr uint32_t HX_PRIME = 2654435761u;  // Fibonacci hashing multiplier
