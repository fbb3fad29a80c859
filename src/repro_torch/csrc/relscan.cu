// Fused WHERE scan and compaction for the port's FusedScan plans.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/relscan.py:
//   relscan_scan     <- _scan_kernel    (relscan.py:51, launched at :137)
//   relscan_compact  <- _compact_kernel (relscan.py:62, launched at :165)
//
// What bounds them on an H100: memory. The scan reads nterms int32
// columns and the 1-byte validity bitmap and writes a 1-byte match mask,
// (5 * nterms + 2) bytes a row and one compare per term: at 3.35 TB/s a
// 131,072-row one-term scan moves ~0.9 MB (~0.27 us), far below launch
// overhead; a 4-term scan of 4M rows moves ~92 MB (~27 us).
// The compaction reads the mask (1 byte a row) and writes at most `limit`
// row ids; blocks whose offset is already past `limit` exit at once.
//
// Design. The TPU kernel tiles 2048 rows into (16, 128) VMEM blocks and
// runs the grid in order, carrying the id output across grid steps. Here
// blocks run in any order on 132 SMs, so:
//   * one thread per row, 256 rows a block, coalesced int32 loads; the
//     ragged edge is masked in the kernel (no padded copies of columns);
//   * the <= 4 operator codes arrive as kernel arguments and are uniform
//     across the grid, so the switch never diverges;
//   * per-block match counts come from warp ballots + popc;
//   * the compaction takes the exclusive prefix of those counts (computed
//     between the launches, as the JAX package does at relscan.py:163),
//     ranks its set bits with ballot/popc, and writes row ids at
//     offset + rank < limit: ids come out in row order, with no atomics;
//   * a second grid dimension runs w statements (one row of the [w, nterms]
//     value matrix each) over the same columns in one launch: the batched
//     SELECT / aggregate executors use it; w = 1 is the TPU kernel's
//     contract.
#include "common.cuh"

namespace {

enum : int { OP_EQ = 0, OP_NE = 1, OP_LT = 2, OP_LE = 3, OP_GT = 4, OP_GE = 5 };

struct Cols { const int32_t* c[4]; };
struct Ops { int op[4]; };

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

__global__ void __launch_bounds__(RS_BLOCK)
scan_kernel(Cols cols, Ops ops, int nterms, const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ vals, int cap, int nblk,
            uint8_t* __restrict__ mask, int32_t* __restrict__ cnt) {
  const int blk = blockIdx.x;
  const int q = blockIdx.y;
  const int row = blk * RS_BLOCK + threadIdx.x;
  bool m = false;
  if (row < cap) {
    m = valid[row] != 0;
    const int32_t* v = vals + (size_t)q * nterms;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < nterms) m = m & compare(ops.op[t], cols.c[t][row], v[t]);
    }
    mask[(size_t)q * cap + row] = m;
  }
  const unsigned bits = __ballot_sync(0xffffffffu, m);
  __shared__ int warp_count[RS_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_count[warp] = __popc(bits);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < RS_WARPS; ++i) s += warp_count[i];
    cnt[(size_t)q * nblk + blk] = s;
  }
}

__global__ void __launch_bounds__(RS_BLOCK)
compact_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ offs,
               int cap, int nblk, int limit, int32_t* __restrict__ ids) {
  const int blk = blockIdx.x;
  const int q = blockIdx.y;
  const int off = offs[(size_t)q * nblk + blk];
  if (off >= limit) return;  // uniform over the block: nothing left to place
  const int row = blk * RS_BLOCK + threadIdx.x;
  const bool m = row < cap && mask[(size_t)q * cap + row] != 0;
  const unsigned bits = __ballot_sync(0xffffffffu, m);
  __shared__ int warp_count[RS_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_count[warp] = __popc(bits);
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_count[i];
  const int pos = off + before + __popc(bits & ((1u << lane) - 1u));
  if (m && pos < limit) ids[(size_t)q * limit + pos] = row;
}

}  // namespace

// mask [w, cap] uint8 and cnt [w, nblk] int32 out; vals [w, nterms] int32.
REPRO_EXPORT int relscan_scan(const void* c0, const void* c1, const void* c2,
                              const void* c3, int op0, int op1, int op2, int op3,
                              int nterms, const void* valid, const void* vals,
                              int cap, int w, void* mask, void* cnt,
                              void* stream) {
  const int nblk = (cap + RS_BLOCK - 1) / RS_BLOCK;
  Cols cols = {{(const int32_t*)c0, (const int32_t*)c1, (const int32_t*)c2,
                (const int32_t*)c3}};
  Ops ops = {{op0, op1, op2, op3}};
  dim3 grid(nblk, w);
  scan_kernel<<<grid, RS_BLOCK, 0, (cudaStream_t)stream>>>(
      cols, ops, nterms, (const uint8_t*)valid, (const int32_t*)vals, cap, nblk,
      (uint8_t*)mask, (int32_t*)cnt);
  return (int)cudaGetLastError();
}

// ids [w, limit] int32 must be zeroed by the caller (0-padded contract);
// offs [w, nblk] is the exclusive prefix of the scan's block counts.
REPRO_EXPORT int relscan_compact(const void* mask, const void* offs, int cap,
                                 int w, int limit, void* ids, void* stream) {
  const int nblk = (cap + RS_BLOCK - 1) / RS_BLOCK;
  dim3 grid(nblk, w);
  compact_kernel<<<grid, RS_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int32_t*)offs, cap, nblk, limit,
      (int32_t*)ids);
  return (int)cudaGetLastError();
}
