// Bucketed hash index: bulk build and batched probe.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/hashidx.py:
//   hash_build  <- _build_kernel (hashidx.py:133, launched at :167)
//   hash_probe  <- _probe_kernel (hashidx.py:207, launched at :237)
//
// What bounds them on an H100: memory, and at the daemon's sizes launch
// latency. The build writes the [n_buckets, 128] rid and key arrays
// (4.2 MB for 4,096 buckets) and gathers from the sorted order; at
// 3.35 TB/s that is ~1.6 us. A probe of w keys reads and writes
// w * 128 lanes (~1.7 KB for w = 1).
//
// Design. The sort that groups rows by bucket stays in PyTorch (a stable
// sort + searchsorted, as the JAX package leaves it to XLA); the kernels
// only do the per-bucket work the TPU did one bucket tile at a time:
//   * build: one warp per bucket; lane l copies sorted positions
//     start[b] + l, l + 32, l + 64, l + 96 (coalesced), keeps those whose
//     bucket id is b, and writes EMPTY / 0 elsewhere. The ragged end of
//     the sorted arrays is masked here, so nothing is padded. Because the
//     sort is stable the rows come out lane for lane as in build_ref.
//   * probe: one warp per query key; the bucket id is the top lg bits of
//     the 32-bit product key * 2654435761 (uint32_t wraparound, the same
//     bits as the JAX bucket_of for negative keys too); the warp reads the
//     bucket's 128-lane rid/key rows with coalesced loads and writes the
//     candidates and hit bits. The batched SELECT / aggregate executors
//     probe all w keys in one launch.
#include "common.cuh"

namespace {

__global__ void build_kernel(const int32_t* __restrict__ order,
                             const int32_t* __restrict__ sb,
                             const int32_t* __restrict__ start,
                             const int32_t* __restrict__ keys, int cap, int nb,
                             int32_t* __restrict__ rid, int32_t* __restrict__ key) {
  const int b = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= nb) return;
  const int s = start[b];
#pragma unroll
  for (int j = lane; j < HX_LANES; j += 32) {
    const int pos = s + j;
    int32_t r = HX_EMPTY, k = 0;
    if (pos < cap && sb[pos] == b) {
      r = order[pos];
      k = keys[r];
    }
    rid[(size_t)b * HX_LANES + j] = r;
    key[(size_t)b * HX_LANES + j] = k;
  }
}

__global__ void probe_kernel(const int32_t* __restrict__ rid,
                             const int32_t* __restrict__ key,
                             const int32_t* __restrict__ qkeys, int w, int lg,
                             int32_t* __restrict__ cand, uint8_t* __restrict__ hit) {
  const int q = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= w) return;
  const int32_t k = qkeys[q];
  const uint32_t b = ((uint32_t)k * HX_PRIME) >> (32 - lg);
  const int32_t* rrow = rid + (size_t)b * HX_LANES;
  const int32_t* krow = key + (size_t)b * HX_LANES;
#pragma unroll
  for (int j = lane; j < HX_LANES; j += 32) {
    const int32_t r = rrow[j];
    cand[(size_t)q * HX_LANES + j] = r;
    hit[(size_t)q * HX_LANES + j] = (r != HX_EMPTY) && (krow[j] == k);
  }
}

constexpr int kThreads = 256;  // 8 warps = 8 buckets (or queries) a block

}  // namespace

// order/sb [cap] int32 (rows sorted by bucket, sentinel nb for invalid
// rows), start [nb] int32, keys [cap] int32 -> rid/key [nb, 128] int32.
REPRO_EXPORT int hash_build(const void* order, const void* sb, const void* start,
                            const void* keys, int cap, int nb, void* rid,
                            void* key, void* stream) {
  const int blocks = (int)(((size_t)nb * 32 + kThreads - 1) / kThreads);
  build_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)order, (const int32_t*)sb, (const int32_t*)start,
      (const int32_t*)keys, cap, nb, (int32_t*)rid, (int32_t*)key);
  return (int)cudaGetLastError();
}

// rid/key [2^lg, 128] int32, qkeys [w] int32 -> cand [w, 128] int32,
// hit [w, 128] uint8.
REPRO_EXPORT int hash_probe(const void* rid, const void* key, const void* qkeys,
                            int w, int lg, void* cand, void* hit, void* stream) {
  const int blocks = (int)(((size_t)w * 32 + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rid, (const int32_t*)key, (const int32_t*)qkeys, w, lg,
      (int32_t*)cand, (uint8_t*)hit);
  return (int)cudaGetLastError();
}
