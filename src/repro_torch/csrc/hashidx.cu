// Bucketed hash index: bulk build and batched probe.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/hashidx.py:
//   hash_build  <- _build_kernel (hashidx.py:133, launched at :167)
//   hash_probe  <- _probe_kernel (hashidx.py:207, launched at :237)
//
// What bounds them on an H100: memory, and at the daemon's sizes launch
// latency. The build writes the [n_buckets, 128] rid and key arrays
// (4.2 MB for 4,096 buckets) and gathers from the sorted order; at
// 3.35 TB/s that is ~1.6 us. A probe of w keys reads w * 128 lanes of
// rid and key (~1 KB for w = 1), and with verification gathers the
// candidates' rows: a chain of three dependent loads (the key, its
// bucket, the candidates' rows), so its floor is one launch's latency.
//
// Design. The sort that groups rows by bucket stays in PyTorch (a stable
// sort + searchsorted, as the JAX package leaves it to XLA); the kernels
// only do the per-bucket work the TPU did one bucket tile at a time:
//   * build: one warp per bucket; lane l copies sorted positions
//     start[b] + l, l + 32, l + 64, l + 96 (coalesced), keeps those whose
//     bucket id is b, and writes EMPTY / 0 elsewhere. The ragged end of
//     the sorted arrays is masked here, so nothing is padded. Because the
//     sort is stable the rows come out lane for lane as in build_ref.
//   * probe: one warp per query key, all w keys in one launch; the bucket
//     id is the top lg bits of the 32-bit product key * 2654435761
//     (uint32_t wraparound, the same bits as the JAX bucket_of for
//     negative keys too). Lane l reads bucket lanes 4l..4l+3 of rid and key
//     as one 16-byte load each. Without verification it writes the
//     candidates and hit bits (the TPU kernel's contract). With it, the
//     whole IndexProbe route of an executor runs in the same launch, in
//     registers: each hit candidate's validity byte, key column and
//     residual terms' columns are gathered at once (one more dependent
//     load), ANDed with the caller's extra mask and active flag; the
//     match count is a warp sum. A match's place in row order is, in a
//     bucket built in one pass (rows in row order), the matches at lower
//     lanes: popcounts of four ballots, the order checked with one
//     shuffle; a bucket that insertions left out of order is ranked by
//     broadcasting the matches one by one (as many steps as matches). The
//     first `limit` row ids land at their places, zeros after the count.
//     What the executors did before in ~12 PyTorch launches (gathers,
//     compares, a 128-wide sort, the padding) is this one launch. The
//     kernel is compiled for 0 and for up to 8 residual terms: on an H100
//     the unrolled code of 8 unused terms cost a lone warp more than its
//     gathers did.
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

constexpr int PV_TERMS = 8;  // residual terms (core/planner.py MAX_RESIDUAL)

// residual terms of a verified probe: column [cap], operator code, the
// statements' values [w]
struct Terms {
  const int32_t* col[PV_TERMS];
  const int32_t* val[PV_TERMS];
  int op[PV_TERMS];
};

template <int OP>
__device__ __forceinline__ uint32_t cmp4_op(const int32_t (&x)[4], int32_t v) {
  uint32_t b = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) b |= (uint32_t)cmp_op<OP>(x[j], v) << j;
  return b;
}

// 4 compare bits (bit j: candidate j) of one term; one switch a term
__device__ __forceinline__ uint32_t cmp4(int op, const int32_t (&x)[4],
                                         int32_t v) {
  switch (op) {
    case OP_EQ: return cmp4_op<OP_EQ>(x, v);
    case OP_NE: return cmp4_op<OP_NE>(x, v);
    case OP_LT: return cmp4_op<OP_LT>(x, v);
    case OP_LE: return cmp4_op<OP_LE>(x, v);
    case OP_GT: return cmp4_op<OP_GT>(x, v);
    default:    return cmp4_op<OP_GE>(x, v);
  }
}

// bits 0-3 of b as the bytes 0/1 of a 32-bit word (byte j = bit j)
__device__ __forceinline__ uint32_t bits_to_bytes4(uint32_t b) {
  return ((b & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Grid: one warp per query key. verify = 0: cand = rid lanes, hit =
// occupied and stored key == query. verify = 1: cand = the lanes clamped
// to [0, cap) ("safe"), hit = verified matches ("ok"), count [w], and
// when limit > 0 ids [w, limit]: the matches' row ids in row order,
// 0-padded. NRES: residual terms compiled in (0, or PV_TERMS >= nres); the
// common probe without any is compiled without their code, which costs a
// warp alone on its SM more than a load does.
template <int NRES>
__global__ void __launch_bounds__(256)
probe_kernel(const int32_t* __restrict__ rid, const int32_t* __restrict__ key,
             const int32_t* __restrict__ qkeys, int w, int lg, int verify,
             const uint8_t* __restrict__ valid,
             const int32_t* __restrict__ keycol, Terms terms, int nres,
             const uint8_t* __restrict__ extra,
             const uint8_t* __restrict__ active, int cap, int limit,
             int32_t* __restrict__ cand, uint8_t* __restrict__ hit,
             int32_t* __restrict__ count, int32_t* __restrict__ ids) {
  const int q = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= w) return;
  const int32_t k = __ldg(qkeys + q);
  const uint32_t b = ((uint32_t)k * HX_PRIME) >> (32 - lg);
  const int4 r4 = __ldg(reinterpret_cast<const int4*>(rid + (size_t)b * HX_LANES) + lane);
  const int4 k4 = __ldg(reinterpret_cast<const int4*>(key + (size_t)b * HX_LANES) + lane);
  const int32_t r[4] = {r4.x, r4.y, r4.z, r4.w};
  const int32_t kk[4] = {k4.x, k4.y, k4.z, k4.w};
  uint32_t ok = 0;  // bit j: bucket lane 4 * lane + j
#pragma unroll
  for (int j = 0; j < 4; ++j) ok |= (uint32_t)(r[j] != HX_EMPTY && kk[j] == k) << j;
  int4* out = reinterpret_cast<int4*>(cand + (size_t)q * HX_LANES) + lane;
  uint32_t* out_hit = reinterpret_cast<uint32_t*>(hit + (size_t)q * HX_LANES) + lane;
  if (!verify) {
    *out = r4;
    *out_hit = bits_to_bytes4(ok);
    return;
  }

  int32_t sf[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sf[j] = min(max(r[j], 0), cap - 1);
  int32_t rv[NRES > 0 ? NRES : 1];
#pragma unroll
  for (int t = 0; t < NRES; ++t)
    if (t < nres) rv[t] = __ldg(terms.val[t] + q);
  if (active != nullptr && active[q] == 0) ok = 0;
  // the gathers of every hit candidate, all issued before the first test
  uint8_t vb[4] = {0, 0, 0, 0}, xb[4] = {1, 1, 1, 1};
  int32_t kc[4] = {0, 0, 0, 0}, rc[NRES > 0 ? NRES : 1][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ok >> j & 1) {
      vb[j] = __ldg(valid + sf[j]);
      kc[j] = __ldg(keycol + sf[j]);
      if (extra != nullptr) xb[j] = __ldg(extra + sf[j]);
#pragma unroll
      for (int t = 0; t < NRES; ++t)
        if (t < nres) rc[t][j] = __ldg(terms.col[t] + sf[j]);
    } else {
#pragma unroll
      for (int t = 0; t < NRES; ++t) rc[t][j] = 0;
    }
  }
  uint32_t pass = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    pass |= (uint32_t)(vb[j] != 0 && kc[j] == k && xb[j] != 0) << j;
  ok &= pass;
#pragma unroll
  for (int t = 0; t < NRES; ++t)
    if (t < nres) ok &= cmp4(terms.op[t], rc[t], rv[t]);
  *out = make_int4(sf[0], sf[1], sf[2], sf[3]);
  *out_hit = bits_to_bytes4(ok);
  const int n = __reduce_add_sync(0xffffffffu, __popc(ok));
  if (lane == 0) count[q] = n;
  if (limit <= 0) return;

  // place of each match in row order. A bucket built in one pass holds
  // its rows in row order, so there a match's place is the number of
  // matches at lower bucket lanes (4 * lane + j): popcounts of four
  // ballots. The order is checked (each lane's matches ascending, its
  // first no smaller than the last match below it, fetched from the
  // nearest lane below that has one); a bucket that insertions left out
  // of order is ranked by broadcasting its matches one by one instead
  // (ties of row id go by bucket lane, so places are distinct).
  int32_t* row = ids + (size_t)q * limit;
  if (n > 0) {
    unsigned bal[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bal[j] = __ballot_sync(0xffffffffu, ok >> j & 1);
    const unsigned lower = (1u << lane) - 1;
    int place[4];
    int r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) r += __popc(bal[j] & lower);
    bool sorted = true;
    int32_t first = -1, last = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      place[j] = r;
      if (ok >> j & 1) {
        sorted = sorted && last <= sf[j];
        first = first < 0 ? sf[j] : first;
        last = sf[j];
        ++r;
      }
    }
    const unsigned has = (bal[0] | bal[1] | bal[2] | bal[3]) & lower;
    const int32_t below =
        __shfl_sync(0xffffffffu, last, has ? 31 - __clz(has) : 0);
    if (has && first >= 0) sorted = sorted && below <= first;
    if (!__all_sync(0xffffffffu, sorted)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) place[j] = 0;
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        unsigned m = bal[j2];
        while (m) {  // warp-uniform: one step a match
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const int32_t v = __shfl_sync(0xffffffffu, sf[j2], src);
          const int c = 4 * src + j2;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            place[j] += v < sf[j] || (v == sf[j] && c < 4 * lane + j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((ok >> j & 1) && place[j] < limit) row[place[j]] = sf[j];
  }
  for (int p = min(n, limit) + lane; p < limit; p += 32) row[p] = 0;
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
// hit [w, 128] uint8 (the TPU kernel's contract). rid and key rows must
// start on 16 bytes.
REPRO_EXPORT int hash_probe(const void* rid, const void* key, const void* qkeys,
                            int w, int lg, void* cand, void* hit, void* stream) {
  if (w <= 0 || lg < 1 || lg > 31) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((size_t)w * 32 + kThreads - 1) / kThreads);
  Terms none = {};
  probe_kernel<0><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rid, (const int32_t*)key, (const int32_t*)qkeys, w, lg,
      0, nullptr, nullptr, none, 0, nullptr, nullptr, 1, 0, (int32_t*)cand,
      (uint8_t*)hit, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The verified probe: as hash_probe, then each candidate checked against
// valid [cap] uint8, keycol [cap] int32 (== the query key), nres residual
// terms (cols[t] [cap] int32, ops[t], vals[t] [w] int32), extra [cap]
// uint8 and active [w] uint8 (either may be null). Out: safe [w, 128]
// int32 (lanes clamped to [0, cap)), ok [w, 128] uint8, count [w] int32
// and, when limit > 0, ids [w, limit] int32 (matches in row order,
// 0-padded).
REPRO_EXPORT int hash_probe_verify(
    const void* rid, const void* key, const void* qkeys, int w, int lg,
    const void* valid, const void* keycol, const void* const* cols,
    const void* const* vals, const int* ops, int nres, const void* extra,
    const void* active, int cap, int limit, void* safe, void* ok,
    void* count, void* ids, void* stream) {
  if (w <= 0 || lg < 1 || lg > 31 || cap <= 0 || nres < 0 ||
      nres > PV_TERMS || limit < 0)
    return (int)cudaErrorInvalidValue;
  Terms terms = {};
  for (int t = 0; t < nres; ++t) {
    terms.col[t] = (const int32_t*)cols[t];
    terms.val[t] = (const int32_t*)vals[t];
    terms.op[t] = ops[t];
  }
  const int blocks = (int)(((size_t)w * 32 + kThreads - 1) / kThreads);
  auto kernel = nres == 0 ? probe_kernel<0> : probe_kernel<PV_TERMS>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rid, (const int32_t*)key, (const int32_t*)qkeys, w, lg,
      1, (const uint8_t*)valid, (const int32_t*)keycol, terms, nres,
      (const uint8_t*)extra, (const uint8_t*)active, cap, limit,
      (int32_t*)safe, (uint8_t*)ok, (int32_t*)count, (int32_t*)ids);
  return (int)cudaGetLastError();
}
