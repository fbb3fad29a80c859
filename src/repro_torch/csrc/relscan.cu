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
// The compaction reads the mask (1 byte a row: it returns the unclamped
// match count, so every byte is read) and writes `limit` row ids and the
// count: 0.04 us at cap 131,072, so its floor is one launch's latency.
//
// Design. The TPU kernel tiles 2048 rows into (16, 128) VMEM blocks and
// runs the grid in order, carrying the id output across grid steps. Here
// blocks run in any order on 132 SMs, so:
//   * scan: ONE launch gives the mask, the per-block counts and each
//     statement's total. A thread owns 8 consecutive rows: two 16-byte
//     loads a column and one 8-byte load of the validity bytes, all issued
//     before the first compare, and one 8-byte store of the mask. A warp
//     then covers exactly one 256-row block, so a block's count is one warp
//     reduction (__reduce_add_sync), written by lane 0: no shared memory
//     and no barrier on that path. The ragged tail, a cap that is not a
//     multiple of 8 and a mask row that does not start on 8 bytes (w > 1)
//     are handled row by row in the kernel, and a column (or the validity
//     vector) off its 16-byte (8-byte) alignment is read row by row: never
//     padded, copied or refused. The <= 4 operator codes are kernel
//     arguments, uniform across the grid, so the switch never diverges. A
//     CTA evaluates its rows for 8 statements (rows of the [w, nterms]
//     value matrix) from one load of the columns; grid.y covers the rest. Each statement's total comes from the same launch:
//     every CTA adds its count and its arrival to the statement's 64-bit
//     word in ONE atomic (count in the low half, arrivals in the high
//     half), and the CTA that arrives last writes the total and zeroes the
//     word. The words are the caller's scratch, zeroed once per device and
//     stream, never per call, and zero again after every launch, so a
//     CUDA graph replay finds them ready;
//   * compaction: ONE launch and no other device op (no prefix of block
//     counts, no zero fill): one CTA of 1024 threads per statement walks
//     its mask row in row order, 64 bytes a thread a step (four 16-byte
//     loads, the next step's loads in flight while this step is ranked),
//     turns the bytes into a 64-bit set-bit mask, ranks the counts with a
//     block-wide exclusive scan (warp shuffles + one shared-memory pass)
//     and writes row ids at base + rank < limit, where base carries the
//     matches of the steps before. Ids come out in row order with no
//     atomics and no cross-CTA state, so nothing needs initialising. The
//     CTA then writes the count and the zero padding [min(count, limit),
//     limit) itself. A row whose start is not 16-byte aligned (w > 1 at a
//     cap that is not a multiple of 16) is read from the aligned address
//     below it, the bytes outside the row masked off. One SM a statement
//     reads ~64 KiB a step: 2 steps at the main path's cap of 131,072,
//     64 at 4,194,304 (a decoupled look-back over many CTAs would spread
//     that; see PERF.md for the times of both caps);
//   * the compaction's grid runs w statements over their mask rows in one
//     launch, as the scan does: the batched SELECT / aggregate executors
//     use it; w = 1 is the TPU kernel's contract. A sharded table's
//     fan-out hands it the scan's [S * w, cap_s] mask, one row a (shard,
//     statement) pair, and gets each shard's first candidates;
//   * shard axis (sharded tables): the scan takes sid [n], the shard of
//     each (shard, statement) pair, and reads the columns of a [S, cap_s]
//     stack at base + sid * cap_s. One launch serves a fan-out (every
//     shard for every statement) or a micro-batch of pruned statements
//     (each on its own shard), with no gathered copy of a shard: the
//     counterpart of the TPU's vmap of the kernel over the stacked state.
//     A CTA takes `per` consecutive pairs (8 unsharded; with sid, the
//     caller's run of pairs on one shard, at most 8: a fan-out of w
//     statements lists its pairs shard by shard) and loads its rows again
//     only where the shard changes, so a one-statement fan-out spreads its
//     shards over CTAs instead of loading them one after another in one.
//     sid = null is the unsharded call.
#include "common.cuh"

namespace {

struct Cols { const int32_t* c[4]; };
struct Ops { int op[4]; };

// 8 rows a thread measured faster on an H100 than 16 (at 131,072 rows,
// 4,194,304 rows and 32 statements)
constexpr int SC_ROWS = 8;                       // rows a thread
constexpr int SC_THREADS = 256;                  // threads a CTA
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_TILE = SC_THREADS * SC_ROWS;    // rows a CTA: 8 blocks
// statements a CTA evaluates from one load of its rows; grid.y covers the
// rest (8 measured faster on an H100 than 1, 2, 4, 16 or 32 at w = 32)
constexpr int SC_STMTS = 8;
static_assert(32 * SC_ROWS == RS_BLOCK, "one warp covers one block");

template <int OP>
__device__ __forceinline__ uint32_t cmp_rows_op(const int32_t (&x)[SC_ROWS],
                                                int32_t v) {
  uint32_t b = 0;
#pragma unroll
  for (int j = 0; j < SC_ROWS; ++j) b |= (uint32_t)cmp_op<OP>(x[j], v) << j;
  return b;
}

// compare bits (bit j: row j) of one term over a thread's rows; the
// operator is uniform across the grid, so the switch never diverges
__device__ __forceinline__ uint32_t cmp_rows(int op,
                                             const int32_t (&x)[SC_ROWS],
                                             int32_t v) {
  switch (op) {
    case OP_EQ: return cmp_rows_op<OP_EQ>(x, v);
    case OP_NE: return cmp_rows_op<OP_NE>(x, v);
    case OP_LT: return cmp_rows_op<OP_LT>(x, v);
    case OP_LE: return cmp_rows_op<OP_LE>(x, v);
    case OP_GT: return cmp_rows_op<OP_GT>(x, v);
    default:    return cmp_rows_op<OP_GE>(x, v);
  }
}

// a thread's SC_ROWS rows [r0, r0 + 8) of the columns at off (a shard's
// first row) into x, and their validity as bits (bit j: row r0 + j, rows
// past cap invalid): two 16-byte loads a column and one 8-byte load of
// the validity bytes, all before the first compare; a ragged tail (or a
// column not on 16 bytes) is read row by row
__device__ __forceinline__ uint32_t load_rows(const Cols& cols,
                                              const uint8_t* __restrict__ valid,
                                              long long off, long long r0,
                                              int cap, int nterms, int vec,
                                              int32_t (&x)[4][SC_ROWS]) {
  uint32_t vbits = 0;
  if (vec && r0 + SC_ROWS <= cap) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < nterms) {
        const int4* p = reinterpret_cast<const int4*>(cols.c[t] + off + r0);
        const int4 a = __ldg(p), b = __ldg(p + 1);
        x[t][0] = a.x; x[t][1] = a.y; x[t][2] = a.z; x[t][3] = a.w;
        x[t][4] = b.x; x[t][5] = b.y; x[t][6] = b.z; x[t][7] = b.w;
      }
    }
    const uint2 vb = __ldg(reinterpret_cast<const uint2*>(valid + off + r0));
    vbits = nz_bits4(vb.x) | (nz_bits4(vb.y) << 4);
  } else {
#pragma unroll
    for (int j = 0; j < SC_ROWS; ++j) {
      const long long r = r0 + j;
      const bool in = r < cap;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (t < nterms) x[t][j] = in ? __ldg(cols.c[t] + off + r) : 0;
      vbits |= (uint32_t)(in && __ldg(valid + off + r) != 0) << j;
    }
  }
  return vbits;
}

// Grid (ceil(cap / SC_TILE), ceil(w / per)). Thread g of the grid's x
// axis owns rows [8 g, 8 g + 8), so warp v covers block v. acc [w]
// (uint64: matches so far | CTAs arrived << 32) is the caller's persistent
// scratch, zero between launches. SHARDED = 0: one table, its rows loaded
// once for the CTA's statements; SHARDED = 1: row q of vals reads shard
// sid[q], loaded again where the shard changes.
template <int SHARDED>
__global__ void __launch_bounds__(SC_THREADS)
scan_kernel(Cols cols, Ops ops, int nterms, const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ vals,
            const int32_t* __restrict__ sid, int per, int cap, int nblk,
            int w, int vec, uint8_t* __restrict__ mask,
            int32_t* __restrict__ cnt, int32_t* __restrict__ count,
            unsigned long long* __restrict__ acc) {
  __shared__ int part[SC_STMTS][SC_WARPS];
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * SC_THREADS + threadIdx.x) * SC_ROWS;
  const long long blk = r0 / RS_BLOCK;
  const int q0 = blockIdx.y * per;
  const int nq = min(per, w - q0);

  int32_t x[4][SC_ROWS];
  uint32_t vbits = 0;
  int shard = -1;  // the shard whose rows x / vbits hold (uniform)
  if (!SHARDED) vbits = load_rows(cols, valid, 0, r0, cap, nterms, vec, x);
  for (int i = 0; i < nq; ++i) {
    const int q = q0 + i;
    if (SHARDED) {
      const int s = __ldg(sid + q);
      if (s != shard) {
        shard = s;
        vbits = load_rows(cols, valid, (long long)s * cap, r0, cap, nterms,
                          vec, x);
      }
    }
    const int32_t* v = vals + (size_t)q * nterms;
    uint32_t bits = vbits;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < nterms) bits &= cmp_rows(ops.op[t], x[t], __ldg(v + t));
    uint8_t* m = mask + (size_t)q * cap + r0;
    if (r0 + SC_ROWS <= cap && ((uintptr_t)m & 7) == 0) {
      *reinterpret_cast<uint2*>(m) =
          make_uint2(bits_to_bytes4(bits), bits_to_bytes4(bits >> 4));
    } else {
#pragma unroll
      for (int j = 0; j < SC_ROWS; ++j)
        if (r0 + j < cap) m[j] = (bits >> j) & 1;
    }
    // the block's count: one warp reduction
    const int c = __reduce_add_sync(0xffffffffu, __popc(bits));
    if (lane == 0) {
      if (blk < nblk) cnt[(size_t)q * nblk + blk] = c;
      part[i][threadIdx.x >> 5] = c;
    }
  }

  // the statement's total: each CTA adds its count and its arrival to the
  // statement's word in one atomic; the CTA that arrives last writes the
  // total and zeroes the word for the next launch (so a CUDA graph replay
  // also finds it zero)
  __syncthreads();
  if (threadIdx.x < nq) {
    const int i = threadIdx.x;
    int s = 0;
#pragma unroll
    for (int p = 0; p < SC_WARPS; ++p) s += part[i][p];
    unsigned long long* a = acc + q0 + i;
    const unsigned long long old =
        atomicAdd(a, (1ull << 32) | (unsigned long long)(unsigned)s);
    if ((old >> 32) == gridDim.x - 1) {
      count[q0 + i] = (int32_t)(uint32_t)old + s;
      *a = 0ull;
    }
  }
}

constexpr int CP_THREADS = 256;                    // threads a CTA
constexpr int CP_BYTES = 64;                       // mask bytes a thread
constexpr int CP_TILE = CP_THREADS * CP_BYTES;     // 16 KiB of a row a CTA
constexpr unsigned long long CP_AGG = 1;           // flag: tile's own count
constexpr unsigned long long CP_PREFIX = 2;        // flag: inclusive prefix
constexpr unsigned long long CP_VALUE = (1ull << 30) - 1;

// the four 16-byte chunks [c0, c0 + 4) of a row, zeros past nchunks
__device__ __forceinline__ void load_chunks(uint4 (&c)[4], const uint4* base,
                                            long long c0, long long nchunks) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    c[j] = c0 + j < nchunks ? __ldg(base + c0 + j) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint64_t chunk_bits(const uint4 (&c)[4]) {
  uint64_t b = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b |= (uint64_t)nz_bits4(c[j].x) << (16 * j);
    b |= (uint64_t)nz_bits4(c[j].y) << (16 * j + 4);
    b |= (uint64_t)nz_bits4(c[j].z) << (16 * j + 8);
    b |= (uint64_t)nz_bits4(c[j].w) << (16 * j + 12);
  }
  return b;
}

// bits of the 64 positions from vbase that lie inside the row [head, vlen)
__device__ __forceinline__ uint64_t row_bits(long long vbase, int head,
                                             long long vlen) {
  if (vbase >= head && vbase + CP_BYTES <= vlen) return ~0ull;
  const long long lo = head > vbase ? head - vbase : 0;
  const long long hi = vlen - vbase < CP_BYTES ? vlen - vbase : CP_BYTES;
  if (hi <= lo) return 0ull;
  const uint64_t below_hi = hi >= CP_BYTES ? ~0ull : (1ull << hi) - 1;
  return below_hi & ~((1ull << lo) - 1);
}

// exclusive prefix of x over the CTA's threads; total = sum
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot,
                                                    int& total) {
  constexpr int NW = CP_THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int t = warp_tot[i];
    before += i < warp ? t : 0;
    total += t;
  }
  return before + incl - x;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Grid (nblk, w): CTA (blk, q) owns bytes [blk * CP_TILE, +CP_TILE) of
// row q. ctl = {epoch, CTAs done}; flags [w, nblk] are words
// epoch << 32 | status << 30 | value, published with release stores.
__global__ void __launch_bounds__(CP_THREADS)
compact_kernel(const uint8_t* __restrict__ mask, long long row_stride, int cap,
               int limit, int nblk, int32_t* __restrict__ ids,
               int32_t* __restrict__ count, unsigned int* ctl,
               unsigned long long* flags) {
  __shared__ int warp_tot[CP_THREADS / 32];
  __shared__ unsigned int s_epoch;
  __shared__ int s_before;
  const int blk = blockIdx.x;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) s_epoch = *reinterpret_cast<volatile unsigned int*>(ctl);

  const uintptr_t addr = (uintptr_t)(mask + (long long)q * row_stride);
  const int head = (int)(addr & 15);  // row start past a 16-byte boundary
  const uint4* base = reinterpret_cast<const uint4*>(addr - head);
  const long long vlen = (long long)head + cap;  // positions [head, vlen)
  const long long nchunks = cap > 0 ? (vlen + 15) / 16 : 0;
  const long long vbase = ((long long)blk * CP_THREADS + tid) * CP_BYTES;
  uint4 c[4];
  load_chunks(c, base, vbase / 16, nchunks);
  uint64_t bits = chunk_bits(c) & row_bits(vbase, head, vlen);
  int total;
  const int rank0 = block_exclusive_scan(__popcll(bits), warp_tot, total);

  // this tile's count goes out at once (its inclusive prefix when it is
  // the row's first tile); warp 0 then sums its predecessors' flags, 32 at
  // a time, back to the nearest one that holds an inclusive prefix
  const unsigned long long tag = (unsigned long long)s_epoch << 32;
  unsigned long long* fl = flags + (long long)q * nblk;
  if (tid == 0)
    st_release(fl + blk, tag | ((blk ? CP_AGG : CP_PREFIX) << 30) | total);
  if (tid < 32) {
    int before = 0;
    for (int i = blk - 1; i >= 0; i -= 32) {
      const int p = i - tid;
      unsigned long long f = CP_PREFIX << 30;  // before the row: prefix 0
      if (p >= 0) {
        do {
          f = ld_acquire(fl + p);
        } while ((f >> 32) != s_epoch || ((f >> 30) & 3) == 0);
      }
      const unsigned prefix = __ballot_sync(0xffffffffu,
                                            ((f >> 30) & 3) == CP_PREFIX);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;
      int v = tid <= stop ? (int)(f & CP_VALUE) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      before += v;
      if (prefix) break;
    }
    if (tid == 0) {
      if (blk) st_release(fl + blk, tag | (CP_PREFIX << 30) | (before + total));
      s_before = before;
    }
  }
  __syncthreads();
  const int before = s_before;

  int32_t* out = ids + (long long)q * limit;
  int rank = before + rank0;
  while (bits && rank < limit) {
    const int i = __ffsll((long long)bits) - 1;
    bits &= bits - 1;
    out[rank++] = (int32_t)(vbase + i - head);
  }
  if (blk == nblk - 1) {  // the row's last tile knows its count
    const int n = before + total;
    for (int p = min(n, limit) + tid; p < limit; p += CP_THREADS) out[p] = 0;
    if (tid == 0) count[q] = n;
  }
  // the launch's last CTA moves the epoch on (atomicInc wraps the done
  // count back to 0), so the next launch ignores these flags
  if (tid == 0) {
    __threadfence();
    const unsigned int n_cta = gridDim.x * gridDim.y;
    if (atomicInc(ctl + 1, n_cta - 1) == n_cta - 1) atomicAdd(ctl, 1u);
  }
}

}  // namespace

// mask [w, cap] uint8, cnt [w, nblk] int32 (nblk = ceil(cap / 256)) and
// count [w] int32 out; vals [w, nterms] int32. sid [w] int32 (or null):
// the shard of row q of vals; then the columns and valid are [S, cap]
// stacks and row q reads shard sid[q], and per (1-8) is the number of
// rows a CTA takes (ignored without sid). acc (>= w uint64) is the caller's
// persistent scratch, zeroed once when allocated and used by one
// stream's launches only.
REPRO_EXPORT int relscan_scan(const void* c0, const void* c1, const void* c2,
                              const void* c3, int op0, int op1, int op2, int op3,
                              int nterms, const void* valid, const void* vals,
                              const void* sid, int per, int cap, int w,
                              void* mask,
                              void* cnt, void* count, void* acc,
                              void* stream) {
  if (sid == nullptr) per = SC_STMTS;
  if (cap <= 0 || w <= 0 || nterms < 1 || nterms > 4 || per < 1 ||
      per > SC_STMTS)
    return (int)cudaErrorInvalidValue;
  const int nblk = (cap + RS_BLOCK - 1) / RS_BLOCK;
  const void* cs[4] = {c0, c1, c2, c3};
  // a shard's rows start on 16 (8) bytes when its base does and cap is a
  // multiple of 8
  int vec = ((uintptr_t)valid & 7) == 0 && (sid == nullptr || cap % 8 == 0);
  for (int t = 0; t < nterms; ++t) vec &= ((uintptr_t)cs[t] & 15) == 0;
  Cols cols = {{(const int32_t*)c0, (const int32_t*)c1, (const int32_t*)c2,
                (const int32_t*)c3}};
  Ops ops = {{op0, op1, op2, op3}};
  dim3 grid((cap + SC_TILE - 1) / SC_TILE, (w + per - 1) / per);
  auto kernel = sid != nullptr ? scan_kernel<1> : scan_kernel<0>;
  kernel<<<grid, SC_THREADS, 0, (cudaStream_t)stream>>>(
      cols, ops, nterms, (const uint8_t*)valid, (const int32_t*)vals,
      (const int32_t*)sid, per, cap, nblk, w, vec, (uint8_t*)mask, (int32_t*)cnt, (int32_t*)count,
      (unsigned long long*)acc);
  return (int)cudaGetLastError();
}

// mask [w, cap] uint8 (row q at mask + q * row_stride bytes, bytes
// contiguous) -> ids [w, limit] int32 (the first `limit` set bytes of each
// row as row ids, in row order, 0-padded) and count [w] int32 (unclamped).
// ctl (2 x uint32) and flags (>= w * ceil((cap + 15) / 16 KiB) uint64) are
// the caller's persistent scratch, zeroed once when allocated and used by
// one stream's launches only.
REPRO_EXPORT int relscan_compact(const void* mask, long long row_stride,
                                 int cap, int w, int limit, void* ids,
                                 void* count, void* ctl, void* flags,
                                 void* stream) {
  if (w <= 0 || limit <= 0 || cap < 0 || (long long)cap > (long long)CP_VALUE)
    return (int)cudaErrorInvalidValue;
  const int nblk = (int)(((long long)cap + 15 + CP_TILE - 1) / CP_TILE);
  const int n = nblk > 0 ? nblk : 1;
  compact_kernel<<<dim3(n, w), CP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, row_stride, cap, limit, n, (int32_t*)ids,
      (int32_t*)count, (unsigned int*)ctl, (unsigned long long*)flags);
  return (int)cudaGetLastError();
}
