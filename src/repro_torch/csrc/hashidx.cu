// Bucketed hash index: bulk build and batched probe.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/hashidx.py:
//   hash_build  <- _build_kernel (hashidx.py:133, launched at :167)
//   hash_probe  <- _probe_kernel (hashidx.py:207, launched at :237)
//
// What bounds them on an H100: memory, and at the daemon's sizes launch
// latency. The build reads the keys and their validity (5 bytes a row)
// and writes the [n_buckets, 128] rid and key arrays (4.2 MB for 4,096
// buckets): ~1.45 us at 3.35 TB/s for 131,072 rows. A probe of w keys
// reads w * 128 lanes of rid and key (~1 KB for w = 1), and with
// verification gathers the candidates' rows: a chain of three dependent
// loads (the key, its bucket, the candidates' rows), so its floor is one
// launch's latency.
//
// Design. The TPU grouped rows by bucket with an XLA sort and gathered
// each bucket's segment; a general sort costs ~100x the gather here. The
// key space of a build is only n_buckets and a bucket keeps 128 rows, so
// the build is a counting sort in two launches, with no sort, memset or
// copy around them:
//   * build, pass 1 (rows): a thread a row; a valid row takes the next
//     slot of its bucket from a per-bucket counter (one per 32-byte
//     sector), one atomic per bucket and warp (__match_any_sync groups
//     the warp's rows of a bucket, the slot is the group's base plus the
//     row's rank in the group), and a slot under 128 stages the pair
//     (row, key) as one 8-byte store into the outputs' own row b (slots
//     0-63 in rid, 64-127 in key). Rows past 128 slots add to the
//     overflow word; the row that takes slot 128 lists its bucket.
//   * build, pass 2 (buckets): a warp reads a bucket's count with its
//     first 32 staged pairs and zeroes the counter. A bucket of n <= 128
//     rows ranks its staged pairs by row id (each lane holds up to 4, the
//     n row ids broadcast one by one), lays rid / key out in shared
//     memory at their ranks, EMPTY / 0 after n, and stores each row with
//     one 16-byte store a lane: the order the atomics handed out never
//     reaches the output. A bucket
//     of n > 128 must hold its 128 LOWEST rows, which the atomics did not
//     keep. 64 more CTAs at the front of the grid serve the listed
//     buckets: a bucket's rows are split into 64 / (listed buckets)
//     chunks, a CTA walks its chunk in row order (4,096 rows a step, a
//     block-wide exclusive scan places each row of the bucket, the step
//     that reaches the chunk's 128th row is the last), and the chunk CTA
//     that arrives last concatenates the chunks' rows up to 128. A walk
//     reads 5 bytes a row of keys / valid, which stay in L2 after pass 1.
//     CTA 0 writes the overflow and zeroes its word.
//   The counters, the overflow word, the list's length and the arrival
//   counts are the caller's scratch, zeroed once when allocated and zero
//   again after every call, so a CUDA graph replay finds them ready.
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
//   * shard axis (sharded tables; the TPU ran both kernels under a vmap
//     over the stacked shards). The build takes S shards of cap_s rows
//     ([S, cap_s] keys and validity) and writes [S, nb, 128] rid / key
//     and overflow [S] in the same two launches: pass 1 runs over the
//     S * cap_s rows and a row's bucket is (shard, bucket), so the
//     counters, the list of buckets over 128 rows and the walks are per
//     (shard, bucket) and a walk reads its own shard's rows; row ids stay
//     the shard's own. The probe takes sid [w], the shard of each query:
//     its bucket row is read from shard sid's index and its candidates
//     from shard sid's rows, so one launch probes every shard of a
//     fan-out, or each pruned statement of a micro-batch on its shard.
#include "common.cuh"

namespace {

constexpr int BR_THREADS = 256;            // pass 1: threads a CTA (a row each)
constexpr int BB_THREADS = 512;            // pass 2: threads a CTA
constexpr int BB_WARPS = BB_THREADS / 32;  // pass 2: buckets a CTA
constexpr int BW_CTAS = 64;                // pass 2: CTAs for buckets over 128
// pass 2: bucket CTAs; with the walk CTAs 3 an SM on an H100's 132 SMs,
// so the whole grid is resident at once
constexpr int BN_CTAS = 3 * 132 - BW_CTAS;
// ints between two bucket counters: one counter a 32-byte sector, so the
// atomics of a line's buckets do not queue behind each other in L2
constexpr int HX_CNT_STRIDE = 8;
constexpr int BW_ROWS = 8;                 // a walk: rows a thread a step
constexpr int BW_STEP = BB_THREADS * BW_ROWS;
constexpr int HX_HALF = HX_LANES / 2;      // staged pairs a row holds

// The build's scratch. Zero between calls (each call leaves them zero):
// the overflow list's length, the walk CTAs' arrival count, one arrival
// count per listed bucket, the overflow words (one a shard), the bucket
// counters. Free between calls: the list of buckets over 128 rows and the
// walk CTAs' first rows (row ids, keys, how many). A bucket is numbered
// shard * nb + bucket throughout.
struct BuildScratch {
  int* acc;             // [S]
  int* list_n;
  unsigned* arrive_all;
  unsigned* arrive;     // [BW_CTAS]
  int* cnt;             // [S * nb * HX_CNT_STRIDE]
  int* list;            // [max(S * nb, BW_CTAS)]
  int* chunk_rows;      // [BW_CTAS][128]
  int* chunk_keys;      // [BW_CTAS][128]
  int* chunk_n;         // [BW_CTAS]
};

// a key's bucket: the top lg bits of the 32-bit product (sh = 32 - lg)
__device__ __forceinline__ uint32_t bucket_id(int32_t k, int sh) {
  return ((uint32_t)k * HX_PRIME) >> sh;
}

// rows [r0, r0 + 8) of keys, and their validity as bits (bit j: row
// r0 + j, rows from `end` on invalid); vec: keys on 16 bytes, valid on 8
__device__ __forceinline__ uint32_t load_rows8(const int32_t* __restrict__ keys,
                                               const uint8_t* __restrict__ valid,
                                               long long r0, long long end,
                                               int vec, int32_t (&k)[8]) {
  uint32_t vb = 0;
  if (vec && r0 + 8 <= end) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(keys + r0));
    const int4 c = __ldg(reinterpret_cast<const int4*>(keys + r0) + 1);
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    k[4] = c.x; k[5] = c.y; k[6] = c.z; k[7] = c.w;
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(valid + r0));
    vb = nz_bits4(v.x) | (nz_bits4(v.y) << 4);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long r = r0 + j;
      const bool in = r < end;
      k[j] = in ? __ldg(keys + r) : 0;
      vb |= (uint32_t)(in && __ldg(valid + r) != 0) << j;
    }
  }
  return vb;
}

// Pass 1. Grid: ceil(S * cap / 256) CTAs, a thread a row of the S shards
// (one row a thread measured faster on an H100 than 2 or 4: more warps
// hide the atomic's round trip).
__global__ void __launch_bounds__(BR_THREADS)
build_rows_kernel(const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ valid, int cap, int nsh,
                  int sh, int nb, int32_t* __restrict__ rid,
                  int32_t* __restrict__ key, BuildScratch sc) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * BR_THREADS + threadIdx.x;
  // 32-bit division (the host keeps nsh * cap below 2^31), none unsharded
  const int shard = nsh == 1 ? (g >= cap ? 1 : 0)
                             : (int)((unsigned)g / (unsigned)cap);
  const long long row = g - (long long)shard * cap;
  int32_t k = 0;
  bool in = false;
  if (shard < nsh) {  // both loads in flight together
    k = __ldg(keys + g);
    in = __ldg(valid + g) != 0;
  }
  // an invalid row carries an id no bucket has, and takes no slot
  const uint32_t b =
      in ? (uint32_t)shard * nb + bucket_id(k, sh) : 0xFFFFFFFFu;
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (in && lane == leader)
    base = atomicAdd(sc.cnt + (size_t)b * HX_CNT_STRIDE, __popc(peers));
  const int slot = __shfl_sync(0xffffffffu, base, leader) +
                   __popc(peers & ((1u << lane) - 1));
  int over = 0;
  if (in) {
    if (slot < HX_LANES) {
      int32_t* r = (slot < HX_HALF ? rid : key) + (size_t)b * HX_LANES;
      reinterpret_cast<int2*>(r)[slot & (HX_HALF - 1)] =
          make_int2((int32_t)row, k);
    } else {
      over = 1;
      if (slot == HX_LANES)  // once per bucket: the row that fills it up
        sc.list[atomicAdd(sc.list_n, 1)] = (int)b;
    }
  }
  // one atomic per shard and warp (a warp may span two shards)
  if (__ballot_sync(0xffffffffu, over)) {
    const unsigned peers_s =
        __match_any_sync(0xffffffffu, over ? (unsigned)shard : 0xFFFFFFFFu);
    if (over && lane == __ffs(peers_s) - 1)
      atomicAdd(sc.acc + shard, __popc(peers_s));
  }
}

// The first 128 rows of bucket b in [lo, hi), in row order, into rrow /
// krow (row ids, keys); returns how many there are, at most 128. The CTA
// walks BW_STEP rows a step; a block-wide exclusive scan of each thread's
// matches gives every match its place, and the walk ends with the step
// that reaches the 128th. tot: two buffers of warp totals, alternating by
// step, so a step takes two barriers.
__device__ __forceinline__ int walk_rows(
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    int vec, int sh, uint32_t b, long long lo, long long hi, int32_t* rrow,
    int32_t* krow, int (*tot)[BB_WARPS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int found = 0;  // uniform: rows of b in the steps before
  for (long long base = lo, step = 0; found < HX_LANES && base < hi;
       base += BW_STEP, ++step) {
    const long long r0 = base + (long long)threadIdx.x * BW_ROWS;
    int32_t k[BW_ROWS];
    uint32_t m = load_rows8(keys, valid, r0, hi, vec, k);
#pragma unroll
    for (int j = 0; j < BW_ROWS; ++j)
      if (bucket_id(k[j], sh) != b) m &= ~(1u << j);
    const int c = __popc(m);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int* t = tot[step & 1];
    if (lane == 31) t[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int x = lane < BB_WARPS ? t[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < BB_WARPS) t[lane] = x;  // inclusive prefix over warps
    }
    __syncthreads();
    int place = found + (warp ? t[warp - 1] : 0) + incl - c;
    while (m && place < HX_LANES) {
      const int j = __ffs((int)m) - 1;
      m &= m - 1;
      rrow[place] = (int32_t)(r0 + j);
      krow[place] = k[j];
      ++place;
    }
    found += t[BB_WARPS - 1];
  }
  __syncthreads();  // the next walk reuses tot
  return min(found, HX_LANES);
}

// rank[i] = the staged row ids below r[i] (row ids are distinct), for the
// NR registers a lane holds (n <= 32 NR); n row ids broadcast one by one
template <int NR>
__device__ __forceinline__ void rank_staged(const int32_t (&r)[4], int n,
                                            int (&rank)[4]) {
#pragma unroll
  for (int i2 = 0; i2 < NR; ++i2) {
    const int m = min(32, n - 32 * i2);
    for (int src = 0; src < m; ++src) {
      const int32_t v = __shfl_sync(0xffffffffu, r[i2], src);
#pragma unroll
      for (int i = 0; i < NR; ++i) rank[i] += v < r[i];
    }
  }
}

// serve_overflow's walks and merges: nl listed buckets, the first
// BW_CTAS of them in s_list
__device__ __forceinline__ void serve_listed(
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    int cap, int vec, int sh, int nb, int32_t* __restrict__ rid,
    int32_t* __restrict__ key, const BuildScratch& sc, int (*tot)[BB_WARPS],
    int nl, const int* s_list) {
  __shared__ int s_pref[BW_CTAS + 1];
  __shared__ int s_last;
  const int g = nl > 0 && nl <= BW_CTAS ? BW_CTAS / nl : 1;
  if (g == 1) {
    for (int i = blockIdx.x; i < nl; i += BW_CTAS) {
      const uint32_t ob = (uint32_t)(i < BW_CTAS ? s_list[i] : sc.list[i]);
      const long long off = (long long)(ob / nb) * cap;  // the shard's rows
      walk_rows(keys + off, valid + off, vec, sh, ob % nb, 0, cap,
                rid + (size_t)ob * HX_LANES, key + (size_t)ob * HX_LANES,
                tot);
    }
    return;
  }
  const int i = blockIdx.x / g;
  const int e = blockIdx.x % g;
  if (i >= nl) return;
  const uint32_t ob = (uint32_t)s_list[i];
  const long long off = (long long)(ob / nb) * cap;
  const long long steps = (cap + BW_STEP - 1) / BW_STEP;
  const long long per = (steps + g - 1) / g;
  const long long lo = min((long long)cap, e * per * BW_STEP);
  const long long hi = min((long long)cap, lo + per * BW_STEP);
  const int own = blockIdx.x;  // this CTA's chunk buffers
  const int n = walk_rows(keys + off, valid + off, vec, sh, ob % nb, lo, hi,
                          sc.chunk_rows + own * HX_LANES,
                          sc.chunk_keys + own * HX_LANES, tot);
  if (threadIdx.x == 0) sc.chunk_n[own] = n;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(sc.arrive + i, (unsigned)g - 1) == (unsigned)g - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int c0 = i * g;  // the bucket's first chunk CTA
  if (threadIdx.x < g) s_pref[threadIdx.x + 1] = __ldcg(sc.chunk_n + c0 + threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    s_pref[0] = 0;
    for (int c = 1; c <= g; ++c) s_pref[c] += s_pref[c - 1];
  }
  __syncthreads();
  int32_t* rrow = rid + (size_t)ob * HX_LANES;
  int32_t* krow = key + (size_t)ob * HX_LANES;
  for (int x = threadIdx.x; x < g * HX_LANES; x += BB_THREADS) {
    const int c = x / HX_LANES, t = x % HX_LANES;
    if (t < s_pref[c + 1] - s_pref[c] && s_pref[c] + t < HX_LANES) {
      rrow[s_pref[c] + t] = __ldcg(sc.chunk_rows + c0 * HX_LANES + x);
      krow[s_pref[c] + t] = __ldcg(sc.chunk_keys + c0 * HX_LANES + x);
    }
  }
}

// A bucket of n > 128 rows (list entry i of K) by the BW_CTAS walk CTAs:
// with K <= BW_CTAS, G = BW_CTAS / K CTAs split the rows into G chunks,
// each finds its chunk's first 128 rows of the bucket, and the CTA that
// arrives last (atomicInc on the bucket's arrival count, which wraps to
// 0) concatenates the chunks' rows in chunk order up to 128; with more
// buckets, each CTA walks whole buckets alone. The list is loaded beside
// its length (one L2 round trip for both).
__device__ __forceinline__ void serve_overflow(
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    int cap, int vec, int sh, int nb, int32_t* __restrict__ rid,
    int32_t* __restrict__ key, const BuildScratch& sc, int (*tot)[BB_WARPS]) {
  __shared__ int s_list[BW_CTAS];
  if (threadIdx.x < BW_CTAS) s_list[threadIdx.x] = sc.list[threadIdx.x];
  const int nl = *sc.list_n;  // pass 1 has ended: the list is whole
  __syncthreads();
  // the walk CTA that reads the list last zeroes its length; the atomic's
  // answer is waited for only at the end, so its round trip overlaps
  unsigned arrived = 0;
  if (threadIdx.x == 0) arrived = atomicInc(sc.arrive_all, BW_CTAS - 1);
  serve_listed(keys, valid, cap, vec, sh, nb, rid, key, sc, tot, nl, s_list);
  if (threadIdx.x == 0 && arrived == BW_CTAS - 1) *sc.list_n = 0;
}

// Pass 2. Grid: BW_CTAS + min(ceil(S * nb / 16), BN_CTAS) CTAs. The first
// BW_CTAS serve the buckets over 128 rows (serve_overflow) and then leave
// the list and their arrival count zero. In the others each warp takes
// buckets b, b + stride, ... of the S * nb (buckets >= 2^lg of a shard
// took no row), with the next bucket's count loaded ahead: it zeroes the
// counter and, if the bucket has at most 128 rows, orders them, lays the
// rows out in shared memory and stores each of rid's and key's rows as
// one 16-byte store a lane.
__global__ void __launch_bounds__(BB_THREADS, 3)
build_buckets_kernel(const int32_t* __restrict__ keys,
                     const uint8_t* __restrict__ valid, int cap, int nsh,
                     int vec, int sh, int nb, int32_t* __restrict__ rid,
                     int32_t* __restrict__ key, BuildScratch sc,
                     int32_t* __restrict__ overflow) {
  __shared__ int tot[2][BB_WARPS];
  __shared__ int4 stage[BB_WARPS][2][HX_LANES / 4];  // a warp's rid, key rows
  if (blockIdx.x < BW_CTAS) {
    if (blockIdx.x == 0) {  // pass 1 has ended
      for (int i = threadIdx.x; i < nsh; i += BB_THREADS) {
        overflow[i] = sc.acc[i];
        sc.acc[i] = 0;
      }
    }
    serve_overflow(keys, valid, cap, vec, sh, nb, rid, key, sc, tot);
    return;
  }
  nb *= nsh;  // from here on a bucket is numbered shard * nb + bucket
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = (gridDim.x - BW_CTAS) * BB_WARPS;
  int* srid = reinterpret_cast<int*>(stage[warp][0]);
  int* skey = reinterpret_cast<int*>(stage[warp][1]);
  int b = (blockIdx.x - BW_CTAS) * BB_WARPS + warp;
  // a bucket's count and its first 32 staged pairs are loaded together
  // (most buckets hold at most 32 rows), the next bucket's ahead of time;
  // pairs past the count are never used
  int n_next = 0;
  int2 v0_next = make_int2(0, 0);
  if (b < nb) {
    if (lane == 0) n_next = sc.cnt[(size_t)b * HX_CNT_STRIDE];
    v0_next = reinterpret_cast<const int2*>(rid + (size_t)b * HX_LANES)[lane];
  }
  for (; b < nb; b += stride) {
    const int n = __shfl_sync(0xffffffffu, n_next, 0);
    const int2 v0 = v0_next;
    const int bn = b + stride;
    if (lane == 0) sc.cnt[(size_t)b * HX_CNT_STRIDE] = 0;
    if (bn < nb) {
      if (lane == 0) n_next = sc.cnt[(size_t)bn * HX_CNT_STRIDE];
      v0_next = reinterpret_cast<const int2*>(rid + (size_t)bn * HX_LANES)[lane];
    }
    if (n > HX_LANES) continue;  // a walk CTA writes this bucket
    int32_t* rrow = rid + (size_t)b * HX_LANES;
    int32_t* krow = key + (size_t)b * HX_LANES;
    // staged slot p = lane + 32 i: i = 0, 1 in rid's row, 2, 3 in key's
    int32_t r[4], kv[4];
    int rank[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = lane + 32 * i;
      r[i] = 0x7fffffff;
      kv[i] = 0;
      rank[i] = 0;
      if (p < n) {
        const int2 v = i == 0 ? v0 : reinterpret_cast<const int2*>(
            i < 2 ? rrow : krow)[p & (HX_HALF - 1)];
        r[i] = v.x;
        kv[i] = v.y;
      }
    }
    switch ((n + 31) >> 5) {
      case 1: rank_staged<1>(r, n, rank); break;
      case 2: rank_staged<2>(r, n, rank); break;
      case 3: rank_staged<3>(r, n, rank); break;
      case 4: rank_staged<4>(r, n, rank); break;
      default: break;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = lane + 32 * i;
      if (p < n) {
        srid[rank[i]] = r[i];
        skey[rank[i]] = kv[i];
      } else {
        srid[p] = HX_EMPTY;
        skey[p] = 0;
      }
    }
    __syncwarp();  // the rows are laid out (and every staged pair was read)
    reinterpret_cast<int4*>(rrow)[lane] = stage[warp][0][lane];
    reinterpret_cast<int4*>(krow)[lane] = stage[warp][1][lane];
    __syncwarp();  // before the next bucket's layout
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

// Grid: one warp per query key. verify = 0: cand = rid lanes, hit =
// occupied and stored key == query. verify = 1: cand = the lanes clamped
// to [0, cap) ("safe"), hit = verified matches ("ok"), count [w], and
// when limit > 0 ids [w, limit]: the matches' row ids in row order,
// 0-padded. sid [w] (or null): query q reads shard sid[q]'s index
// (2^lg buckets a shard) and shard sid[q]'s rows (cap a shard). NRES: residual terms compiled in (0, or PV_TERMS >= nres); the
// common probe without any is compiled without their code, which costs a
// warp alone on its SM more than a load does.
template <int NRES>
__global__ void __launch_bounds__(256)
probe_kernel(const int32_t* __restrict__ rid, const int32_t* __restrict__ key,
             const int32_t* __restrict__ qkeys,
             const int32_t* __restrict__ sid, int w, int lg, int verify,
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
  const long long s = sid != nullptr ? __ldg(sid + q) : 0;
  const size_t b = ((size_t)s << lg) + (((uint32_t)k * HX_PRIME) >> (32 - lg));
  const int4 r4 = __ldg(reinterpret_cast<const int4*>(rid + b * HX_LANES) + lane);
  const int4 k4 = __ldg(reinterpret_cast<const int4*>(key + b * HX_LANES) + lane);
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
  const long long off = s * cap;  // shard s's rows
  valid += off;
  keycol += off;
  if (extra != nullptr) extra += off;
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
        if (t < nres) rc[t][j] = __ldg(terms.col[t] + off + sf[j]);
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

constexpr int kThreads = 256;  // 8 warps = 8 queries a block

}  // namespace

// Ints of the build's two scratch buffers for nsh shards of nb buckets:
// the one that must be zero when a call starts (and is zero again after
// it) and the one whose contents do not matter.
REPRO_EXPORT long long hash_build_scratch(int nb, int nsh, int zeroed) {
  const long long nbt = (long long)nb * nsh;
  return zeroed ? 2 + BW_CTAS + nsh + (long long)HX_CNT_STRIDE * nbt
                : 2LL * BW_CTAS * HX_LANES + BW_CTAS +
                      (nbt > BW_CTAS ? nbt : BW_CTAS);
}

// keys [nsh, cap] int32, valid [nsh, cap] uint8 -> rid / key
// [nsh, nb, 128] int32 (each shard's buckets: the first 128 valid rows of
// the shard in row order, as the shard's own row ids, EMPTY / 0 after)
// and overflow [nsh] int32 (each shard's rows past 128 over its buckets).
// nsh = 1 is the unsharded build. zeroed and free are the caller's
// scratch (hash_build_scratch ints each), used by one stream's launches
// only; zeroed is zero when allocated, and the two launches leave it
// zero. rid and key must start on 8 bytes.
REPRO_EXPORT int hash_build(const void* keys, const void* valid, int nsh,
                            int cap, int nb, void* rid, void* key,
                            void* overflow, void* zeroed, void* free,
                            void* stream) {
  if (cap < 0 || nb < 2 || nsh < 1 || (long long)nsh * cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int lg = 31 - __builtin_clz((unsigned)nb);  // bit_length(nb) - 1
  int* z = (int*)zeroed;
  int* f = (int*)free;
  BuildScratch sc;
  sc.list_n = z;
  sc.arrive_all = (unsigned*)(z + 1);
  sc.arrive = (unsigned*)(z + 2);
  sc.acc = z + 2 + BW_CTAS;
  sc.cnt = z + 2 + BW_CTAS + nsh;
  sc.chunk_rows = f;
  sc.chunk_keys = f + BW_CTAS * HX_LANES;
  sc.chunk_n = f + 2 * BW_CTAS * HX_LANES;
  sc.list = f + 2 * BW_CTAS * HX_LANES + BW_CTAS;
  // a shard's rows start on 16 (8) bytes when the base does and cap is a
  // multiple of 8
  const int vec = ((uintptr_t)keys & 15) == 0 && ((uintptr_t)valid & 7) == 0 &&
                  (nsh == 1 || cap % 8 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)nsh * cap;
  if (rows > 0) {
    build_rows_kernel<<<(unsigned)((rows + BR_THREADS - 1LL) / BR_THREADS),
                        BR_THREADS, 0, s>>>(
        (const int32_t*)keys, (const uint8_t*)valid, cap, nsh, 32 - lg, nb,
        (int32_t*)rid, (int32_t*)key, sc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long bucket_ctas = ((long long)nb * nsh + BB_WARPS - 1) / BB_WARPS;
  build_buckets_kernel<<<BW_CTAS + (int)(bucket_ctas < BN_CTAS ? bucket_ctas
                                                               : BN_CTAS),
                         BB_THREADS, 0, s>>>((const int32_t*)keys, (const uint8_t*)valid,
                                 cap, nsh, vec, 32 - lg, nb, (int32_t*)rid,
                                 (int32_t*)key, sc, (int32_t*)overflow);
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
      (const int32_t*)rid, (const int32_t*)key, (const int32_t*)qkeys, nullptr,
      w, lg, 0, nullptr, nullptr, none, 0, nullptr, nullptr, 1, 0, (int32_t*)cand,
      (uint8_t*)hit, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The verified probe: as hash_probe, then each candidate checked against
// valid [cap] uint8, keycol [cap] int32 (== the query key), nres residual
// terms (cols[t] [cap] int32, ops[t], vals[t] [w] int32), extra [cap]
// uint8 and active [w] uint8 (either may be null). Out: safe [w, 128]
// int32 (lanes clamped to [0, cap)), ok [w, 128] uint8, count [w] int32
// and, when limit > 0, ids [w, limit] int32 (matches in row order,
// 0-padded). With sid [w] (else null) the index is [S, 2^lg, 128] and
// valid, keycol, the terms' columns and extra are [S, cap]: query q
// probes shard sid[q] and its row ids are that shard's own.
REPRO_EXPORT int hash_probe_verify(
    const void* rid, const void* key, const void* qkeys, const void* sid,
    int w, int lg,
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
      (const int32_t*)rid, (const int32_t*)key, (const int32_t*)qkeys,
      (const int32_t*)sid, w, lg, 1, (const uint8_t*)valid, (const int32_t*)keycol, terms, nres,
      (const uint8_t*)extra, (const uint8_t*)active, cap, limit,
      (int32_t*)safe, (uint8_t*)ok, (int32_t*)count, (int32_t*)ids);
  return (int)cudaGetLastError();
}
