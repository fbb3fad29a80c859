// Decode attention over the paged KV arena, for the port's serve step
// (serving/paged.py: make_paged_island): the kernel and its launch, shared
// by paged_attention.cu (arenas of q's dtype) and paged_attention_int8.cu
// (int8 arenas), which the build compiles in parallel.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
//   paged_attention  <- _kernel (paged_attention.py:27, launched at :127)
// Same contract: q [b, h, hd]; arena [cap, 2, block, kh, hd] (fp32 or
// bf16); pages [b, nblk] int32 arena row ids, -1 = missing; lengths [b]
// int32 visible tokens; position j*block + t of a sequence lives at
// arena[pages[b, j], :, t]. fp32 scores, softmax statistics and
// accumulator; output [b, h, hd] in the input dtype. Softcap, sliding
// window ((lengths - pos) < window) and GQA as the reference. A sequence
// with no visible position gives 0.
//
// The int8 read path (the int8 arena of serving/paged.py, whose reference
// is the pure-JAX island of src/repro/serving/paged.py:137-205: the Pallas
// kernel has no int8 path): the arena is int8 with fp32 scales [cap, 2,
// block, kh], one a (row, k/v, position, kv head); q is fp32 or bf16. A K
// row's score is its int8 dot product with q times its scale; a V row's
// scale is folded into its probability in p . V. The optional self term
// (k_self / v_self [b, kh, hd], q's dtype) is the reference's unquantized
// new token: where it is given, a sequence with lengths >= 0 attends its
// lengths pool positions plus that term, and one with lengths < 0 nothing.
// The writer of a sequence's output (its only split that sees a pool
// position, the merging split, or split 0 when none does) folds the term
// into the softmax before it normalises.
//
// What bounds it on an H100: bytes, and before them latency. Every
// visible K/V row is read once (2 * len * kh * hd elements a sequence)
// against 4 * h * hd FLOP a token; at the serve paths' shapes that is
// under 1.5 MB (under half a microsecond at 3.35 TB/s), so the time is
// the chain of dependent loads and barriers of the longest sequence. The
// first design (one CTA per kv head and sequence walking its pages with
// four barriers each, 2-byte loads, one thread a row's softmax) took 22 us
// at yi-6b's decode and 77 us at zamba2's, where one 310-token sequence
// was 20 pages in a row on one CTA.
//
// Design (flash-decoding, one launch):
//   * Grid (kv head, sequence, split): a split is 64 positions of whole
//     pages (pa_pages_per_split, from block alone), so a long sequence's
//     pages are spread over CTAs; a page longer than 64 positions whose
//     length is a multiple of 64 (the serving mesh's block 256) is cut
//     into 64-position parts, a split each (pa_splits_per_page), so that a
//     split's K/V tile stays 64 rows (at block 256 as whole pages, hd 128
//     fp32 or hd 256 bf16 would ask 266 KB of shared memory). The grid
//     comes from nblk, which the host knows; lengths stay on the device,
//     so the step needs no sync.
//   * Every CTA of a sequence reads lengths and the sequence's page ids and
//     finds the same splits with a visible position (a page present, not
//     past lengths[b], not older than the window). A split with none exits
//     there; split 0 writes the zeros of a sequence with none at all.
//   * A split loads its pages' K and V rows at once, 16-byte cp.async
//     copies (8 bf16 or 16 int8 a thread, neighbouring threads on
//     neighbouring hd addresses; an int8 row of 8 bytes, hd 8, is one
//     8-byte copy; missing pages zero-filled), in the arena's type. Scores
//     over the split's visible positions only: a (query row, position)
//     pair is a dot product over 1-32 lanes (as many as keep 256 threads
//     busy: 4 lanes for zamba2's g = 1, one for yi-6b's g = 8), reduced with
//     shuffles; a row's softmax is one warp's shuffles; p . V spreads a
//     (row, 16 bytes of hd) group over 2-16 threads. fp32 SIMT throughout:
//     at <= 64 positions x 8 rows a split the products take a small share.
//   * A sequence with one split that sees anything (every yi-6b decode
//     sequence, <= 64 tokens) is written by that split directly. With more,
//     each writes its (o, m, l) to a scratch the wrapper allocates, and the
//     last to finish merges them by their log-sum-exp (online: the loads of
//     all partials in flight at once). It learns that it is last from a
//     counter per (sequence, kv head) in a persistent scratch zeroed once
//     when allocated: atomicInc(counter, nsplit_seen - 1) elects the last
//     and wraps the counter back to 0 in the same operation, so no call
//     clears it and a graph replay finds it at 0. Only splits that saw
//     something write partials or count.
//
// Block starts and the log-sum-exp (the serving mesh's striped call form,
// serving/paged.py's island over a device mesh; the reference's island is
// src/repro/serving/paged.py:208-277, whose shard_map body attends its
// stripe's pages at their global positions and combines the stripes'
// softmax statistics with pmax / psum, :235-240). Both are optional and
// null on every earlier call, which launches paged_split_kernel, the
// earlier kernel with its parameters; a call with either (or with pages
// cut into parts, below) launches paged_wide_kernel, the same body with
// the new code compiled in (pa_body<WIDE>):
//   * blk_start [b, nblk] int32: the global position of page j's first
//     token (a stripe's pages are every stripe_total-th block of the
//     sequence). The visibility test, the window and the scores' mask read
//     it; a split's visible range [t0, t1) is the hull of its pages'
//     visible ranges, positions inside it but outside a page's own range
//     masked. It costs one more int of shared memory a page.
//   * lse [b, h] fp32: log of the row's softmax sum in the scaled,
//     softcapped score domain (m + log l, the self term folded in where it
//     is given); the output is then fp32 too, a partial rounded once after
//     the combine. The lse is written by the thread that writes the row's
//     output: the
//     only split that sees something, the merging split, or split 0 of a
//     sequence that sees nothing, which writes -1e30 (the self score where
//     the self term alone is visible), so that the stripes' combine weighs
//     it exp(-1e30 - max) = 0 with no inf - inf.
#pragma once

#include "attention_common.cuh"

namespace {

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_SPLIT_POSITIONS = 64;  // a split: this many positions
constexpr int PA_INT8 = 2;              // arena dtype code of an int8 arena

// pages of one split: whole pages, PA_SPLIT_POSITIONS positions (at least
// one page)
int pa_pages_per_split(int block) {
  return block >= PA_SPLIT_POSITIONS ? 1 : PA_SPLIT_POSITIONS / block;
}

// splits of one page: a page longer than a split whose length is a
// multiple of it (block 256, the serving mesh's) is cut into
// PA_SPLIT_POSITIONS-position parts, each a split of its own; else 1
int pa_splits_per_page(int block) {
  return block > PA_SPLIT_POSITIONS && block % PA_SPLIT_POSITIONS == 0
             ? block / PA_SPLIT_POSITIONS
             : 1;
}

int pa_nsplit(int block, int nblk) {
  const int spp = pa_splits_per_page(block);
  if (spp > 1) return nblk > 0 ? nblk * spp : 1;
  const int pps = pa_pages_per_split(block);
  return nblk > pps ? (nblk + pps - 1) / pps : 1;
}

// positions of one split, and the pages the page table spans in shared
// memory (padded to whole splits)
int pa_split_positions(int block) {
  return pa_splits_per_page(block) > 1 ? PA_SPLIT_POSITIONS
                                       : pa_pages_per_split(block) * block;
}

// the call form, which picks the kernel: PA_FORM_SPLIT (no block starts,
// no lse, pages of at most a split: paged_split_kernel, the earlier
// kernel), PA_FORM_WIDE (block starts or parts of a page, q's dtype out)
// or PA_FORM_LSE (the lse and an fp32 output); both paged_wide_kernel
constexpr int PA_FORM_SPLIT = 0, PA_FORM_WIDE = 1, PA_FORM_LSE = 2;

int pa_form(int block, bool starts, bool with_lse) {
  if (with_lse) return PA_FORM_LSE;
  return starts || pa_splits_per_page(block) > 1 ? PA_FORM_WIDE
                                                 : PA_FORM_SPLIT;
}

int pa_smem_pages(int block, int nsplit) {
  const int spp = pa_splits_per_page(block);
  return spp > 1 ? nsplit / spp : nsplit * pa_pages_per_split(block);
}

// bytes of one copy of a K/V row piece: 16, or the whole row when it is
// shorter (hd 8 in int8: 8 bytes)
template <typename TA, int HD>
__host__ __device__ constexpr int pa_piece_bytes() {
  return HD * (int)sizeof(TA) >= 16 ? 16 : HD * (int)sizeof(TA);
}

// shared memory: floats q [g][HD] (scaled), scores / probabilities
// [g][np], l, m and the self score [g], the K and V scales [np] (int8);
// then K [np][HD + one piece] and V [np][HD] in the arena's type; then
// ints: the arena row of every page of the sequence (-1: missing or
// nothing visible), the splits that see something, and with block starts
// every page's first position
__host__ __device__ inline size_t pa_float_words(int g, int HD, int np) {
  return ((size_t)g * HD + (size_t)g * np + 3 * (size_t)g + 2 * (size_t)np + 3) & ~(size_t)3;
}

template <typename TA, int HD>
size_t pa_smem_bytes(int g, int np, int nsplit, int npages, bool starts) {
  constexpr int EPC = pa_piece_bytes<TA, HD>() / (int)sizeof(TA);
  return sizeof(float) * pa_float_words(g, HD, np) +
         sizeof(TA) * ((size_t)np * (HD + EPC) + (size_t)np * HD) +
         sizeof(int) * ((size_t)npages * (starts ? 2 : 1) + nsplit);
}

// one piece of a K or V row (EPC elements) as fp32
template <typename TA, int EPC>
__device__ __forceinline__ void pa_cvt(const TA* p, float* v);
template <>
__device__ __forceinline__ void pa_cvt<float, 4>(const float* p, float* v) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}
template <>
__device__ __forceinline__ void pa_cvt<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                         float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void pa_cvt<int8_t, 16>(const int8_t* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}
template <>
__device__ __forceinline__ void pa_cvt<int8_t, 8>(const int8_t* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}

template <int BYTES>
__device__ __forceinline__ void pa_cp(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
}

// where the self term is given: dot(q row, k_self) (softcapped) of every
// query row, one warp a row
template <typename T, int HD>
__device__ __forceinline__ void pa_self_scores(const float* qs, const T* ksp,
                                               float* sself, int g, float softcap,
                                               int warp, int lane) {
  for (int r = warp; r < g; r += PA_WARPS) {
    float s = 0.f;
    for (int d = lane; d < HD; d += 32) s = fmaf(qs[r * HD + d], att_load(ksp + d), s);
    s = att_warp_sum(s);
    if (lane == 0) sself[r] = att_softcap(s, softcap);
  }
}

// whether the part of page p from offset off, n positions long, holds a
// visible position (its row kept by the page filter; the window and
// length bound the part itself)
__device__ __forceinline__ bool pa_part_seen(const int* prow, const int* pstart,
                                             bool starts, int p, int off, int n,
                                             int block, int len, int lo) {
  const int st = (starts ? pstart[p] : p * block) + off;
  return prow[p] >= 0 && st < len && st + n > lo;
}

// The kernel's body. WIDE: the form that reads block starts, writes the
// lse and cuts pages into parts (paged_wide_kernel); the earlier call
// form (none of the three) is paged_split_kernel, with the earlier
// kernel's parameters, where all of it folds away, so that its code and
// time stay the earlier ones. TO: the output's type, fp32 where the lse is
// asked for (a partial that the stripes' combine reads, rounded once
// after it, as the reference's fp32 partials are), else q's
template <typename T, typename TA, int HD, bool WIDE, typename TO>
__device__ __forceinline__ void
pa_body(const T* __restrict__ q, const TA* __restrict__ arena,
        const float* __restrict__ scales, const T* __restrict__ kself,
        const T* __restrict__ vself, const int32_t* __restrict__ pages,
        const int32_t* __restrict__ lengths,
        const int32_t* __restrict__ blk_start, TO* __restrict__ out,
        float* __restrict__ lse, float* __restrict__ part,
        unsigned int* __restrict__ counters, int h, int kh, int cap,
        int block, int nblk, int pps, int spp_arg, float scale,
        float softcap, int window) {
  constexpr bool QUANT = sizeof(TA) == 1;
  constexpr int PB = pa_piece_bytes<TA, HD>();
  constexpr int EPC = PB / (int)sizeof(TA);  // elements of one piece
  constexpr int CPR = HD / EPC;              // pieces a row
  constexpr int KLD = HD + EPC;              // K row (one piece of padding)
  constexpr int Q4 = HD / 4;                 // float4 groups of a row
  const int g = h / kh;
  const int kvh = blockIdx.x, bb = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int spp = WIDE ? spp_arg : 1;
  // a split: pps whole pages (spp 1), or the part soff.. of page pg0
  const int np = spp > 1 ? block / spp : pps * block, pos0 = split * np;
  const int pg0 = spp > 1 ? split / spp : split * pps;
  const int soff = spp > 1 ? (split % spp) * np : 0;
  const int npages = spp > 1 ? nsplit / spp : nsplit * pps;
  const int span = spp > 1 ? np : block;  // positions of a page in a split
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ps = qs + g * HD;
  float* ltot = ps + g * np;
  float* mtot = ltot + g;
  float* sself = mtot + g;
  float* ksc = sself + g;
  float* vsc = ksc + np;
  TA* ks = reinterpret_cast<TA*>(qs + pa_float_words(g, HD, np));  // 16-byte aligned
  TA* vs = ks + np * KLD;
  int* prow = reinterpret_cast<int*>(vs + np * HD);  // [npages]
  int* nzl = prow + npages;                          // [nsplit]
  int* pstart = nzl + nsplit;  // [npages], with block starts only
  const bool starts = WIDE && blk_start != nullptr;
  __shared__ int s_nnz, s_last;

  // the sequence's page table: every CTA of it finds the same splits
  // with something visible
  const int len = lengths[bb];
  const int lo = window > 0 ? max(0, len - window + 1) : 0;  // first visible
  // the self term: given, and the sequence attends (lengths >= 0)
  const bool self_on = kself != nullptr && len >= 0;
  for (int p = tid; p < npages; p += PA_THREADS) {
    int row = p < nblk ? pages[(size_t)bb * nblk + p] : -1;
    int start = p * block;
    if constexpr (WIDE) if (starts) {
      start = p < nblk ? blk_start[(size_t)bb * nblk + p] : 0;
      pstart[p] = start;
    }
    if (row >= cap || start >= len || start + block <= lo) row = -1;
    prow[p] = row;
  }
  const T* qp = q + ((size_t)bb * h + (size_t)kvh * g) * HD;
  const size_t self_off = ((size_t)bb * kh + kvh) * HD;
#pragma unroll 4
  for (int i = tid; i < g * HD; i += PA_THREADS) qs[i] = att_load(qp + i) * scale;
  __syncthreads();
  if (warp == 0) {
    int nnz = 0;
    for (int j0 = 0; j0 < nsplit; j0 += 32) {
      const int j = j0 + lane;
      bool seen = false;
      if (spp > 1 && j < nsplit)
        seen = pa_part_seen(prow, pstart, starts, j / spp, (j % spp) * np, np, block, len, lo);
      for (int k = 0; spp == 1 && j < nsplit && k < pps; ++k) seen |= prow[j * pps + k] >= 0;
      const unsigned mask = __ballot_sync(ATT_FULL, seen);
      if (seen) nzl[nnz + __popc(mask & ((1u << lane) - 1))] = j;
      nnz += __popc(mask);
    }
    if (lane == 0) s_nnz = nnz;
  }
  const int* rows = prow + pg0;
  bool any = false;
  if (spp > 1)
    any = pa_part_seen(prow, pstart, starts, pg0, soff, np, block, len, lo);
  for (int k = 0; spp == 1 && k < pps; ++k) any |= rows[k] >= 0;
  TO* op = out + ((size_t)bb * h + (size_t)kvh * g) * HD;
  float* lsep = !WIDE || lse == nullptr ? nullptr : lse + (size_t)bb * h + (size_t)kvh * g;
  if (!any) {  // split 0 writes a sequence that sees no pool position
    __syncthreads();
    if (split == 0 && s_nnz == 0) {  // the self term alone, or nothing: 0
      for (int i = tid; i < g * HD; i += PA_THREADS)
        att_store(op + i, self_on ? att_load(vself + self_off + i % HD) : 0.f);
      if (lsep != nullptr) {  // the self score, or nothing: -1e30
        if (self_on) {
          pa_self_scores<T, HD>(qs, kself + self_off, sself, g, softcap, warp, lane);
          __syncthreads();
        }
        for (int r = tid; r < g; r += PA_THREADS) lsep[r] = self_on ? sself[r] : ATT_NEG_INF;
      }
    }
    return;
  }
  if (self_on) pa_self_scores<T, HD>(qs, kself + self_off, sself, g, softcap, warp, lane);

  // the split's visible positions lie in [t0, t1); K and V rows of its
  // pages, all copies in flight at once (missing pages zeroed), and the
  // int8 rows' scales. With block starts: the hull of its pages' ranges
  int t0 = max(0, lo - pos0), t1 = min(np, len - pos0);
  if constexpr (WIDE) if (starts) {
    t0 = np;
    t1 = 0;
    for (int k = 0; k < (spp > 1 ? 1 : pps); ++k) {
      if (rows[k] < 0) continue;
      const int st = pstart[pg0 + k] + soff;
      t0 = min(t0, k * block + max(0, lo - st));
      t1 = max(t1, k * block + min(span, len - st));
    }
  }
  for (int i = tid; i < (t1 - t0) * CPR; i += PA_THREADS) {
    const int t = t0 + i / CPR, e = (i % CPR) * EPC;
    const int row = rows[t / block];
    const size_t kk = ((((size_t)max(row, 0) * 2) * block + soff + t % block) * kh + kvh) * HD + e;
    pa_cp<PB>(ks + t * KLD + e, arena + kk, row >= 0);
    pa_cp<PB>(vs + t * HD + e, arena + kk + (size_t)block * kh * HD, row >= 0);
  }
  if (QUANT) {
    for (int t = t0 + tid; t < t1; t += PA_THREADS) {
      const int row = rows[t / block];
      const size_t si = (((size_t)max(row, 0) * 2) * block + soff + t % block) * kh + kvh;
      ksc[t] = row >= 0 ? scales[si] : 0.f;
      vsc[t] = row >= 0 ? scales[si + (size_t)block * kh] : 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int nnz = s_nnz;

  // scores over [t0, t1): LG lanes a (row, position) pair, one piece of K
  // a lane at a time
  const int nt = t1 - t0, pairs = g * nt;
  int LG = 1;
  while (LG < 32 && pairs * LG * 2 <= PA_THREADS) LG *= 2;
  const int part_i = tid % LG;
  for (int p0 = 0; p0 < pairs; p0 += PA_THREADS / LG) {
    const int p = p0 + tid / LG;
    const int r = p / nt, t = t0 + p % nt;
    float s0 = 0.f, s1 = 0.f;
    if (p < pairs) {
      const float* qr = qs + r * HD;
      const TA* kr = ks + t * KLD;
#pragma unroll 2
      for (int c = part_i; c < CPR; c += LG) {
        float kv[EPC];
        pa_cvt<TA, EPC>(kr + c * EPC, kv);
#pragma unroll
        for (int k = 0; k < EPC; k += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + c * EPC + k);
          s0 = fmaf(a.x, kv[k], s0);
          s1 = fmaf(a.y, kv[k + 1], s1);
          s0 = fmaf(a.z, kv[k + 2], s0);
          s1 = fmaf(a.w, kv[k + 3], s1);
        }
      }
    }
    float sc = s0 + s1;
    for (int o = LG / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(ATT_FULL, sc, o);
    if (p < pairs && part_i == 0) {
      const int pos = starts ? pstart[pg0 + t / block] + soff + t % block : pos0 + t;
      const bool ok = rows[t / block] >= 0 && pos < len && pos >= lo;
      if (QUANT) sc *= ksc[t];
      ps[r * np + t] = ok ? att_softcap(sc, softcap) : ATT_NEG_INF;
    }
  }
  __syncthreads();

  // partials of this split: [b][kh][nsplit] slots of o [g][HD], then of
  // (m, l) [g]
  const size_t slot = ((size_t)bb * kh + kvh) * nsplit + split;
  float* part_o = part;
  float2* part_ml = reinterpret_cast<float2*>(part + (size_t)gridDim.y * kh * nsplit * g * HD);

  // softmax of each row over [t0, t1): one warp a row
  for (int r = warp; r < g; r += PA_WARPS) {
    float* pr = ps + r * np;
    float m = ATT_NEG_INF;
    for (int t = t0 + lane; t < t1; t += 32) m = fmaxf(m, pr[t]);
    m = att_warp_max(m);
    float l = 0.f;
    for (int t = t0 + lane; t < t1; t += 32) {
      const float e = expf(pr[t] - m);  // subtract first: exact for -1e30
      pr[t] = e;
      l += e;
    }
    l = att_warp_sum(l);
    if (lane == 0) {
      ltot[r] = l;
      mtot[r] = m;
      if (nnz > 1) part_ml[slot * g + r] = make_float2(m, l);
    }
  }
  __syncthreads();

  // o = p . V: a (row, piece of hd) group over TS threads, each a share of
  // the positions, summed with shuffles (an int8 row's scale rides on p)
  const int groups = g * CPR;
  int TS = 1;
  while (TS < 32 && groups * TS * 2 <= PA_THREADS) TS *= 2;
  for (int i0 = 0; i0 < groups * TS; i0 += PA_THREADS) {
    const int i = i0 + tid, grp = i / TS, sl = i % TS;
    const int r = grp / CPR, c = grp % CPR;
    float a[EPC];
#pragma unroll
    for (int k = 0; k < EPC; ++k) a[k] = 0.f;
    if (grp < groups) {
      const float* pr = ps + r * np;
#pragma unroll 4
      for (int t = t0 + sl; t < t1; t += TS) {
        float vv[EPC];
        pa_cvt<TA, EPC>(vs + t * HD + c * EPC, vv);
        const float pt = QUANT ? pr[t] * vsc[t] : pr[t];
#pragma unroll
        for (int k = 0; k < EPC; ++k) a[k] = fmaf(pt, vv[k], a[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < EPC; ++k)
      for (int o = TS / 2; o > 0; o >>= 1) a[k] += __shfl_xor_sync(ATT_FULL, a[k], o);
    if (grp < groups && sl == 0) {
      if (nnz == 1) {  // the only split that sees anything: the output itself
        float c0 = 1.f, c1 = 0.f;
        if (self_on) {  // fold the self term in
          const float mn = fmaxf(mtot[r], sself[r]);
          c0 = expf(mtot[r] - mn);
          c1 = expf(sself[r] - mn);
        }
        const float il = 1.f / fmaf(ltot[r], c0, c1);
        if constexpr (WIDE) {
          if (lsep != nullptr && c == 0)
            lsep[r] = (self_on ? fmaxf(mtot[r], sself[r]) : mtot[r]) +
                      logf(fmaf(ltot[r], c0, c1));
        }
#pragma unroll
        for (int k = 0; k < EPC; ++k) {
          const int d = c * EPC + k;
          const float vn = self_on ? att_load(vself + self_off + d) : 0.f;
          att_store(op + r * HD + d, fmaf(a[k], c0, c1 * vn) * il);
        }
      } else {
        float* po = part_o + slot * g * HD + r * HD + c * EPC;
#pragma unroll
        for (int k = 0; k < EPC; k += 4)
          *reinterpret_cast<float4*>(po + k) = make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
      }
    }
  }
  if (nnz == 1) return;

  // the last of the splits that see something merges their partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicInc(counters + (size_t)bb * kh + kvh, nnz - 1) ==
             (unsigned int)(nnz - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t first = ((size_t)bb * kh + kvh) * nsplit;
  for (int i = tid; i < g * Q4; i += PA_THREADS) {
    const int r = i / Q4;
    float m = ATT_NEG_INF, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < nnz; ++k) {  // online: the loads do not wait on m
      const size_t sl = first + nzl[k];
      const float2 ml = __ldcg(part_ml + sl * g + r);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(part_o + sl * g * HD) + i);
      const float mn = fmaxf(m, ml.x);
      const float c0 = expf(m - mn), c1 = expf(ml.x - mn);  // subtract first
      l = fmaf(l, c0, ml.y * c1);
      a.x = fmaf(a.x, c0, v.x * c1);
      a.y = fmaf(a.y, c0, v.y * c1);
      a.z = fmaf(a.z, c0, v.z * c1);
      a.w = fmaf(a.w, c0, v.w * c1);
      m = mn;
    }
    float vn[4] = {0.f, 0.f, 0.f, 0.f};
    if (self_on) {  // fold the self term in
      const float mn = fmaxf(m, sself[r]);
      const float c0 = expf(m - mn), c1 = expf(sself[r] - mn);
      const int d0 = (i % Q4) * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) vn[k] = c1 * att_load(vself + self_off + d0 + k);
      l = fmaf(l, c0, c1);
      a.x *= c0;
      a.y *= c0;
      a.z *= c0;
      a.w *= c0;
      if constexpr (WIDE) m = mn;
    }
    const float il = 1.f / l;
    if (lsep != nullptr && i % Q4 == 0) lsep[r] = m + logf(l);
    TO* o = op + i * 4;
    att_store(o, (a.x + vn[0]) * il);
    att_store(o + 1, (a.y + vn[1]) * il);
    att_store(o + 2, (a.z + vn[2]) * il);
    att_store(o + 3, (a.w + vn[3]) * il);
  }
}

template <typename T, typename TA, int HD>
__global__ void __launch_bounds__(PA_THREADS)
paged_split_kernel(const T* __restrict__ q, const TA* __restrict__ arena,
                   const float* __restrict__ scales,
                   const T* __restrict__ kself, const T* __restrict__ vself,
                   const int32_t* __restrict__ pages,
                   const int32_t* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ part, unsigned int* __restrict__ counters,
                   int h, int kh, int cap, int block, int nblk, int pps,
                   float scale, float softcap, int window) {
  pa_body<T, TA, HD, false, T>(q, arena, scales, kself, vself, pages, lengths,
                               nullptr, out, nullptr, part, counters, h, kh,
                               cap, block, nblk, pps, 1, scale, softcap,
                               window);
}

template <typename T, typename TA, int HD, typename TO>
__global__ void __launch_bounds__(PA_THREADS)
paged_wide_kernel(const T* __restrict__ q, const TA* __restrict__ arena,
                  const float* __restrict__ scales,
                  const T* __restrict__ kself, const T* __restrict__ vself,
                  const int32_t* __restrict__ pages,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ blk_start, TO* __restrict__ out,
                  float* __restrict__ lse, float* __restrict__ part,
                  unsigned int* __restrict__ counters, int h, int kh, int cap,
                  int block, int nblk, int pps, int spp, float scale,
                  float softcap, int window) {
  pa_body<T, TA, HD, true, TO>(q, arena, scales, kself, vself, pages, lengths,
                               blk_start, out, lse, part, counters, h, kh,
                               cap, block, nblk, pps, spp, scale, softcap,
                               window);
}

template <typename T, typename TA, int HD, typename TO>
int launch_form(bool wide, const void* q, const void* arena,
                const void* scales, const void* kself, const void* vself,
                const void* pages, const void* lengths, const void* blk_start,
                void* out, void* lse, void* part, void* counters, int b, int h,
                int kh, int cap, int block, int nblk, float scale,
                float softcap, int window, cudaStream_t stream) {
  const int pps = pa_pages_per_split(block), spp = pa_splits_per_page(block);
  const int nsplit = pa_nsplit(block, nblk);
  const size_t smem = pa_smem_bytes<TA, HD>(h / kh, pa_split_positions(block), nsplit,
                                            pa_smem_pages(block, nsplit),
                                            blk_start != nullptr);
  const dim3 grid(kh, b, nsplit);
  cudaError_t err;
  if (wide) {
    err = att_smem_attr(paged_wide_kernel<T, TA, HD, TO>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_wide_kernel<T, TA, HD, TO><<<grid, PA_THREADS, smem, stream>>>(
        (const T*)q, (const TA*)arena, (const float*)scales, (const T*)kself,
        (const T*)vself, (const int32_t*)pages, (const int32_t*)lengths,
        (const int32_t*)blk_start, (TO*)out, (float*)lse, (float*)part,
        (unsigned int*)counters, h, kh, cap, block, nblk, pps, spp, scale,
        softcap, window);
  } else {
    err = att_smem_attr(paged_split_kernel<T, TA, HD>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_split_kernel<T, TA, HD><<<grid, PA_THREADS, smem, stream>>>(
        (const T*)q, (const TA*)arena, (const float*)scales, (const T*)kself,
        (const T*)vself, (const int32_t*)pages, (const int32_t*)lengths,
        (T*)out, (float*)part, (unsigned int*)counters, h, kh, cap, block,
        nblk, pps, scale, softcap, window);
  }
  return (int)cudaGetLastError();
}

// the call form picks the instantiation: the lse (an fp32 output), block
// starts or parts of a page (WIDE), or none of them (the earlier kernel)
template <typename T, typename TA, int HD>
int launch(const void* q, const void* arena, const void* scales,
           const void* kself, const void* vself, const void* pages,
           const void* lengths, const void* blk_start, void* out, void* lse,
           void* part, void* counters, int b, int h, int kh, int cap,
           int block, int nblk, float scale, float softcap, int window,
           cudaStream_t stream) {
#define PA_FORM(WIDE, TO)                                                      \
  launch_form<T, TA, HD, TO>(WIDE, q, arena, scales, kself, vself, pages,      \
                             lengths, blk_start, out, lse, part, counters, b,  \
                             h, kh, cap, block, nblk, scale, softcap, window,  \
                             stream)
  switch (pa_form(block, blk_start != nullptr, lse != nullptr)) {
    case PA_FORM_LSE: return PA_FORM(true, float);
    case PA_FORM_WIDE: return PA_FORM(true, T);
    default: return PA_FORM(false, T);
  }
#undef PA_FORM
}

template <typename T, typename TA>
int dispatch_hd(const void* q, const void* arena, const void* scales,
                const void* kself, const void* vself, const void* pages,
                const void* lengths, const void* blk_start, void* out,
                void* lse, void* part, void* counters, int b, int h, int kh,
                int hd, int cap, int block, int nblk, float scale,
                float softcap, int window, cudaStream_t s) {
#define PA_CASE(HD)                                                            \
  case HD:                                                                     \
    return launch<T, TA, HD>(q, arena, scales, kself, vself, pages, lengths,   \
                             blk_start, out, lse, part, counters, b, h, kh,    \
                             cap, block, nblk, scale, softcap, window, s);
  switch (hd) {
    PA_CASE(8) PA_CASE(16) PA_CASE(32) PA_CASE(64) PA_CASE(80) PA_CASE(128)
    PA_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

// The exported entry's checks and its dispatch over q's dtype: QUANT, an
// int8 arena (paged_attention_int8.cu), else an arena of q's dtype
// (paged_attention.cu). Each source instantiates only its own kernels.
template <bool QUANT>
int pa_entry(const void* q, const void* arena, const void* scales,
             const void* kself, const void* vself, const void* pages,
             const void* lengths, const void* blk_start, void* out, void* lse,
             void* part, void* counters, int b, int h, int kh, int hd, int cap,
             int block, int nblk, int dtype, int arena_dtype, float scale,
             float softcap, int window, void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || block <= 0 || nblk < 0)
    return (int)cudaErrorInvalidValue;
  if (pa_nsplit(block, nblk) > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((kself == nullptr) != (vself == nullptr)) return (int)cudaErrorInvalidValue;
  if (QUANT != (arena_dtype == PA_INT8) || QUANT == (scales == nullptr) ||
      (!QUANT && arena_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PA_ARGS                                                                \
  q, arena, scales, kself, vself, pages, lengths, blk_start, out, lse, part,  \
      counters, b, h, kh, hd, cap, block, nblk, scale, softcap, window, s
  if constexpr (QUANT) {
    if (dtype == ATT_F32) return dispatch_hd<float, int8_t>(PA_ARGS);
    if (dtype == ATT_BF16) return dispatch_hd<__nv_bfloat16, int8_t>(PA_ARGS);
  } else {
    if (dtype == ATT_F32) return dispatch_hd<float, float>(PA_ARGS);
    if (dtype == ATT_BF16)
      return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
  }
#undef PA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
