// Decode attention over the paged KV arena, for the port's serve step
// (serving/paged.py: make_paged_island).
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
//     pages are spread over CTAs. The grid comes from nblk, which the host
//     knows; lengths stay on the device, so the step needs no sync.
//   * Every CTA of a sequence reads lengths and the sequence's page ids and
//     finds the same splits with a visible position (a page present, not
//     past lengths[b], not older than the window). A split with none exits
//     there; split 0 writes the zeros of a sequence with none at all.
//   * A split loads its pages' K and V rows at once, 16-byte cp.async
//     copies (8 bf16 a thread, neighbouring threads on neighbouring hd
//     addresses; missing pages zero-filled), in the arena's type. Scores
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
#include "attention_common.cuh"

namespace {

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_SPLIT_POSITIONS = 64;  // a split: this many positions

// pages of one split: whole pages, PA_SPLIT_POSITIONS positions (at least
// one page)
int pa_pages_per_split(int block) {
  return block >= PA_SPLIT_POSITIONS ? 1 : PA_SPLIT_POSITIONS / block;
}

int pa_nsplit(int block, int nblk) {
  const int pps = pa_pages_per_split(block);
  return nblk > pps ? (nblk + pps - 1) / pps : 1;
}

// shared memory: q [g][HD] (fp32, scaled), K [np][HD + 16 bytes] and V
// [np][HD] in the arena's type, scores / probabilities [g][np], l [g]
// (fp32); then ints: the arena row of every page of the sequence (-1:
// missing or nothing visible), the splits that see something
template <typename T, int HD>
size_t pa_smem_bytes(int g, int np, int nsplit, int pps) {
  return sizeof(float) * (((size_t)g * HD + (size_t)g * np + g + 3) & ~(size_t)3) +
         sizeof(T) * ((size_t)np * (HD + 16 / sizeof(T)) + (size_t)np * HD) +
         sizeof(int) * ((size_t)nsplit * pps + nsplit);
}

// 16 bytes of K or V (4 fp32 or 8 bf16) as fp32
template <typename T>
__device__ __forceinline__ void pa_cvt16(uint4 raw, float* v);
template <>
__device__ __forceinline__ void pa_cvt16<float>(uint4 raw, float* v) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void pa_cvt16<__nv_bfloat16>(uint4 raw, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void pa_cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

template <typename T, int HD>
__global__ void __launch_bounds__(PA_THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ arena,
                   const int32_t* __restrict__ pages,
                   const int32_t* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ part, unsigned int* __restrict__ counters,
                   int h, int kh, int cap, int block, int nblk, int pps,
                   float scale, float softcap, int window) {
  constexpr int EPC = 16 / sizeof(T);  // elements of 16 bytes
  constexpr int CPR = HD / EPC;        // 16-byte pieces a row
  constexpr int KLD = HD + EPC;        // K row (16 bytes of padding)
  constexpr int Q4 = HD / 4;           // float4 groups of a row
  const int g = h / kh;
  const int kvh = blockIdx.x, bb = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int np = pps * block, pos0 = split * np;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ps = qs + g * HD;
  float* ltot = ps + g * np;
  T* ks = reinterpret_cast<T*>(qs + ((g * HD + g * np + g + 3) & ~3));  // 16-byte aligned
  T* vs = ks + np * KLD;
  int* prow = reinterpret_cast<int*>(vs + np * HD);  // [nsplit * pps]
  int* nzl = prow + nsplit * pps;                    // [nsplit]
  __shared__ int s_nnz, s_last;

  // the sequence's page table: every CTA of it finds the same splits
  // with something visible
  const int len = lengths[bb];
  const int lo = window > 0 ? max(0, len - window + 1) : 0;  // first visible
  for (int p = tid; p < nsplit * pps; p += PA_THREADS) {
    int row = p < nblk ? pages[(size_t)bb * nblk + p] : -1;
    const int start = p * block;
    if (row >= cap || start >= len || start + block <= lo) row = -1;
    prow[p] = row;
  }
  const T* qp = q + ((size_t)bb * h + (size_t)kvh * g) * HD;
#pragma unroll 4
  for (int i = tid; i < g * HD; i += PA_THREADS) qs[i] = att_load(qp + i) * scale;
  __syncthreads();
  if (warp == 0) {
    int nnz = 0;
    for (int j0 = 0; j0 < nsplit; j0 += 32) {
      const int j = j0 + lane;
      bool seen = false;
      for (int k = 0; j < nsplit && k < pps; ++k) seen |= prow[j * pps + k] >= 0;
      const unsigned mask = __ballot_sync(ATT_FULL, seen);
      if (seen) nzl[nnz + __popc(mask & ((1u << lane) - 1))] = j;
      nnz += __popc(mask);
    }
    if (lane == 0) s_nnz = nnz;
  }
  const int* rows = prow + split * pps;
  bool any = false;
  for (int k = 0; k < pps; ++k) any |= rows[k] >= 0;
  T* op = out + ((size_t)bb * h + (size_t)kvh * g) * HD;
  if (!any) {  // split 0 writes the zeros of a sequence that sees nothing
    __syncthreads();
    if (split == 0 && s_nnz == 0)
      for (int i = tid; i < g * HD; i += PA_THREADS) att_store(op + i, 0.f);
    return;
  }

  // the split's visible positions lie in [t0, t1); K and V rows of its
  // pages, all 16-byte copies in flight at once (missing pages zeroed)
  const int t0 = max(0, lo - pos0), t1 = min(np, len - pos0);
  for (int i = tid; i < (t1 - t0) * CPR; i += PA_THREADS) {
    const int t = t0 + i / CPR, e = (i % CPR) * EPC;
    const int row = rows[t / block];
    const size_t kk = ((((size_t)max(row, 0) * 2) * block + t % block) * kh + kvh) * HD + e;
    pa_cp16(ks + t * KLD + e, arena + kk, row >= 0);
    pa_cp16(vs + t * HD + e, arena + kk + (size_t)block * kh * HD, row >= 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int nnz = s_nnz;

  // scores over [t0, t1): LG lanes a (row, position) pair, 16 bytes of K a
  // lane at a time
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
      const uint4* kr = reinterpret_cast<const uint4*>(ks + t * KLD);
#pragma unroll 2
      for (int c = part_i; c < CPR; c += LG) {
        float kv[EPC];
        pa_cvt16<T>(kr[c], kv);
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
      const int pos = pos0 + t;
      const bool ok = rows[t / block] >= 0 && pos < len && pos >= lo;
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
      if (nnz > 1) part_ml[slot * g + r] = make_float2(m, l);
    }
  }
  __syncthreads();

  // o = p . V: a (row, 16 bytes of hd) group over TS threads, each a
  // share of the positions, summed with shuffles
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
        pa_cvt16<T>(reinterpret_cast<const uint4*>(vs + t * HD)[c], vv);
        const float pt = pr[t];
#pragma unroll
        for (int k = 0; k < EPC; ++k) a[k] = fmaf(pt, vv[k], a[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < EPC; ++k)
      for (int o = TS / 2; o > 0; o >>= 1) a[k] += __shfl_xor_sync(ATT_FULL, a[k], o);
    if (grp < groups && sl == 0) {
      if (nnz == 1) {  // the only split that sees anything: the output itself
        const float il = 1.f / ltot[r];
#pragma unroll
        for (int k = 0; k < EPC; ++k) att_store(op + r * HD + c * EPC + k, a[k] * il);
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
    const float il = 1.f / l;
    T* o = op + i * 4;
    att_store(o, a.x * il);
    att_store(o + 1, a.y * il);
    att_store(o + 2, a.z * il);
    att_store(o + 3, a.w * il);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* arena, const void* pages,
           const void* lengths, void* out, void* part, void* counters, int b,
           int h, int kh, int cap, int block, int nblk, float scale,
           float softcap, int window, cudaStream_t stream) {
  const int pps = pa_pages_per_split(block), nsplit = pa_nsplit(block, nblk);
  const size_t smem = pa_smem_bytes<T, HD>(h / kh, pps * block, nsplit, pps);
  cudaError_t err = att_smem_attr(paged_split_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kh, b, nsplit);
  paged_split_kernel<T, HD><<<grid, PA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)arena, (const int32_t*)pages,
      (const int32_t*)lengths, (T*)out, (float*)part, (unsigned int*)counters,
      h, kh, cap, block, nblk, pps, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* arena, const void* pages,
                const void* lengths, void* out, void* part, void* counters,
                int b, int h, int kh, int hd, int cap, int block, int nblk,
                float scale, float softcap, int window, cudaStream_t s) {
#define PA_CASE(HD)                                                          \
  case HD:                                                                   \
    return launch<T, HD>(q, arena, pages, lengths, out, part, counters, b, h, \
                         kh, cap, block, nblk, scale, softcap, window, s);
  switch (hd) {
    PA_CASE(8) PA_CASE(16) PA_CASE(32) PA_CASE(64) PA_CASE(80) PA_CASE(128)
    PA_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

// Floats of the partials' scratch paged_attention needs for these shapes:
// b * kh * nsplit * g * (hd + 2) (o, m, l of every split), or 0 when a
// sequence is one split and the kernel needs no scratch. With partials it
// also needs b * kh counters.
REPRO_EXPORT long long paged_attention_scratch(int b, int h, int hd, int block,
                                               int nblk) {
  if (block <= 0) return 0;
  const long long nsplit = pa_nsplit(block, nblk);
  return nsplit > 1 ? (long long)b * h * nsplit * (hd + 2) : 0;
}

// q [b, h, hd]; arena [cap, 2, block, kh, hd] (one dtype: 0 = fp32,
// 1 = bf16; 16-byte aligned); pages [b, nblk] int32; lengths [b] int32;
// out [b, h, hd]. Where paged_attention_scratch() is not 0, part holds
// that many floats and counters b * kh zeroed uint32 (left at zero by
// every launch); else both may be null.
REPRO_EXPORT int paged_attention(const void* q, const void* arena,
                                 const void* pages, const void* lengths,
                                 void* out, void* part, void* counters, int b,
                                 int h, int kh, int hd, int cap, int block,
                                 int nblk, int dtype, float scale,
                                 float softcap, int window, void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || block <= 0 || nblk < 0)
    return (int)cudaErrorInvalidValue;
  if (paged_attention_scratch(b, h, hd, block, nblk) > 0 &&
      (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return dispatch_hd<float>(q, arena, pages, lengths, out, part, counters, b,
                              h, kh, hd, cap, block, nblk, scale, softcap,
                              window, s);
  if (dtype == ATT_BF16)
    return dispatch_hd<__nv_bfloat16>(q, arena, pages, lengths, out, part,
                                      counters, b, h, kh, hd, cap, block, nblk,
                                      scale, softcap, window, s);
  return (int)cudaErrorInvalidValue;
}
