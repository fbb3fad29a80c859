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
// window ((lengths - pos) < window) and GQA as the reference.
//
// What bounds it on an H100: bytes. Every visible K/V row is read once
// (2 * len * kh * hd elements a sequence) against 4 * h * hd FLOP a
// token; at the serve path's shapes (b 4, kh 4, hd 128, len <= 256 in
// bf16) that is at most 1 MB, under a microsecond at 3.35 TB/s, so the
// kernel is latency bound there.
//
// Design (simple first; a split over pages and wider loads later):
//   * one CTA per (kv head, sequence): the g = h / kh query rows of that
//     kv head share every K/V block the CTA reads;
//   * the CTA walks pages[b, :] itself (the TPU kernel's scalar prefetch
//     becomes a plain load). A page that is missing (-1, or an id past the
//     arena) or whose positions are all masked (past lengths[b], or all
//     older than the window) is skipped without reading the arena, so the
//     arena is read in place through the page table and never copied;
//   * a visible block is staged in shared memory as fp32, K rows padded
//     by one float (conflict-free dot products); scores [g, block], then
//     one thread a query row updates (m, l) and the probabilities, then
//     the [g, hd] accumulator (shared memory) takes p @ V;
//   * a sequence with nothing visible gives 0 (l stays 0).
#include "attention_common.cuh"

namespace {

constexpr int PA_THREADS = 128;

template <int HD>
size_t pa_smem_bytes(int g, int block) {
  return sizeof(float) * ((size_t)g * (HD + 1) + (size_t)block * (HD + 1) +
                          (size_t)block * HD + (size_t)g * block +
                          (size_t)g * HD + 3 * (size_t)g);
}

template <typename T, int HD>
__global__ void __launch_bounds__(PA_THREADS)
paged_kernel(const T* __restrict__ q, const T* __restrict__ arena,
             const int32_t* __restrict__ pages,
             const int32_t* __restrict__ lengths, T* __restrict__ out, int h,
             int kh, int cap, int block, int nblk, float scale, float softcap,
             int window) {
  const int g = h / kh;
  extern __shared__ float smem[];
  float* qs = smem;                        // [g][HD + 1], pre-scaled
  float* ks = qs + g * (HD + 1);           // [block][HD + 1]
  float* vs = ks + block * (HD + 1);       // [block][HD]
  float* ps = vs + block * HD;             // [g][block] scores, then p
  float* acc = ps + g * block;             // [g][HD]
  float* m = acc + g * HD;                 // [g]
  float* l = m + g;                        // [g]
  float* corr = l + g;                     // [g]

  const int kvh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = lengths[bb];
  const T* qp = q + ((size_t)bb * h + (size_t)kvh * g) * HD;

  for (int i = tid; i < g * HD; i += PA_THREADS) {
    qs[(i / HD) * (HD + 1) + i % HD] = att_load(qp + i) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < g; r += PA_THREADS) {
    m[r] = ATT_NEG_INF;
    l[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    // uniform over the CTA: every thread skips the same pages
    const int row = pages[(size_t)bb * nblk + j];
    const int start = j * block;
    if (row < 0 || row >= cap || start >= len) continue;
    if (window > 0 && len - (start + block - 1) >= window) continue;

    for (int i = tid; i < block * HD; i += PA_THREADS) {
      const int t = i / HD, d = i % HD;
      const size_t kk = ((((size_t)row * 2 + 0) * block + t) * kh + kvh) * HD + d;
      const size_t vv = ((((size_t)row * 2 + 1) * block + t) * kh + kvh) * HD + d;
      ks[t * (HD + 1) + d] = att_load(arena + kk);
      vs[t * HD + d] = att_load(arena + vv);
    }
    __syncthreads();
    for (int i = tid; i < g * block; i += PA_THREADS) {
      const int r = i / block, t = i % block;
      const float* qrow = qs + r * (HD + 1);
      const float* krow = ks + t * (HD + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qrow[d], krow[d], s);
      s = att_softcap(s, softcap);
      const int pos = start + t;
      bool ok = pos < len;
      if (window > 0) ok = ok && (len - pos) < window;
      ps[i] = ok ? s : ATT_NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < g; r += PA_THREADS) {
      float* pr = ps + r * block;
      float mx = m[r];
      for (int t = 0; t < block; ++t) mx = fmaxf(mx, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < block; ++t) {
        const float p = expf(pr[t] - mx);
        pr[t] = p;
        sum += p;
      }
      const float c = expf(m[r] - mx);
      l[r] = l[r] * c + sum;
      m[r] = mx;
      corr[r] = c;
    }
    __syncthreads();
    for (int i = tid; i < g * HD; i += PA_THREADS) {
      const int r = i / HD, d = i % HD;
      const float* pr = ps + r * block;
      float a = acc[i] * corr[r];
      for (int t = 0; t < block; ++t) a = fmaf(pr[t], vs[t * HD + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* op = out + ((size_t)bb * h + (size_t)kvh * g) * HD;
  for (int i = tid; i < g * HD; i += PA_THREADS)
    att_store(op + i, acc[i] / fmaxf(l[i / HD], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* arena, const void* pages,
           const void* lengths, void* out, int b, int h, int kh, int cap,
           int block, int nblk, float scale, float softcap, int window,
           cudaStream_t stream) {
  const size_t smem = pa_smem_bytes<HD>(h / kh, block);
  cudaError_t err = att_smem_attr(paged_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kh, b);
  paged_kernel<T, HD><<<grid, PA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)arena, (const int32_t*)pages,
      (const int32_t*)lengths, (T*)out, h, kh, cap, block, nblk, scale,
      softcap, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* arena, const void* pages,
                const void* lengths, void* out, int b, int h, int kh, int hd,
                int cap, int block, int nblk, float scale, float softcap,
                int window, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    case 16: return launch<T, 16>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    case 32: return launch<T, 32>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    case 64: return launch<T, 64>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    case 80: return launch<T, 80>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    case 128: return launch<T, 128>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    case 256: return launch<T, 256>(q, arena, pages, lengths, out, b, h, kh, cap, block, nblk, scale, softcap, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, h, hd]; arena [cap, 2, block, kh, hd] (one dtype: 0 = fp32,
// 1 = bf16); pages [b, nblk] int32; lengths [b] int32; out [b, h, hd].
REPRO_EXPORT int paged_attention(const void* q, const void* arena,
                                 const void* pages, const void* lengths,
                                 void* out, int b, int h, int kh, int hd,
                                 int cap, int block, int nblk, int dtype,
                                 float scale, float softcap, int window,
                                 void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return dispatch_hd<float>(q, arena, pages, lengths, out, b, h, kh, hd, cap,
                              block, nblk, scale, softcap, window, s);
  if (dtype == ATT_BF16)
    return dispatch_hd<__nv_bfloat16>(q, arena, pages, lengths, out, b, h, kh,
                                      hd, cap, block, nblk, scale, softcap,
                                      window, s);
  return (int)cudaErrorInvalidValue;
}
