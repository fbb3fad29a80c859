// Prefill attention with an online softmax, for the port's prefill path
// (models/layers/attention.py: attention_prefill).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention  <- _kernel (flash_attention.py:28, launched at :115)
// Same contract: q [b, h, sq, hd], k/v [b, kh, sk, hd] (fp32 or bf16),
// out [b, h, sq, hd] in the input dtype; fp32 scores, softmax statistics
// and accumulator; causal mask with q_offset, sliding window, logit
// softcap, GQA through kv head = h / (h / kh).
//
// What bounds it on an H100: at the serve path's prompts (sq = sk = 8..24,
// h 32, hd 128) it moves ~0.1-0.4 MB and does ~2-20 MFLOP, both far below
// a microsecond at the card's rates: launch and latency bound. At long
// prompts it is bound by operations (4 * sq * sk * hd / 2 FLOP causal).
//
// Design (a simple kernel that is right first; tensor cores later):
//   * one CTA per (q tile of 16 rows, head, batch); 4 warps, each owning 4
//     query rows; the scaled Q tile is staged in shared memory as fp32;
//   * K/V tiles of 32 keys are staged in shared memory as fp32 (K rows
//     padded by one float so a lane-per-key dot product is bank-conflict
//     free); each lane scores one key, warp shuffles give the row max and
//     sum, and the (m, l, acc) state stays in registers, acc split over
//     the lanes by head dim (hd / 32 floats a lane a row);
//   * tiles wholly above the diagonal or wholly outside the window are
//     never loaded (the loop bounds), as the TPU kernel skips them;
//   * unlike the TPU wrapper (which asserts sq % block_q == 0) any sq and
//     sk are taken: the ragged tail of the last Q and K/V tiles is masked
//     in the kernel (rows past sq are neither read nor written);
//   * head dims 8, 16, 32, 64, 80, 128 and 256 are compiled (template on
//     hd; where hd is not a multiple of 32, the lanes past hd in the last
//     group of 32 accumulate nothing: all but 8 below 32, 16 at 80).
#include "attention_common.cuh"

namespace {

constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 4;                    // query rows a warp owns
constexpr int FA_BQ = FA_WARPS * FA_ROWS;     // query rows a CTA owns
constexpr int FA_BK = 32;                     // keys a tile: one per lane

template <int HD>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (FA_BQ * HD + FA_BK * (HD + 1) + FA_BK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int h, int kh, int sq,
             int sk, float scale, int causal, int window, float softcap,
             int q_offset) {
  constexpr int DPL = (HD + 31) / 32;  // head dims a lane accumulates
  extern __shared__ float smem[];
  float* qs = smem;                        // [FA_BQ][HD], pre-scaled
  float* ks = qs + FA_BQ * HD;             // [FA_BK][HD + 1]
  float* vs = ks + FA_BK * (HD + 1);       // [FA_BK][HD]

  const int q0 = blockIdx.x * FA_BQ;
  const int head = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = head / (h / kh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qp = q + ((size_t)bb * h + head) * sq * HD;
  const T* kp = k + ((size_t)bb * kh + kvh) * sk * HD;
  const T* vp = v + ((size_t)bb * kh + kvh) * sk * HD;
  T* op = o + ((size_t)bb * h + head) * sq * HD;

  for (int i = tid; i < FA_BQ * HD; i += FA_WARPS * 32) {
    const int r = q0 + i / HD;
    qs[i] = r < sq ? att_load(qp + (size_t)r * HD + i % HD) * scale : 0.f;
  }

  // keys any row of this tile can see: causal upper bound, window lower
  // bound (rounded down to a tile start)
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + FA_BQ, sq) - 1;
  const int kv_hi = causal ? min(sk, q_last + 1) : sk;
  int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  kv_lo = (kv_lo / FA_BK) * FA_BK;

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m[r] = ATT_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += FA_BK) {
    __syncthreads();  // Q staged / the previous tile fully consumed
    for (int i = tid; i < FA_BK * HD; i += FA_WARPS * 32) {
      const int r = i / HD, d = i % HD, kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < sk) {
        kx = att_load(kp + (size_t)kr * HD + d);
        vx = att_load(vp + (size_t)kr * HD + d);
      }
      ks[r * (HD + 1) + d] = kx;
      vs[r * HD + d] = vx;
    }
    __syncthreads();
    const int kpos = k0 + lane;
    const float* krow = ks + lane * (HD + 1);
#pragma unroll
    for (int rr = 0; rr < FA_ROWS; ++rr) {
      const int qr = warp * FA_ROWS + rr;
      const int qpos = q_offset + q0 + qr;
      const float* qrow = qs + qr * HD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qrow[d], krow[d], s);
      s = att_softcap(s, softcap);
      bool ok = kpos < sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s = ok ? s : ATT_NEG_INF;
      const float m_new = fmaxf(m[rr], att_warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + att_warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[rr][t] *= corr;
#pragma unroll 4
      for (int j = 0; j < FA_BK; ++j) {
        const float pj = __shfl_sync(ATT_FULL, p, j);
        const float* vrow = vs + j * HD + lane;
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          if (HD % 32 == 0 || lane + 32 * t < HD)
            acc[rr][t] = fmaf(pj, vrow[32 * t], acc[rr][t]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    const int r = q0 + warp * FA_ROWS + rr;
    if (r >= sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      if (HD % 32 == 0 || lane + 32 * t < HD)
        att_store(op + (size_t)r * HD + lane + 32 * t, acc[rr][t] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int kh, int sq, int sk, float scale, int causal, int window,
           float softcap, int q_offset, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes<HD>();
  cudaError_t err = att_smem_attr(flash_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + FA_BQ - 1) / FA_BQ, h, b);
  flash_kernel<T, HD><<<grid, FA_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, h, kh, sq, sk, scale,
      causal, window, softcap, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int b,
                int h, int kh, int sq, int sk, int hd, float scale, int causal,
                int window, float softcap, int q_offset, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    case 16: return launch<T, 16>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    case 80: return launch<T, 80>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    case 256: return launch<T, 256>(q, k, v, o, b, h, kh, sq, sk, scale, causal, window, softcap, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, h, sq, hd], k/v [b, kh, sk, hd], o [b, h, sq, hd], all contiguous
// and of one dtype (0 = fp32, 1 = bf16); hd in {8, 16, 32, 64, 80, 128, 256}.
REPRO_EXPORT int flash_attention(const void* q, const void* k, const void* v,
                                 void* o, int b, int h, int kh, int sq, int sk,
                                 int hd, int dtype, float scale, int causal,
                                 int window, float softcap, int q_offset,
                                 void* stream) {
  if (sq <= 0 || kh <= 0 || h % kh != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return dispatch_hd<float>(q, k, v, o, b, h, kh, sq, sk, hd, scale, causal,
                              window, softcap, q_offset, s);
  if (dtype == ATT_BF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, b, h, kh, sq, sk, hd, scale,
                                      causal, window, softcap, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
