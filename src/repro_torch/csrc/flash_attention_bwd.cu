// The backward of prefill attention, for the port's training path
// (kernels/flash_attention.py: FlashAttention.backward).
//
// Replaces no Pallas kernel: the reference differentiates its jnp
// chunked_attention (src/repro/models/layers/attention.py:84-174) with
// jax.grad, and its Pallas flash kernel (src/repro/kernels/
// flash_attention.py:28) has no backward. The port's attention runs through
// its own forward kernel (flash_attention.cu), which autograd cannot see
// into, so its gradient is a kernel too. The math is FA2's backward, with
// P recomputed from the row log-sum-exp the forward stored:
//   s  = scale * q.k, softcapped s_c = tanh(s / cap) * cap, masked -1e30
//   P  = exp(s_c - lse)
//   D  = rowsum(dO o O)                          (kernel 1: delta)
//   dP = dO V^T,  dS = P o (dP - D) o (1 - (s_c / cap)^2) * scale
//   dV = P^T dO,  dK = dS^T Q                    (kernel 2: dK/dV)
//   dQ = dS K                                    (kernel 3: dQ)
// The causal mask with q_offset, the window and the ragged tails are the
// forward's. A masked pair has dS = 0 (the plain version's torch.where
// passes no gradient to a masked score). A row that sees no key (window
// ending before the first key: q_offset + row >= sk + window - 1) has the
// uniform P = 1 / sk of the plain version's softmax over sk masked scores:
// it adds dO / sk to every key's dV and nothing to dQ or dK. The forward's
// lse of such a row (-1e30 absorbs log sk in fp32) is not read.
//
// Precision: all sums in fp32 from fp32 or bf16 inputs converted in shared
// memory; dQ, dK, dV rounded once to the input dtype. In bf16 the forward's
// tc kernel summed bf16-rounded P into l, so the recomputed P sums to 1
// within 2^-8 (see flash_attention.cu); D uses the stored (rounded) O.
//
// Two designs, picked by dtype and head dim. Both split the work alike:
//   * dK/dV: one CTA per (batch, kv head, key tile). It walks the query
//     tiles that can see its keys, for EVERY query head of its GQA group,
//     so dK and dV are summed over the group in registers: no atomics, and
//     the result is the same bits on every run.
//   * dQ: one CTA per (batch, head, query tile), walking the key tiles its
//     rows can see (the forward's bounds); S and dP are computed a second
//     time rather than stored. The query tiles that see the most keys are
//     scheduled first.
//
// bf16 at head dims 32-256 (bt_*_kernel): FA2's backward on mma.sync
// m16n8k16 (mma_bf16.cuh), 8 warps, 64 x 64 tiles of (keys, queries) in
// shared memory (rows padded to hd + 8 bf16, as the forward's).
//   * dK/dV: S^T = K Q^T and dP^T = V dO^T on the tensor cores (warp w:
//     keys 16 (w % 4), queries 32 (w / 4)), fp32 accumulators; P^T and
//     dS^T in fp32, rounded to bf16 into shared memory; then dV += P^T dO
//     and dK += dS^T Q (warp w: keys 16 (w % 4), head dims hd / 2 (w / 4)),
//     P^T / dS^T as A fragments through ldmatrix, dO / Q as B through
//     ldmatrix.trans, fp32 accumulators in registers (hd / 2 a lane at hd
//     256).
//   * dQ: S = Q K^T and dP = dO V^T the same way, dS in bf16 to shared
//     memory, dQ += dS K.
//   * Rounding P and dS to bf16 for the second products is the one
//     rounding the plain version does not make (FA2 makes it too): each
//     term moves by 2^-9 relative, inside the 2e-2 bf16 tolerance.
// fp32, and bf16 at head dims 8 and 16 (bw_*_kernel, SIMT; tensor cores
// would round fp32 to TF32): a CTA of 8 warps works on 32 x 32 tiles of
// (query rows, keys) staged in shared memory as fp32 (rows padded to
// hd + 4 floats: 16-byte rows, conflict-free float4 reads one row a lane).
//   * Scores: lane = query row, warp w = keys w + 8 i (i < 4); each thread
//     forms its 4 entries of S and dP from float4 reads of Q, dO (its row)
//     and K, V (broadcast), then P and dS, which go to shared memory.
//   * Products: warp w owns rows w + 8 j (j < 4) of the output tile, lane
//     its head dims lane + 32 t, fp32 accumulators in registers.
// What bounds it on an H100: operations, 10 * visible pairs * hd FLOP
// (S, dP and dS^T's two products in the dK/dV pass, S, dP and dS K in the
// dQ pass: 14 as written) at 989 TFLOP/s bf16. The SIMT kernels run them
// on the fp32 units from shared memory (at gemma2-2b's training shape on
// an H100, bf16 on them took 68 ms against a 0.69 ms bound; the tc kernels
// below 8.8 ms: PERF.md). What is left for the tc design: wgmma with TMA
// loads, a cp.async ring for the streamed tiles (they are loaded
// synchronously now), larger key tiles.
#include "attention_common.cuh"
#include "mma_bf16.cuh"

namespace {

struct Strides { long long b, h, s; };
// element strides (batch, head, sequence) of each tensor, head dim contiguous
struct BwStrides { Strides q, k, v, o, dout, dq, dk, dv; };

constexpr int BW_WARPS = 8;
constexpr int BW_THREADS = BW_WARPS * 32;
constexpr int BW_T = 32;            // query rows and keys of a tile
constexpr int BW_KW = BW_T / BW_WARPS;  // keys (or rows) a warp: 4
constexpr int BW_PS = BW_T + 1;     // pitch of the P / dS tiles

template <int HD>
struct Bw {
  static constexpr int LD = HD + 4;            // fp32 row pitch
  static constexpr int DPL = (HD + 31) / 32;   // head dims a lane
  // four [32][LD] tiles (Q, dO, K, V), P and dS, lse and D of the rows
  static constexpr size_t smem =
      sizeof(float) * (4 * BW_T * LD + 2 * BW_T * BW_PS + 2 * BW_T);
};

// rows [r0, r0 + 32) of one head into a [32][LD] fp32 tile; rows past n
// are zero
template <typename T, int HD>
__device__ __forceinline__ void bw_load(float* dst, const T* src,
                                        long long row_stride, int r0, int n,
                                        int tid) {
  for (int i = tid; i < BW_T * HD; i += BW_THREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * Bw<HD>::LD + d] =
        r0 + r < n ? att_load<T>(src + (r0 + r) * row_stride + d) : 0.f;
  }
}

// this thread's 4 entries of S = Q K^T (unscaled) and dP = dO V^T: query
// row = lane, keys warp + 8 i
template <int HD>
__device__ __forceinline__ void bw_scores(const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          int lane, int warp,
                                          float (&s)[BW_KW],
                                          float (&dp)[BW_KW]) {
  constexpr int LD = Bw<HD>::LD;
#pragma unroll
  for (int i = 0; i < BW_KW; ++i) s[i] = dp[i] = 0.f;
  const float* qr = qs + lane * LD;
  const float* orow = dos + lane * LD;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(qr + d);
    const float4 o = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
    for (int i = 0; i < BW_KW; ++i) {
      const int kr = warp + BW_WARPS * i;
      const float4 kk = *reinterpret_cast<const float4*>(ks + kr * LD + d);
      const float4 vv = *reinterpret_cast<const float4*>(vs + kr * LD + d);
      s[i] = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, s[i]))));
      dp[i] = fmaf(o.x, vv.x, fmaf(o.y, vv.y, fmaf(o.z, vv.z, fmaf(o.w, vv.w, dp[i]))));
    }
  }
}

struct BwMask {
  float scale, softcap, inv_sk;
  int sq, sk, causal, window, q_offset;
};

// P and dS of (query row qr, key kr) from the raw product s and dP; rows
// past sq and keys past sk give 0
__device__ __forceinline__ void bw_p_ds(const BwMask& mk, int qr, int kr,
                                        float s, float dp, float lse_r,
                                        float d_r, float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (qr >= mk.sq || kr >= mk.sk) return;
  const int qpos = mk.q_offset + qr;
  if (mk.window > 0 && qpos >= mk.sk + mk.window - 1) {  // sees no key
    p = mk.inv_sk;
    return;
  }
  bool ok = true;
  if (mk.causal) ok = qpos >= kr;
  if (mk.window > 0) ok = ok && (qpos - kr) < mk.window;
  if (!ok) return;
  float sc = s * mk.scale;
  if (mk.softcap > 0.f) sc = tanhf(sc / mk.softcap) * mk.softcap;
  p = expf(sc - lse_r);
  ds = p * (dp - d_r);
  if (mk.softcap > 0.f) {
    const float t = sc / mk.softcap;
    ds *= 1.f - t * t;
  }
  ds *= mk.scale;
}

// ------------------------------------------------------------- kernel 1

// D[b, h, r] = sum_d dO * O, one warp a row
template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
bw_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, Strides so, Strides sd, int h,
                int sq, int hd, long long rows) {
  const long long n = (long long)blockIdx.x * BW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= rows) return;
  const int r = (int)(n % sq);
  const int head = (int)((n / sq) % h);
  const long long bb = n / ((long long)sq * h);
  const T* op = o + bb * so.b + head * so.h + r * so.s;
  const T* dp = dout + bb * sd.b + head * sd.h + r * sd.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(att_load<T>(op + d), att_load<T>(dp + d), acc);
  acc = att_warp_sum(acc);
  if (lane == 0) delta[n] = acc;
}

// ------------------------------------------------------------- kernel 2

template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS)
bw_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, BwStrides st, int h,
               int kh, BwMask mk) {
  using S = Bw<HD>;
  constexpr int LD = S::LD, DPL = S::DPL;
  extern __shared__ __align__(16) float bw_smem[];
  float* qs = bw_smem;                 // [32][LD]
  float* dos = qs + BW_T * LD;         // [32][LD]
  float* ks = dos + BW_T * LD;         // [32][LD]
  float* vs = ks + BW_T * LD;          // [32][LD]
  float* ps = vs + BW_T * LD;          // [32 rows][33]
  float* dss = ps + BW_T * BW_PS;      // [32 rows][33]
  float* lse_s = dss + BW_T * BW_PS;   // [32]
  float* d_s = lse_s + BW_T;           // [32]

  const int k0 = blockIdx.x * BW_T;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = h / kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  bw_load<T, HD>(ks, k + bb * st.k.b + kvh * st.k.h, st.k.s, k0, mk.sk, tid);
  bw_load<T, HD>(vs, v + bb * st.v.b + kvh * st.v.h, st.v.s, k0, mk.sk, tid);

  // query rows that can see a key of this tile: causal lower bound, window
  // upper bound; rows that see no key (window) weigh every key, so their
  // range runs to sq
  const int k_last = min(k0 + BW_T, mk.sk) - 1;
  int r_lo = mk.causal ? max(0, k0 - mk.q_offset) : 0;
  r_lo = (r_lo / BW_T) * BW_T;
  int r_hi = mk.sq;
  if (mk.window > 0 && mk.sk + mk.window - 1 - mk.q_offset >= mk.sq)
    r_hi = min(mk.sq, k_last + mk.window - mk.q_offset);

  float acc_k[BW_KW][DPL], acc_v[BW_KW][DPL];
#pragma unroll
  for (int j = 0; j < BW_KW; ++j)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc_k[j][t] = acc_v[j][t] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int head = kvh * g + hh;
    const T* qp = q + bb * st.q.b + head * st.q.h;
    const T* dop = dout + bb * st.dout.b + head * st.dout.h;
    const long long row_base = ((long long)bb * h + head) * mk.sq;
    for (int q0 = r_lo; q0 < r_hi; q0 += BW_T) {
      __syncthreads();  // the previous tile fully read
      bw_load<T, HD>(qs, qp, st.q.s, q0, mk.sq, tid);
      bw_load<T, HD>(dos, dop, st.dout.s, q0, mk.sq, tid);
      if (tid < BW_T) {
        const bool live = q0 + tid < mk.sq;
        lse_s[tid] = live ? lse[row_base + q0 + tid] : 0.f;
        d_s[tid] = live ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[BW_KW], dp[BW_KW];
      bw_scores<HD>(qs, dos, ks, vs, lane, warp, s, dp);
#pragma unroll
      for (int i = 0; i < BW_KW; ++i) {
        const int kr = warp + BW_WARPS * i;
        float p, ds;
        bw_p_ds(mk, q0 + lane, k0 + kr, s[i], dp[i], lse_s[lane], d_s[lane],
                p, ds);
        ps[lane * BW_PS + kr] = p;
        dss[lane * BW_PS + kr] = ds;
      }
      __syncthreads();
      // dV[key] += P[row, key] dO[row], dK[key] += dS[row, key] Q[row]
      for (int r = 0; r < BW_T; ++r) {
        float pj[BW_KW], dsj[BW_KW];
#pragma unroll
        for (int j = 0; j < BW_KW; ++j) {
          pj[j] = ps[r * BW_PS + warp + BW_WARPS * j];
          dsj[j] = dss[r * BW_PS + warp + BW_WARPS * j];
        }
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (HD % 32 != 0 && d >= HD) continue;
          const float o = dos[r * LD + d];
          const float a = qs[r * LD + d];
#pragma unroll
          for (int j = 0; j < BW_KW; ++j) {
            acc_v[j][t] = fmaf(pj[j], o, acc_v[j][t]);
            acc_k[j][t] = fmaf(dsj[j], a, acc_k[j][t]);
          }
        }
      }
    }
  }

  T* dkp = dk + bb * st.dk.b + kvh * st.dk.h;
  T* dvp = dv + bb * st.dv.b + kvh * st.dv.h;
#pragma unroll
  for (int j = 0; j < BW_KW; ++j) {
    const int kr = k0 + warp + BW_WARPS * j;
    if (kr >= mk.sk) continue;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (HD % 32 != 0 && d >= HD) continue;
      att_store<T>(dkp + kr * st.dk.s + d, acc_k[j][t]);
      att_store<T>(dvp + kr * st.dv.s + d, acc_v[j][t]);
    }
  }
}

// ------------------------------------------------------------- kernel 3

template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS)
bw_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, BwStrides st, int h, int kh, BwMask mk) {
  using S = Bw<HD>;
  constexpr int LD = S::LD, DPL = S::DPL;
  extern __shared__ __align__(16) float bw_smem[];
  float* qs = bw_smem;
  float* dos = qs + BW_T * LD;
  float* ks = dos + BW_T * LD;
  float* vs = ks + BW_T * LD;
  float* dss = vs + BW_T * LD + BW_T * BW_PS;  // [32 rows][33]
  float* lse_s = dss + BW_T * BW_PS;
  float* d_s = lse_s + BW_T;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BW_T;  // heaviest first
  const int head = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = head / (h / kh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_base = ((long long)bb * h + head) * mk.sq;

  bw_load<T, HD>(qs, q + bb * st.q.b + head * st.q.h, st.q.s, q0, mk.sq, tid);
  bw_load<T, HD>(dos, dout + bb * st.dout.b + head * st.dout.h, st.dout.s, q0,
                 mk.sq, tid);
  if (tid < BW_T) {
    const bool live = q0 + tid < mk.sq;
    lse_s[tid] = live ? lse[row_base + q0 + tid] : 0.f;
    d_s[tid] = live ? delta[row_base + q0 + tid] : 0.f;
  }

  // the forward's key bounds of this tile (a tile with a row that sees no
  // key walks every key; such a row's dS is 0)
  const int q_first = mk.q_offset + q0;
  const int q_last = mk.q_offset + min(q0 + BW_T, mk.sq) - 1;
  const bool blind = mk.window > 0 && q_last >= mk.sk + mk.window - 1;
  const int kv_hi = mk.causal ? min(mk.sk, q_last + 1) : mk.sk;
  int kv_lo = mk.window > 0 && !blind ? max(0, q_first - mk.window + 1) : 0;
  kv_lo = (kv_lo / BW_T) * BW_T;

  const T* kp = k + bb * st.k.b + kvh * st.k.h;
  const T* vp = v + bb * st.v.b + kvh * st.v.h;
  float acc[BW_KW][DPL];
#pragma unroll
  for (int j = 0; j < BW_KW; ++j)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[j][t] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BW_T) {
    __syncthreads();  // Q staged / the previous tile fully read
    bw_load<T, HD>(ks, kp, st.k.s, k0, mk.sk, tid);
    bw_load<T, HD>(vs, vp, st.v.s, k0, mk.sk, tid);
    __syncthreads();
    float s[BW_KW], dp[BW_KW];
    bw_scores<HD>(qs, dos, ks, vs, lane, warp, s, dp);
#pragma unroll
    for (int i = 0; i < BW_KW; ++i) {
      const int kr = warp + BW_WARPS * i;
      float p, ds;
      bw_p_ds(mk, q0 + lane, k0 + kr, s[i], dp[i], lse_s[lane], d_s[lane], p,
              ds);
      dss[lane * BW_PS + kr] = ds;
    }
    __syncthreads();
    // dQ[row] += dS[row, key] K[key]
    for (int c = 0; c < BW_T; ++c) {
      float dsj[BW_KW];
#pragma unroll
      for (int j = 0; j < BW_KW; ++j)
        dsj[j] = dss[(warp + BW_WARPS * j) * BW_PS + c];
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (HD % 32 != 0 && d >= HD) continue;
        const float kk = ks[c * LD + d];
#pragma unroll
        for (int j = 0; j < BW_KW; ++j) acc[j][t] = fmaf(dsj[j], kk, acc[j][t]);
      }
    }
  }

  T* dqp = dq + bb * st.dq.b + head * st.dq.h;
#pragma unroll
  for (int j = 0; j < BW_KW; ++j) {
    const int r = q0 + warp + BW_WARPS * j;
    if (r >= mk.sq) continue;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (HD % 32 != 0 && d >= HD) continue;
      att_store<T>(dqp + r * st.dq.s + d, acc[j][t]);
    }
  }
}


// ------------------------------------------------- bf16 tensor cores

using bf16 = __nv_bfloat16;

constexpr int BT = 64;              // keys (dK/dV) or query rows (dQ) of a
                                    // CTA, and rows of each streamed tile
constexpr int BT_PS = BT + 8;       // bf16 pitch of the P^T / dS tiles

template <int HD>
struct Bt {
  static constexpr int LDS = HD + 8;    // bf16 row pitch
  static constexpr int CH = HD / 8;     // 16-byte chunks a row
  static constexpr int HW = HD / 2;     // head dims a warp accumulates
  static constexpr int OT = HW / 8;     // their 8-wide n-tiles
  // four [64][LDS] tiles, two [64][72] P^T / dS tiles, lse and D
  static constexpr size_t smem =
      sizeof(bf16) * (4 * BT * LDS + 2 * BT * BT_PS) + sizeof(float) * 2 * BT;
};

// rows [r0, r0 + 64) of one head into a [64][LDS] tile (16-byte copies;
// rows past n are zero)
template <int HD>
__device__ __forceinline__ void bt_load(bf16* dst, const bf16* src,
                                        long long row_stride, int r0, int n,
                                        int tid) {
  using S = Bt<HD>;
  for (int c = tid; c < BT * S::CH; c += BW_THREADS) {
    const int r = c / S::CH, ch = c % S::CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * S::LDS + ch * 8) = x;
  }
}

// c1 = A1 B1^T and c2 = A2 B2^T over the head dim, each [16 x 32]: A rows
// [a0, a0 + 16) of a1 / a2, B rows [b0, b0 + 32) of b1 / b2 (all [64][LDS]
// tiles); accumulator n-tile j holds B rows b0 + 8 j ...
template <int HD>
__device__ __forceinline__ void bt_products(const bf16* a1, const bf16* b1,
                                            const bf16* a2, const bf16* b2,
                                            int a0, int b0, int lane,
                                            float (&c1)[4][4],
                                            float (&c2)[4][4]) {
  constexpr int LDS = Bt<HD>::LDS;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
  const int a_off = (a0 + (lane & 15)) * LDS + (lane >> 4) * 8;
  const int b_off = (b0 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                    ((lane >> 3) & 1) * 8;
  const uint32_t pa1 = smem_u32(a1 + a_off), pa2 = smem_u32(a2 + a_off);
  const uint32_t pb1 = smem_u32(b1 + b_off), pb2 = smem_u32(b2 + b_off);
#pragma unroll 4
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t f1[4], f2[4];
    ldsm_x4(f1, pa1 + kk * 16 * sizeof(bf16));
    ldsm_x4(f2, pa2 + kk * 16 * sizeof(bf16));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const uint32_t off = (np * 16 * LDS + kk * 16) * sizeof(bf16);
      uint32_t b[4];
      ldsm_x4(b, pb1 + off);
      mma_bf16(c1[2 * np], f1, b[0], b[1]);
      mma_bf16(c1[2 * np + 1], f1, b[2], b[3]);
      ldsm_x4(b, pb2 + off);
      mma_bf16(c2[2 * np], f2, b[0], b[1]);
      mma_bf16(c2[2 * np + 1], f2, b[2], b[3]);
    }
  }
}

// acc[OT][4] += A . B over 64 rows: A the [64][72] bf16 tile `a` (rows
// [a0, a0 + 16), columns = the summed index), B the [64][LDS] tile `b`
// (rows = the summed index, head dims [d0, d0 + HD / 2)); two of them
template <int HD>
__device__ __forceinline__ void bt_accumulate(const bf16* a1, const bf16* b1,
                                              const bf16* a2, const bf16* b2,
                                              int a0, int d0, int lane,
                                              float (&acc1)[Bt<HD>::OT][4],
                                              float (&acc2)[Bt<HD>::OT][4]) {
  using S = Bt<HD>;
  constexpr int LDS = S::LDS, OT = S::OT;
  const int a_off = (a0 + (lane & 15)) * BT_PS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + d0 +
                    (lane >> 4) * 8;
  const uint32_t pa1 = smem_u32(a1 + a_off), pa2 = smem_u32(a2 + a_off);
  const uint32_t pb1 = smem_u32(b1 + b_off), pb2 = smem_u32(b2 + b_off);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t f1[4], f2[4];
    ldsm_x4(f1, pa1 + kk * 16 * sizeof(bf16));
    ldsm_x4(f2, pa2 + kk * 16 * sizeof(bf16));
    const uint32_t row = kk * 16 * LDS * sizeof(bf16);
#pragma unroll
    for (int dp = 0; dp < OT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, pb1 + row + dp * 16 * sizeof(bf16));
      mma_bf16(acc1[2 * dp], f1, b[0], b[1]);
      mma_bf16(acc1[2 * dp + 1], f1, b[2], b[3]);
      ldsm_x4_t(b, pb2 + row + dp * 16 * sizeof(bf16));
      mma_bf16(acc2[2 * dp], f2, b[0], b[1]);
      mma_bf16(acc2[2 * dp + 1], f2, b[2], b[3]);
    }
    if constexpr (OT % 2 == 1) {  // hd 80: one n-tile left
      uint32_t b[2];
      ldsm_x2_t(b, pb1 + row + (OT / 2) * 16 * sizeof(bf16));
      mma_bf16(acc1[OT - 1], f1, b[0], b[1]);
      ldsm_x2_t(b, pb2 + row + (OT / 2) * 16 * sizeof(bf16));
      mma_bf16(acc2[OT - 1], f2, b[0], b[1]);
    }
  }
}

// acc[OT][4] += A . B, one product (dQ's)
template <int HD>
__device__ __forceinline__ void bt_accumulate_one(const bf16* a, const bf16* b,
                                                  int a0, int d0, int lane,
                                                  float (&acc)[Bt<HD>::OT][4]) {
  using S = Bt<HD>;
  constexpr int LDS = S::LDS, OT = S::OT;
  const uint32_t pa = smem_u32(a + (a0 + (lane & 15)) * BT_PS + (lane >> 4) * 8);
  const uint32_t pb = smem_u32(b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                               d0 + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t f[4];
    ldsm_x4(f, pa + kk * 16 * sizeof(bf16));
    const uint32_t row = kk * 16 * LDS * sizeof(bf16);
#pragma unroll
    for (int dp = 0; dp < OT / 2; ++dp) {
      uint32_t bb[4];
      ldsm_x4_t(bb, pb + row + dp * 16 * sizeof(bf16));
      mma_bf16(acc[2 * dp], f, bb[0], bb[1]);
      mma_bf16(acc[2 * dp + 1], f, bb[2], bb[3]);
    }
    if constexpr (OT % 2 == 1) {
      uint32_t bb[2];
      ldsm_x2_t(bb, pb + row + (OT / 2) * 16 * sizeof(bf16));
      mma_bf16(acc[OT - 1], f, bb[0], bb[1]);
    }
  }
}

// rows [r0, r0 + 16) x head dims [d0, d0 + HD / 2) of an accumulator into
// out (bf16, row stride rs); rows past n are not written
template <int HD>
__device__ __forceinline__ void bt_store(bf16* out, long long rs, int r0,
                                         int d0, int n, int lane,
                                         const float (&acc)[Bt<HD>::OT][4]) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    bf16* o = out + row * rs + d0 + 2 * tg;
#pragma unroll
    for (int d = 0; d < Bt<HD>::OT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(BW_THREADS)
bt_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, BwStrides st,
               int h, int kh, BwMask mk) {
  using S = Bt<HD>;
  constexpr int LDS = S::LDS, OT = S::OT;
  extern __shared__ __align__(16) unsigned char bt_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bt_smem);   // [64][LDS] keys
  bf16* vs = ks + BT * LDS;
  bf16* qs = vs + BT * LDS;                      // [64][LDS] query rows
  bf16* dos = qs + BT * LDS;
  bf16* pt = dos + BT * LDS;                     // [64 keys][72] P^T
  bf16* dst = pt + BT * BT_PS;                   // [64 keys][72] dS^T
  float* lse_s = reinterpret_cast<float*>(dst + BT * BT_PS);
  float* d_s = lse_s + BT;

  const int k0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = h / kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = 16 * (warp % 4);      // this warp's 16 keys
  const int cw = warp / 4;             // its query half / head-dim half
  const int lg = lane >> 2, tg = lane & 3;

  bt_load<HD>(ks, k + bb * st.k.b + kvh * st.k.h, st.k.s, k0, mk.sk, tid);
  bt_load<HD>(vs, v + bb * st.v.b + kvh * st.v.h, st.v.s, k0, mk.sk, tid);

  const int k_last = min(k0 + BT, mk.sk) - 1;
  int r_lo = mk.causal ? max(0, k0 - mk.q_offset) : 0;
  r_lo = (r_lo / BT) * BT;
  int r_hi = mk.sq;
  if (mk.window > 0 && mk.sk + mk.window - 1 - mk.q_offset >= mk.sq)
    r_hi = min(mk.sq, k_last + mk.window - mk.q_offset);

  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int d = 0; d < OT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int head = kvh * g + hh;
    const bf16* qp = q + bb * st.q.b + head * st.q.h;
    const bf16* dop = dout + bb * st.dout.b + head * st.dout.h;
    const long long row_base = ((long long)bb * h + head) * mk.sq;
    for (int q0 = r_lo; q0 < r_hi; q0 += BT) {
      __syncthreads();  // the previous tiles fully read
      bt_load<HD>(qs, qp, st.q.s, q0, mk.sq, tid);
      bt_load<HD>(dos, dop, st.dout.s, q0, mk.sq, tid);
      if (tid < BT) {
        const bool live = q0 + tid < mk.sq;
        lse_s[tid] = live ? lse[row_base + q0 + tid] : 0.f;
        d_s[tid] = live ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: keys rw + lg (+ 8), queries 32 cw + 8 j + 2 tg (+ 1)
      float s[4][4], dp[4][4];
      bt_products<HD>(ks, qs, vs, dos, rw, 32 * cw, lane, s, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = rw + lg + 8 * r;
          const int qc = 32 * cw + 8 * j + 2 * tg;
          float p0, p1, d0, d1;
          bw_p_ds(mk, q0 + qc, k0 + kr, s[j][2 * r], dp[j][2 * r], lse_s[qc],
                  d_s[qc], p0, d0);
          bw_p_ds(mk, q0 + qc + 1, k0 + kr, s[j][2 * r + 1], dp[j][2 * r + 1],
                  lse_s[qc + 1], d_s[qc + 1], p1, d1);
          *reinterpret_cast<__nv_bfloat162*>(pt + kr * BT_PS + qc) =
              __floats2bfloat162_rn(p0, p1);
          *reinterpret_cast<__nv_bfloat162*>(dst + kr * BT_PS + qc) =
              __floats2bfloat162_rn(d0, d1);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 queries
      bt_accumulate<HD>(pt, dos, dst, qs, rw, cw * S::HW, lane, acc_v, acc_k);
    }
  }
  bt_store<HD>(dk + bb * st.dk.b + kvh * st.dk.h, st.dk.s, k0 + rw,
               cw * S::HW, mk.sk, lane, acc_k);
  bt_store<HD>(dv + bb * st.dv.b + kvh * st.dv.h, st.dv.s, k0 + rw,
               cw * S::HW, mk.sk, lane, acc_v);
}

template <int HD>
__global__ void __launch_bounds__(BW_THREADS)
bt_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, BwStrides st, int h, int kh, BwMask mk) {
  using S = Bt<HD>;
  constexpr int LDS = S::LDS, OT = S::OT;
  extern __shared__ __align__(16) unsigned char bt_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bt_smem);   // [64][LDS] query rows
  bf16* dos = qs + BT * LDS;
  bf16* ks = dos + BT * LDS;                     // [64][LDS] keys
  bf16* vs = ks + BT * LDS;
  bf16* dss = vs + BT * LDS;                     // [64 rows][72] dS
  float* lse_s = reinterpret_cast<float*>(dss + 2 * BT * BT_PS);
  float* d_s = lse_s + BT;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heaviest first
  const int head = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = head / (h / kh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = 16 * (warp % 4);
  const int cw = warp / 4;
  const int lg = lane >> 2, tg = lane & 3;
  const long long row_base = ((long long)bb * h + head) * mk.sq;

  bt_load<HD>(qs, q + bb * st.q.b + head * st.q.h, st.q.s, q0, mk.sq, tid);
  bt_load<HD>(dos, dout + bb * st.dout.b + head * st.dout.h, st.dout.s, q0,
              mk.sq, tid);
  if (tid < BT) {
    const bool live = q0 + tid < mk.sq;
    lse_s[tid] = live ? lse[row_base + q0 + tid] : 0.f;
    d_s[tid] = live ? delta[row_base + q0 + tid] : 0.f;
  }

  const int q_first = mk.q_offset + q0;
  const int q_last = mk.q_offset + min(q0 + BT, mk.sq) - 1;
  const bool blind = mk.window > 0 && q_last >= mk.sk + mk.window - 1;
  const int kv_hi = mk.causal ? min(mk.sk, q_last + 1) : mk.sk;
  int kv_lo = mk.window > 0 && !blind ? max(0, q_first - mk.window + 1) : 0;
  kv_lo = (kv_lo / BT) * BT;

  const bf16* kp = k + bb * st.k.b + kvh * st.k.h;
  const bf16* vp = v + bb * st.v.b + kvh * st.v.h;
  float acc[OT][4];
#pragma unroll
  for (int d = 0; d < OT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BT) {
    __syncthreads();  // Q staged / the previous tiles fully read
    bt_load<HD>(ks, kp, st.k.s, k0, mk.sk, tid);
    bt_load<HD>(vs, vp, st.v.s, k0, mk.sk, tid);
    __syncthreads();
    // S and dP: rows rw + lg (+ 8), keys 32 cw + 8 j + 2 tg (+ 1)
    float s[4][4], dp[4][4];
    bt_products<HD>(qs, ks, dos, vs, rw, 32 * cw, lane, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = rw + lg + 8 * r;
        const int kc = 32 * cw + 8 * j + 2 * tg;
        float p0, p1, d0, d1;
        bw_p_ds(mk, q0 + qr, k0 + kc, s[j][2 * r], dp[j][2 * r], lse_s[qr],
                d_s[qr], p0, d0);
        bw_p_ds(mk, q0 + qr, k0 + kc + 1, s[j][2 * r + 1], dp[j][2 * r + 1],
                lse_s[qr], d_s[qr], p1, d1);
        *reinterpret_cast<__nv_bfloat162*>(dss + qr * BT_PS + kc) =
            __floats2bfloat162_rn(d0, d1);
      }
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
    bt_accumulate_one<HD>(dss, ks, rw, cw * S::HW, lane, acc);
  }
  bt_store<HD>(dq + bb * st.dq.b + head * st.dq.h, st.dq.s, q0 + rw,
               cw * S::HW, mk.sq, lane, acc);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  BwStrides st;
  int b, h, kh;
  BwMask mk;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_dkdv(const Args& a) {
  cudaError_t err = att_smem_attr(bw_dkdv_kernel<T, HD>, Bw<HD>::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.mk.sk + BW_T - 1) / BW_T, a.kh, a.b);
  bw_dkdv_kernel<T, HD><<<grid, BW_THREADS, Bw<HD>::smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.st, a.h, a.kh, a.mk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const Args& a) {
  cudaError_t err = att_smem_attr(bw_dq_kernel<T, HD>, Bw<HD>::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.mk.sq + BW_T - 1) / BW_T, a.h, a.b);
  bw_dq_kernel<T, HD><<<grid, BW_THREADS, Bw<HD>::smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dq, a.st, a.h, a.kh, a.mk);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const Args& a, bool dkdv) {
  cudaError_t err = dkdv ? att_smem_attr(bt_dkdv_kernel<HD>, Bt<HD>::smem)
                         : att_smem_attr(bt_dq_kernel<HD>, Bt<HD>::smem);
  if (err != cudaSuccess) return (int)err;
  if (dkdv) {
    dim3 grid((a.mk.sk + BT - 1) / BT, a.kh, a.b);
    bt_dkdv_kernel<HD><<<grid, BW_THREADS, Bt<HD>::smem, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse, a.delta, (bf16*)a.dk, (bf16*)a.dv, a.st,
        a.h, a.kh, a.mk);
  } else {
    dim3 grid((a.mk.sq + BT - 1) / BT, a.h, a.b);
    bt_dq_kernel<HD><<<grid, BW_THREADS, Bt<HD>::smem, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse, a.delta, (bf16*)a.dq, a.st, a.h, a.kh,
        a.mk);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int hd, bool dkdv) {
  switch (hd) {
#define BW_CASE(HD) \
    case HD: return dkdv ? launch_dkdv<T, HD>(a) : launch_dq<T, HD>(a);
    BW_CASE(8) BW_CASE(16) BW_CASE(32) BW_CASE(64) BW_CASE(80) BW_CASE(128)
    BW_CASE(256)
#undef BW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int b, int h, int kh, int sq, int sk, int hd, int dtype, float scale,
        int causal, int window, float softcap, int q_offset,
        const long long* s, void* stream, bool dkdv) {
  if (sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, lse, delta, dq, dk, dv,
            {{s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
             {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
             {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
             {s[21], s[22], s[23]}},
            b, h, kh,
            {scale, softcap, 1.f / (float)sk, sq, sk, causal, window,
             q_offset},
            (cudaStream_t)stream};
  if (dtype == ATT_F32) return dispatch<float>(a, hd, dkdv);
  if (dtype == ATT_BF16) {   // tensor cores from head dim 32 on
    switch (hd) {
      case 32: return launch_tc<32>(a, dkdv);
      case 64: return launch_tc<64>(a, dkdv);
      case 80: return launch_tc<80>(a, dkdv);
      case 128: return launch_tc<128>(a, dkdv);
      case 256: return launch_tc<256>(a, dkdv);
      default: return dispatch<__nv_bfloat16>(a, hd, dkdv);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// D [b, h, sq] fp32 (contiguous) = rowsum(dO * O); o and dout [b, h, sq,
// hd] of one dtype (0 fp32, 1 bf16), head dim contiguous; strides: the
// batch, head and sequence element strides of o, then of dout.
REPRO_EXPORT int flash_attention_bwd_delta(const void* o, const void* dout,
                                           float* delta, int b, int h, int sq,
                                           int hd, int dtype,
                                           const long long* s, void* stream) {
  if (sq <= 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * h * sq;
  const Strides so = {s[0], s[1], s[2]}, sd = {s[3], s[4], s[5]};
  const unsigned blocks = (unsigned)((rows + BW_WARPS - 1) / BW_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    bw_delta_kernel<float><<<blocks, BW_THREADS, 0, st>>>(
        (const float*)o, (const float*)dout, delta, so, sd, h, sq, hd, rows);
  else if (dtype == ATT_BF16)
    bw_delta_kernel<__nv_bfloat16><<<blocks, BW_THREADS, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, so, sd, h,
        sq, hd, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dK, dV [b, kh, sk, hd] (summed over each kv head's query heads) from q
// [b, h, sq, hd], k/v [b, kh, sk, hd], dout [b, h, sq, hd], lse and delta
// [b, h, sq] fp32 contiguous; every tensor of one dtype with its head dim
// contiguous; strides: 24 element strides (batch, head, sequence) of q, k,
// v, o (unused), dout, dq (unused), dk, dv. hd in {8, 16, 32, 64, 80, 128,
// 256}; the mask arguments are the forward's.
REPRO_EXPORT int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int h,
    int kh, int sq, int sk, int hd, int dtype, float scale, int causal,
    int window, float softcap, int q_offset, const long long* strides,
    void* stream) {
  return run(q, k, v, dout, lse, delta, nullptr, dk, dv, b, h, kh, sq, sk,
             hd, dtype, scale, causal, window, softcap, q_offset, strides,
             stream, true);
}

// dQ [b, h, sq, hd]: the same arguments as flash_attention_bwd_dkdv.
REPRO_EXPORT int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int b, int h, int kh,
    int sq, int sk, int hd, int dtype, float scale, int causal, int window,
    float softcap, int q_offset, const long long* strides, void* stream) {
  return run(q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, h, kh, sq,
             sk, hd, dtype, scale, causal, window, softcap, q_offset,
             strides, stream, false);
}
