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
//     scheduled first (in dK/dV the key tiles that the most queries see).
//
// bf16 at head dims 32-256 (tc_*_kernel): Hopper warpgroups (wgmma.cuh).
// A CTA is two warpgroups (256 threads, so each may hold 255 registers: a
// third warpgroup, or a lone producer warp, holds the block to 168, and
// ptxas did not hand a setmaxnreg consumer more). Tiles stream through a
// ring of shared-memory stages by TMA (one 4-d map per tensor over its
// batch, head and sequence strides; a tile's ragged tail arrives
// zero-filled) and mbarriers: warp 0 refills a stage once both
// warpgroups have read it (lane 0 issues, predicated inside the
// instruction, so no branch splits a warp that issues wgmma), and reads
// the rows' lse and D of a refill one step ahead (4-byte cp.async: a TMA
// box must start on 16 bytes, and a head's rows start anywhere).
//   * dK/dV: the CTA's keys (K, V) stay in shared memory; each stage
//     holds 64 query rows of Q and dO with their lse and D. S^T = K Q^T
//     and dP^T = V dO^T are wgmma from shared memory (keys the M rows);
//     P^T and dS^T are formed in the accumulators and go, rounded to
//     bf16, straight into the A registers of dV += P^T dO and dK += dS^T Q
//     (B = dO, Q read MN-major from the same stage).
//   * dQ: the CTA's rows (Q, dO, lse, D) stay; each stage holds 64 keys of
//     K and V. S = Q K^T and dP = dO V^T from shared memory, dS in
//     registers into dQ += dS K (K read MN-major).
//   * Tile plan (Tc<HD>): head dims 32-128 give each consumer warpgroup
//     64 of the CTA's 128 keys (dK/dV) or rows (dQ), with dK and dV (hd
//     fp32 registers a thread) or dQ in its registers; at hd 128 dK/dV
//     takes a stage's 64 queries in two halves of 32, so that S^T and
//     dP^T fit beside dK and dV without a spill. At hd 256 dK and
//     dV would take 256 registers a thread, so the CTA holds 64 keys and
//     the warpgroups split S^T's queries (32 each) and dK/dV's head dims
//     (128 each); P^T and dS^T then go through shared memory (one
//     [64][64] bf16 tile each, between two named barriers). dQ at hd 256:
//     64 rows, the warpgroups split each stage's keys (32 each) and add
//     their partial dQ once, in one order, at the end. Stages: as many as
//     fit in 227 KB, at most 4 (2 at hd 256).
//   * Layouts: every tile is stored in atoms of the swizzle its rows fit
//     (wgmma.cuh): 128-byte atoms of 64 head dims, and a tail atom for hd
//     80 (16 head dims, 32-byte swizzle: zamba2's 160-byte rows are no
//     multiple of 128) and hd 32 (64-byte swizzle). TMA writes the
//     swizzle, so every head dim's tiles load by TMA; no cp.async.
//   * Rounding P and dS to bf16 for the second products is the one
//     rounding the plain version does not make (FA2 makes it too): each
//     term moves by 2^-9 relative, inside the 2e-2 bf16 tolerance. Tiles
//     wholly inside the mask skip its tests.
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
// dQ pass: 14 as written) at 989 TFLOP/s bf16; the SIMT kernels run them
// on the fp32 units from shared memory. The wgmma kernels run each
// product at the tensor cores' rate; what is left between them and the
// bound (PERF.md): warp 0 waits at the end of each step until the other
// warpgroup has read the stage (an instrumented build's largest wait), so
// the two warpgroups run in step, their products and elementwise work at
// the same time; the products of one warpgroup wait for its own P and dS;
// the split at hd 256 re-reads P^T from shared memory; the causal walk's
// last waves are uneven. Refilling each stage during the next step, which
// lets a warpgroup run ahead, measured slower (PERF.md): the load then has
// about half a step to land, not a whole one.
#include <cuda.h>
#include <string.h>

#include "attention_common.cuh"
#include "wgmma.cuh"   // and mma_bf16.cuh


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


// ------------------------------------------ bf16 warpgroup kernels (wgmma)

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 256;     // two warpgroups; thread 0 loads
constexpr int TC_CONSUMERS = 256;
constexpr int TC_T = 64;            // rows of every streamed tile
constexpr int TC_SMEM_MAX = 232448;

// the tile plan of a head dim
template <int HD>
struct Tc {
  static constexpr int NA = HD / 64;       // 128-byte-swizzle atoms a row
  static constexpr int TW = HD % 64;       // tail atom: 32 (64-byte
                                           // swizzle) or 16 (32-byte)
  // hd 256: the two warpgroups share the CTA's 64 keys (dK/dV: queries of
  // S^T split, head dims of dK and dV split, P^T and dS^T through shared
  // memory) or 64 rows (dQ: keys of each tile split, partial dQ summed
  // once at the end); below, each owns 64 of the CTA's 128
  static constexpr bool SPLIT = HD > 128;
  static constexpr int CN = SPLIT ? 64 : 128;  // keys (dK/dV) or query
                                               // rows (dQ) of a CTA
  static constexpr int NS = SPLIT ? 32 : 64;   // N of a warpgroup's S, dP
  // dK/dV at hd 128 takes a stage's queries in two halves, one after the
  // other: dK and dV hold 128 registers a thread, and S^T, dP^T of all 64
  // queries beside them spilled
  static constexpr int HALVES = HD == 128 ? 2 : 1;
  static constexpr int N0 = NA * 64;           // head dims in 128B atoms
  static constexpr int DKV_N0 = SPLIT ? N0 / 2 : N0;  // a warpgroup's
  static constexpr int TILE = TC_T * HD * 2;   // bytes of a 64-row tile
  static constexpr int CTILE = CN * HD * 2;    // bytes of a CTA's tile
  static constexpr int P_BYTES = SPLIT ? 2 * 64 * 64 * 2 : 0;  // P^T, dS^T
  static constexpr int SLACK = 1024 + 256;     // alignment, barriers
  // dK/dV: K, V resident; a stage holds Q, dO, lse and D
  // (+ one more slot of lse and D: the next refill's, read ahead)
  static constexpr int DKV_FIXED = 2 * CTILE + P_BYTES + SLACK + 2 * TC_T * 4;
  static constexpr int DKV_STAGE = 2 * TILE + 2 * TC_T * 4;
  static constexpr int DKV_STAGES =
      (TC_SMEM_MAX - DKV_FIXED) / DKV_STAGE > 4
          ? 4 : (TC_SMEM_MAX - DKV_FIXED) / DKV_STAGE;
  static constexpr int DKV_SMEM = DKV_FIXED + DKV_STAGES * DKV_STAGE;
  // dQ: Q, dO, lse and D resident; a stage holds K and V
  static constexpr int DQ_FIXED = 2 * CTILE + 2 * CN * 4 + SLACK;
  static constexpr int DQ_STAGE = 2 * TILE;
  static constexpr int DQ_STAGES =
      (TC_SMEM_MAX - DQ_FIXED) / DQ_STAGE > 4
          ? 4 : (TC_SMEM_MAX - DQ_FIXED) / DQ_STAGE;
  static constexpr int DQ_SMEM = DQ_FIXED + DQ_STAGES * DQ_STAGE;
  static_assert(DKV_STAGES >= 2 && DQ_STAGES >= 2, "a ring of two stages");
  static_assert(!SPLIT || DQ_STAGES * DQ_STAGE >= 64 * HD * 4,
                "dQ's partial sum fits the ring");
};

__host__ __device__ constexpr int tc_min(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int tc_max(int a, int b) { return a > b ? a : b; }

// The walk, shared by the kernels, the host's step count and (mirrored)
// kernels/flash_attention.py bwd_tile_walk. dK/dV: the query rows [lo,
// hi) a CTA of keys [k0, k0 + cn) walks, in 64-row tiles from lo (a
// multiple of 64): causal lower bound, window upper bound; rows that see
// no key weigh every key, so then the range runs to sq.
__host__ __device__ inline void tc_dkdv_rows(const BwMask& m, int k0, int cn,
                                             int& lo, int& hi) {
  const int k_last = tc_min(k0 + cn, m.sk) - 1;
  lo = m.causal ? tc_max(0, k0 - m.q_offset) : 0;
  lo = (lo / TC_T) * TC_T;
  hi = m.sq;
  if (m.window > 0 && m.sk + m.window - 1 - m.q_offset >= m.sq)
    hi = tc_min(m.sq, k_last + m.window - m.q_offset);
}

// dQ: the keys [lo, hi) a CTA of query rows [q0, q0 + cn) walks, in
// 64-key tiles from lo: the forward's bounds (a tile with a row that sees
// no key walks from key 0; such a row's dS is 0)
__host__ __device__ inline void tc_dq_keys(const BwMask& m, int q0, int cn,
                                           int& lo, int& hi) {
  const int q_first = m.q_offset + q0;
  const int q_last = m.q_offset + tc_min(q0 + cn, m.sq) - 1;
  const bool blind = m.window > 0 && q_last >= m.sk + m.window - 1;
  hi = m.causal ? tc_min(m.sk, q_last + 1) : m.sk;
  lo = m.window > 0 && !blind ? tc_max(0, q_first - m.window + 1) : 0;
  lo = (lo / TC_T) * TC_T;
}

__host__ __device__ inline int tc_tiles(int lo, int hi) {
  return hi > lo ? (hi - lo + TC_T - 1) / TC_T : 0;
}

// whether every (row, key) of rows [q0, q0 + nq) x keys [k0, k0 + nk) is
// visible and in range: then P and dS need no mask
__device__ __forceinline__ bool tc_full(const BwMask& m, int q0, int nq,
                                        int k0, int nk) {
  const int q_hi = q0 + nq - 1, k_hi = k0 + nk - 1;
  if (q_hi >= m.sq || k_hi >= m.sk) return false;
  const int p_lo = m.q_offset + q0, p_hi = m.q_offset + q_hi;
  if (m.window > 0 &&
      (p_hi >= m.sk + m.window - 1 || p_hi - k0 >= m.window))
    return false;
  return !m.causal || p_lo >= k_hi;
}

constexpr float TC_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float tc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^2x + 1): absolute error about 1e-7, so the capped
// score (tanh times the cap) moves by about 1e-5 at cap 50
__device__ __forceinline__ float tc_tanh(float x) {
  return 1.f - __fdividef(2.f, tc_exp2(2.f * TC_LOG2E * x) + 1.f);
}

// the elementwise step's constants, from the mask arguments
struct TcEw {
  float scale, scale_log2;   // scale, scale * log2(e)
  float cap_in, cap_out;     // scale / cap, cap * log2(e)
  float inv_sk;
  int sq, sk, causal, window, q_offset;
};

__device__ __forceinline__ TcEw tc_ew(const BwMask& m) {
  const float cap = m.softcap > 0.f ? m.softcap : 1.f;
  return {m.scale, m.scale * TC_LOG2E, m.scale / cap, cap * TC_LOG2E,
          m.inv_sk, m.sq, m.sk, m.causal, m.window, m.q_offset};
}

// P and dS of (query row qr, key kr) from the raw products s and dP, the
// row's lse in log2 units and its D, branch-free. CAP: the softcap is on;
// FULL: the tile needs no mask. The masks are bw_p_ds's (rows past sq
// and keys past sk give 0; a row that sees no key has P = 1 / sk, dS = 0).
template <bool CAP, bool FULL>
__device__ __forceinline__ void tc_pds(const TcEw& e, int qr, int kr,
                                       float s, float dp, float lse2,
                                       float d_r, float& p, float& ds) {
  float x, f;
  if constexpr (CAP) {
    const float t = tc_tanh(s * e.cap_in);
    x = t * e.cap_out;
    f = e.scale * (1.f - t * t);
  } else {
    x = s * e.scale_log2;
    f = e.scale;
  }
  p = tc_exp2(x - lse2);
  ds = p * (dp - d_r) * f;
  if constexpr (!FULL) {
    const int qpos = e.q_offset + qr;
    const bool in = qr < e.sq && kr < e.sk;
    const bool blind = e.window > 0 && qpos >= e.sk + e.window - 1;
    const bool vis = in && !blind && (!e.causal || qpos >= kr) &&
                     (e.window <= 0 || qpos - kr < e.window);
    p = vis ? p : (in && blind ? e.inv_sk : 0.f);
    ds = vis ? ds : 0.f;
  }
}

// one warpgroup's S^T / dP^T accumulators (keys kr0 (+ 8) x queries qc0 +
// 8 j (+ 1)) into P^T / dS^T in place; ls / dd: the lse (log2 units) and
// D of query column qc0 - q0 on
template <bool CAP, bool FULL, int N>
__device__ __forceinline__ void tc_ew_keys(const TcEw& e, float (&sa)[N],
                                           float (&pa)[N], int kr0, int qc0,
                                           const float* ls, const float* dd) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j);
    const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j);
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int i = 4 * j + c4, r = c4 / 2, c = c4 % 2;
      tc_pds<CAP, FULL>(e, qc0 + 8 * j + c, kr0 + 8 * r, sa[i], pa[i],
                        (c ? l2.y : l2.x) * TC_LOG2E, c ? d2.y : d2.x,
                        sa[i], pa[i]);
    }
  }
}

// one warpgroup's S / dP accumulators (rows qr0 (+ 8) x keys kc0 + 8 j
// (+ 1)) into dS in pa
template <bool CAP, bool FULL, int N>
__device__ __forceinline__ void tc_ew_rows(const TcEw& e, float (&sa)[N],
                                           float (&pa)[N], int qr0, int kc0,
                                           const float (&lse2)[2],
                                           const float (&d)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i / 4, r = (i / 2) % 2, c = i % 2;
    float p;
    tc_pds<CAP, FULL>(e, qr0 + 8 * r, kc0 + 8 * j + c, sa[i], pa[i],
                      lse2[r], d[r], p, pa[i]);
  }
}

// the four forms of a tile's elementwise step, picked once per tile
#define TC_EW_DISPATCH(cap, full, CALL) \
  do {                                  \
    if (cap) {                          \
      if (full) CALL(true, true);       \
      else CALL(true, false);           \
    } else {                            \
      if (full) CALL(false, true);      \
      else CALL(false, false);          \
    }                                   \
  } while (0)

// One tensor's TMA maps: 128-byte-swizzle boxes of 64 head dims (m[0])
// and the tail atom's box (m[1]), 64 rows each, over (head dim, sequence,
// head, batch).
struct TcMap {
  CUtensorMap m[2];
};
struct TcMaps {
  TcMap q, k, v, o;   // o: dO
};

// rows [row, row + 64) of one head into rows [r, r + 64) of an R-row tile
// (issued where `p`: one lane of a warp that runs it whole)
template <int HD>
__device__ __forceinline__ void tc_load(bool p, uint32_t tile, int R, int r,
                                        const TcMap& mp, int row, int head,
                                        int bb, uint32_t bar) {
  using P = Tc<HD>;
#pragma unroll
  for (int a = 0; a < P::NA; ++a)
    tma_load4_if(p, tile + a * R * 128 + r * 128, &mp.m[0], 64 * a, row,
                 head, bb, bar);
  if constexpr (P::TW > 0)
    tma_load4_if(p, tile + P::NA * R * 128 + r * P::TW * 2, &mp.m[1], P::N0,
                 row, head, bb, bar);
}

// 4 bytes global -> shared, asynchronously; 0 where !ok (src not read)
__device__ __forceinline__ void tc_cp4(uint32_t dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// K-major descriptor of k-step kk (head dims [16 kk, 16 kk + 16)) over
// rows [r0, r0 + 64) of an R-row tile
template <int HD>
__device__ __forceinline__ uint64_t tc_kdesc(uint32_t tile, int R, int r0,
                                             int kk) {
  using P = Tc<HD>;
  if (kk < P::NA * 4)
    return wg_desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32, 16,
                   1024, SWZ_128);
  constexpr int W = P::TW > 0 ? P::TW : 16;
  return wg_desc(tile + P::NA * R * 128 + r0 * W * 2 + (kk - P::NA * 4) * 32,
                 16, 8 * W * 2, swz_mode(W));
}

// The k-step descriptors of a resident tile from two base descriptors (its
// 128-byte atoms, its tail atom) and constant offsets, the bases pinned
// each step (pin): a loop holds two register pairs, not one a k-step
template <int HD, int R>
struct TcKDesc {
  uint64_t d0, d1;
  __device__ __forceinline__ TcKDesc(uint32_t tile, int r0)
      : d0(tc_kdesc<HD>(tile, R, r0, 0)),
        d1(tc_kdesc<HD>(tile, R, r0, Tc<HD>::NA * 4)) {}
  __device__ __forceinline__ void pin() {
    asm volatile("" : "+l"(d0), "+l"(d1));
  }
  __device__ __forceinline__ uint64_t operator()(int kk) const {
    constexpr int NA = Tc<HD>::NA;
    if (kk < NA * 4) return d0 + (((kk / 4) * R * 128 + (kk % 4) * 32) >> 4);
    return d1 + (((kk - NA * 4) * 32) >> 4);
  }
};

// MN-major descriptors over rows [r0, r0 + 16) of an R-row tile: the
// 128-byte atoms from atom a0 on (N up to 256: LBO steps an atom), and the
// tail atom
__device__ __forceinline__ uint64_t tc_mdesc0(uint32_t tile, int R, int r0,
                                              int a0) {
  return wg_desc(tile + a0 * R * 128 + r0 * 128, R * 128, 1024, SWZ_128);
}
template <int HD>
__device__ __forceinline__ uint64_t tc_mdesc1(uint32_t tile, int R, int r0) {
  constexpr int W = Tc<HD>::TW > 0 ? Tc<HD>::TW : 16;
  return wg_desc(tile + Tc<HD>::NA * R * 128 + r0 * W * 2, R * W * 2,
                 8 * W * 2, swz_mode(W));
}

// rows row0 (+ 8) x columns [c0, c0 + N) of a warpgroup accumulator into
// out (row stride rs); rows past n are not written
template <int N>
__device__ __forceinline__ void tc_store(bf16* out, long long rs, int row0,
                                         int c0, int n, int tg,
                                         const float (&d)[N / 2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* o = out + row * rs + c0 + 2 * tg;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void tc_zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// accumulators in registers, bf16 A fragments of k-step kk
template <int N>
__device__ __forceinline__ void tc_pack(const float (&d)[N],
                                        uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// the dK/dV pass: one CTA per (batch, kv head, CN keys), heaviest (causal:
// first keys) scheduled first
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
tc_dkdv_kernel(const __grid_constant__ TcMaps maps,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, BwStrides st,
               int h, int kh, BwMask m) {
  using P = Tc<HD>;
  constexpr int S = P::DKV_STAGES, NH = P::NS / P::HALVES;
  extern __shared__ unsigned char tc_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_k = smem_u32(base), s_v = s_k + P::CTILE;
  const uint32_t s_st = s_v + P::CTILE;              // stage i: Q, dO
  const uint32_t s_p = s_st + S * 2 * P::TILE;       // P^T, dS^T (SPLIT)
  float* lse_s = reinterpret_cast<float*>(base + 2 * P::CTILE +
                                          S * 2 * P::TILE + P::P_BYTES);
  float* d_s = lse_s + (S + 1) * TC_T;              // S + 1 slots each:
  const uint32_t bars = smem_u32(d_s + (S + 1) * TC_T);  // step j's is j %
  // (S + 1), so the slot a refill reads ahead into is one every warp is
  // done with; barriers: full, empty, kv
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t kv_bar = bars + 16 * S;

  const int kvh = blockIdx.x % kh, bb = blockIdx.x / kh;
  const int k0 = blockIdx.y * P::CN;
  const int g = h / kh;
  const int tid = threadIdx.x;
  int lo, hi;
  tc_dkdv_rows(m, k0, P::CN, lo, hi);
  const int nq = tc_tiles(lo, hi), steps = g * nq;
  // warp 0's loads of step it: the rows' lse and D into their slot (4-byte
  // cp.async, read a step ahead: fetch), then Q and dO into the step's
  // stage (load: lane 0 issues the TMA and arrives)
  const bool lead = tid == 0;
  const int lane0 = tid & 31;
  auto fetch = [&](int it) {
    const int head = kvh * g + it / nq, q0 = lo + (it % nq) * TC_T;
    const long long rb = ((long long)bb * h + head) * m.sq + q0;
    const int slot = (it % (S + 1)) * TC_T;
#pragma unroll
    for (int i = 0; i < TC_T / 32; ++i) {
      const int r = lane0 + 32 * i;
      const bool live = q0 + r < m.sq;
      tc_cp4(smem_u32(lse_s + slot + r), live ? lse + rb + r : lse, live);
      tc_cp4(smem_u32(d_s + slot + r), live ? delta + rb + r : delta, live);
    }
    cp_async_commit();
  };
  auto load = [&](int it) {
    const int head = kvh * g + it / nq, q0 = lo + (it % nq) * TC_T;
    const int s = it % S;
    const uint32_t bar = full_bar(s), tq = s_st + s * 2 * P::TILE;
    cp_async_wait<0>();   // this lane's lse and D of the step have landed
    __syncwarp();         // the warp's, before lane 0's arrival
    mbar_arrive_expect_if(lead, bar, 2 * P::TILE);
    tc_load<HD>(lead, tq, TC_T, 0, maps.q, q0, head, bb, bar);
    tc_load<HD>(lead, tq + P::TILE, TC_T, 0, maps.o, q0, head, bb, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 8);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {   // warp 0, in step
    mbar_arrive_expect_if(lead, kv_bar, 2 * P::CTILE);
    for (int r = 0; r < P::CN; r += TC_T) {
      tc_load<HD>(lead, s_k, P::CN, r, maps.k, k0 + r, kvh, bb, kv_bar);
      tc_load<HD>(lead, s_v, P::CN, r, maps.v, k0 + r, kvh, bb, kv_bar);
    }
    for (int it = 0; it < steps && it < S; ++it) {
      fetch(it);
      load(it);
    }
  }

  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32, lg = lane / 4, tg = lane % 4;
  const int key_off = P::SPLIT ? 0 : 64 * wg;   // this warpgroup's keys
  const int q_col = P::SPLIT ? 32 * wg : 0;     // and query columns
  constexpr int N0 = P::DKV_N0, N1 = P::TW;
  float acc_v0[N0 > 0 ? N0 / 2 : 1], acc_k0[N0 > 0 ? N0 / 2 : 1];
  float acc_v1[N1 > 0 ? N1 / 2 : 1], acc_k1[N1 > 0 ? N1 / 2 : 1];
  tc_zero(acc_v0); tc_zero(acc_k0); tc_zero(acc_v1); tc_zero(acc_k1);
  const TcEw ew = tc_ew(m);
  const bool cap = m.softcap > 0.f;
  TcKDesc<HD, P::CN> kd(s_k, key_off), vd(s_v, key_off);
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < steps; ++it) {
    const int q0 = lo + (it % nq) * TC_T;
    const int s = it % S;
    if (tid < 32 && it + S < steps) fetch(it + S);   // read ahead
    mbar_wait(full_bar(s), (it / S) & 1);
    const uint32_t tq = s_st + s * 2 * P::TILE, tdo = tq + P::TILE;
    const int slot = (it % (S + 1)) * TC_T;
#pragma unroll
    for (int hh = 0; hh < P::HALVES; ++hh) {
      // S^T = K Q^T, dP^T = V dO^T: keys (rows) x NH queries (columns)
      const int qh = q_col + hh * NH;
      float sa[NH / 2], pa[NH / 2];
      tc_zero(sa); tc_zero(pa);
      reg_fence(sa); reg_fence(pa);
      kd.pin(); vd.pin();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wg_ss<NH, 0>(sa, kd(kk), tc_kdesc<HD>(tq, TC_T, qh, kk));
        wg_ss<NH, 0>(pa, vd(kk), tc_kdesc<HD>(tdo, TC_T, qh, kk));
      }
      wg_commit();
      wg_wait0();
      reg_fence(sa); reg_fence(pa);
      // P^T and dS^T in place
      {
        const float* ls = lse_s + slot + qh + 2 * tg;   // natural log
        const float* dd = d_s + slot + qh + 2 * tg;
        const int kr0 = k0 + key_off + 16 * warp + lg;
        const int qc0 = q0 + qh + 2 * tg;
        const bool full = tc_full(m, q0 + qh, NH, k0 + key_off, 64);
#define TC_EW(CAP, FULL) \
  tc_ew_keys<CAP, FULL>(ew, sa, pa, kr0, qc0, ls, dd)
        TC_EW_DISPATCH(cap, full, TC_EW);
#undef TC_EW
      }
      if constexpr (!P::SPLIT) {
        // dV += P^T dO, dK += dS^T Q over these queries: A from registers,
        // B MN-major
        uint32_t fp[NH / 16][4], fd[NH / 16][4];
        tc_pack(sa, fp);
        tc_pack(pa, fd);
        reg_fence(fp); reg_fence(fd); reg_fence(acc_v0); reg_fence(acc_k0);
        reg_fence(acc_v1); reg_fence(acc_k1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NH / 16; ++kk) {
          const int r = qh + 16 * kk;
          if constexpr (N0 > 0) {
            wg_rs<N0, 1>(acc_v0, fp[kk], tc_mdesc0(tdo, TC_T, r, 0));
            wg_rs<N0, 1>(acc_k0, fd[kk], tc_mdesc0(tq, TC_T, r, 0));
          }
          if constexpr (N1 > 0) {
            wg_rs<N1, 1>(acc_v1, fp[kk], tc_mdesc1<HD>(tdo, TC_T, r));
            wg_rs<N1, 1>(acc_k1, fd[kk], tc_mdesc1<HD>(tq, TC_T, r));
          }
        }
        wg_commit();
        wg_wait0();
        reg_fence(acc_v0); reg_fence(acc_k0); reg_fence(acc_v1);
        reg_fence(acc_k1); reg_fence(fp); reg_fence(fd);
      } else {
        // P^T and dS^T [64 keys][64 queries] through shared memory (the
        // 128-byte swizzle that wgmma reads K-major), this warpgroup's 32
        // columns; then its half of the head dims over all 64 queries
        named_sync(1, TC_CONSUMERS);   // the previous tile's reads are done
        unsigned char* pt = base + (s_p - s_k);
#pragma unroll
        for (int j = 0; j < NH / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * warp + lg + 8 * r;
            const int off = row * 128 +
                            ((((qh >> 3) + j) ^ (row & 7)) << 4) + 4 * tg;
            const int i = 4 * j + 2 * r;
            *reinterpret_cast<uint32_t*>(pt + off) =
                pack_bf16(sa[i], sa[i + 1]);
            *reinterpret_cast<uint32_t*>(pt + 8192 + off) =
                pack_bf16(pa[i], pa[i + 1]);
          }
        fence_async_smem();
        named_sync(1, TC_CONSUMERS);
        reg_fence(acc_v0); reg_fence(acc_k0);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < TC_T / 16; ++kk) {
          const uint64_t ap = wg_desc(s_p + kk * 32, 16, 1024, SWZ_128);
          const uint64_t ad = wg_desc(s_p + 8192 + kk * 32, 16, 1024, SWZ_128);
          wg_ss<N0, 1>(acc_v0, ap, tc_mdesc0(tdo, TC_T, 16 * kk, 2 * wg));
          wg_ss<N0, 1>(acc_k0, ad, tc_mdesc0(tq, TC_T, 16 * kk, 2 * wg));
        }
        wg_commit();
        wg_wait0();
        reg_fence(acc_v0); reg_fence(acc_k0);
      }
    }
    mbar_arrive_if(lane == 0, empty_bar(s));   // the stage is read
    if (tid < 32 && it + S < steps) {   // warp 0 refills it once both
      mbar_wait(empty_bar(s), (it / S) & 1);   // warpgroups have read it
      load(it + S);
    }
  }

  bf16* dkp = dk + bb * st.dk.b + kvh * st.dk.h;
  bf16* dvp = dv + bb * st.dv.b + kvh * st.dv.h;
  const int row0 = k0 + key_off + 16 * warp + lg;
  const int c0 = P::SPLIT ? N0 * wg : 0;
  if constexpr (N0 > 0) {
    tc_store<N0>(dkp, st.dk.s, row0, c0, m.sk, tg, acc_k0);
    tc_store<N0>(dvp, st.dv.s, row0, c0, m.sk, tg, acc_v0);
  }
  if constexpr (N1 > 0) {
    tc_store<N1>(dkp, st.dk.s, row0, P::N0, m.sk, tg, acc_k1);
    tc_store<N1>(dvp, st.dv.s, row0, P::N0, m.sk, tg, acc_v1);
  }
}

// the dQ pass: one CTA per (batch, head, CN query rows), the rows that
// see the most keys scheduled first
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
tc_dq_kernel(const __grid_constant__ TcMaps maps,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, BwStrides st, int h, int kh, BwMask m) {
  using P = Tc<HD>;
  constexpr int S = P::DQ_STAGES, NS = P::NS;
  extern __shared__ unsigned char tc_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(base), s_o = s_q + P::CTILE;
  const uint32_t s_r = s_o + P::CTILE;               // stage i: K, V
  float* lse_s = reinterpret_cast<float*>(base + 2 * P::CTILE +
                                          S * 2 * P::TILE);
  float* d_s = lse_s + P::CN;
  const uint32_t bars = smem_u32(d_s + P::CN);       // full, empty, q
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t q_bar = bars + 16 * S;

  const int head = blockIdx.x % h, bb = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * P::CN;  // heaviest first
  const int kvh = head / (h / kh);
  const int tid = threadIdx.x;
  int lo, hi;
  tc_dq_keys(m, q0, P::CN, lo, hi);
  const int steps = tc_tiles(lo, hi);
  // warp 0's loads of step it into its stage (lane 0 issues): K, V
  const bool lead = tid == 0;
  auto load = [&](int it) {
    const int kt = lo + it * TC_T, s = it % S;
    const uint32_t bar = full_bar(s), tk = s_r + s * 2 * P::TILE;
    mbar_arrive_expect_if(lead, bar, 2 * P::TILE);
    tc_load<HD>(lead, tk, TC_T, 0, maps.k, kt, kvh, bb, bar);
    tc_load<HD>(lead, tk + P::TILE, TC_T, 0, maps.v, kt, kvh, bb, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 8);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {   // warp 0, in step: the rows' lse and D, then Q, dO
    const long long rb = ((long long)bb * h + head) * m.sq + q0;
    for (int i = tid; i < P::CN; i += 32) {
      const bool live = q0 + i < m.sq;
      lse_s[i] = live ? lse[rb + i] : 0.f;
      d_s[i] = live ? delta[rb + i] : 0.f;
    }
    __syncwarp();   // the warp's stores before lane 0's arrival
    mbar_arrive_expect_if(lead, q_bar, 2 * P::CTILE);
    for (int r = 0; r < P::CN; r += TC_T) {
      tc_load<HD>(lead, s_q, P::CN, r, maps.q, q0 + r, head, bb, q_bar);
      tc_load<HD>(lead, s_o, P::CN, r, maps.o, q0 + r, head, bb, q_bar);
    }
    for (int it = 0; it < steps && it < S; ++it) load(it);
  }

  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32, lg = lane / 4, tg = lane % 4;
  const int row_off = P::SPLIT ? 0 : 64 * wg;   // this warpgroup's rows
  const int key_off = P::SPLIT ? 32 * wg : 0;   // and keys of each tile
  constexpr int N0 = P::N0, N1 = P::TW;
  float acc0[N0 > 0 ? N0 / 2 : 1], acc1[N1 > 0 ? N1 / 2 : 1];
  tc_zero(acc0); tc_zero(acc1);
  mbar_wait(q_bar, 0);
  const int rl = row_off + 16 * warp + lg;      // rows rl, rl + 8
  const float lse_r[2] = {lse_s[rl] * TC_LOG2E, lse_s[rl + 8] * TC_LOG2E};
  const float d_r[2] = {d_s[rl], d_s[rl + 8]};
  const TcEw ew = tc_ew(m);
  const bool cap = m.softcap > 0.f;
  TcKDesc<HD, P::CN> qd(s_q, row_off), od(s_o, row_off);

  for (int it = 0; it < steps; ++it) {
    const int kt = lo + it * TC_T, s = it % S;
    mbar_wait(full_bar(s), (it / S) & 1);
    const uint32_t tk = s_r + s * 2 * P::TILE, tv = tk + P::TILE;
    // S = Q K^T, dP = dO V^T: rows x keys
    float sa[NS / 2], pa[NS / 2];
    tc_zero(sa); tc_zero(pa);
    reg_fence(sa); reg_fence(pa);
    qd.pin(); od.pin();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wg_ss<NS, 0>(sa, qd(kk), tc_kdesc<HD>(tk, TC_T, key_off, kk));
      wg_ss<NS, 0>(pa, od(kk), tc_kdesc<HD>(tv, TC_T, key_off, kk));
    }
    wg_commit();
    wg_wait0();
    reg_fence(sa); reg_fence(pa);
    const int kc0 = kt + key_off;
    const bool full = tc_full(m, q0 + row_off, 64, kc0, NS);
#define TC_EW(CAP, FULL) \
  tc_ew_rows<CAP, FULL>(ew, sa, pa, q0 + rl, kc0 + 2 * tg, lse_r, d_r)
    TC_EW_DISPATCH(cap, full, TC_EW);
#undef TC_EW
    // dQ += dS K: A from registers, B = K MN-major
    uint32_t fd[NS / 16][4];
    tc_pack(pa, fd);
    reg_fence(fd); reg_fence(acc0); reg_fence(acc1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      if constexpr (N0 > 0)
        wg_rs<N0, 1>(acc0, fd[kk], tc_mdesc0(tk, TC_T, key_off + 16 * kk, 0));
      if constexpr (N1 > 0)
        wg_rs<N1, 1>(acc1, fd[kk],
                     tc_mdesc1<HD>(tk, TC_T, key_off + 16 * kk));
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc0); reg_fence(acc1); reg_fence(fd);
    mbar_arrive_if(lane == 0, empty_bar(s));
    if (tid < 32 && it + S < steps) {   // warp 0 refills it once both
      mbar_wait(empty_bar(s), (it / S) & 1);   // warpgroups have read it
      load(it + S);
    }
  }

  bf16* dqp = dq + bb * st.dq.b + head * st.dq.h;
  if constexpr (P::SPLIT) {
    // the two warpgroups' partial sums over their keys, added in one
    // order through the (now idle) ring
    float* part = reinterpret_cast<float*>(base + 2 * P::CTILE);
    named_sync(1, TC_CONSUMERS);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i) part[i * 128 + t] = acc0[i];
    }
    named_sync(1, TC_CONSUMERS);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < N0 / 2; ++i) acc0[i] += part[i * 128 + t];
  }
  if constexpr (N0 > 0)
    tc_store<N0>(dqp, st.dq.s, q0 + rl, 0, m.sq, tg, acc0);
  if constexpr (N1 > 0)
    tc_store<N1>(dqp, st.dq.s, q0 + rl, P::N0, m.sq, tg, acc1);
}

// ----------------------------------------------------- TMA maps (host)

// cuTensorMapEncodeTiled from the driver through the runtime, so nothing
// links libcuda
typedef CUresult (*TcEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TcEncode tc_encoder() {
  static TcEncode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TcEncode>(p);
  }
  return fn;
}

// the maps of one [b, heads, rows, hd] bf16 tensor (element strides st)
template <int HD>
int tc_map(TcMap& out, const void* ptr, Strides st, int b, int heads,
           int rows) {
  TcEncode enc = tc_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)b};
  // bytes; a dimension of one index takes any stride (it is never stepped)
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                           (cuuint64_t)st.b * 2};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = 16;
  const cuuint32_t es[4] = {1, 1, 1, 1};
  for (int part = 0; part < 2; ++part) {
    const int w = part == 0 ? 64 : Tc<HD>::TW;
    if (w == 0 || (part == 0 && Tc<HD>::NA == 0)) continue;
    const cuuint32_t box[4] = {(cuuint32_t)w, (cuuint32_t)TC_T, 1, 1};
    const CUtensorMapSwizzle swz = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
    if (enc(&out.m[part], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
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
  using P = Tc<HD>;
  TcMaps maps;
  memset(&maps, 0, sizeof(maps));
  int err = tc_map<HD>(maps.q, a.q, a.st.q, a.b, a.h, a.mk.sq);
  if (err == 0) err = tc_map<HD>(maps.o, a.dout, a.st.dout, a.b, a.h, a.mk.sq);
  if (err == 0) err = tc_map<HD>(maps.k, a.k, a.st.k, a.b, a.kh, a.mk.sk);
  if (err == 0) err = tc_map<HD>(maps.v, a.v, a.st.v, a.b, a.kh, a.mk.sk);
  if (err != 0) return err;
  if (dkdv) {
    cudaError_t e = att_smem_attr(tc_dkdv_kernel<HD>, P::DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.b * a.kh, (a.mk.sk + P::CN - 1) / P::CN);
    tc_dkdv_kernel<HD><<<grid, TC_THREADS, P::DKV_SMEM, a.stream>>>(
        maps, a.lse, a.delta, (bf16*)a.dk, (bf16*)a.dv, a.st, a.h, a.kh,
        a.mk);
  } else {
    cudaError_t e = att_smem_attr(tc_dq_kernel<HD>, P::DQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.b * a.h, (a.mk.sq + P::CN - 1) / P::CN);
    tc_dq_kernel<HD><<<grid, TC_THREADS, P::DQ_SMEM, a.stream>>>(
        maps, a.lse, a.delta, (bf16*)a.dq, a.st, a.h, a.kh, a.mk);
  }
  return (int)cudaGetLastError();
}

// keys (dK/dV) or query rows (dQ) of a tc CTA at head dim hd; 0 where the
// head dim takes the SIMT kernels
int tc_cn(int hd) {
  switch (hd) {
    case 32: return Tc<32>::CN;
    case 64: return Tc<64>::CN;
    case 80: return Tc<80>::CN;
    case 128: return Tc<128>::CN;
    case 256: return Tc<256>::CN;
    default: return 0;
  }
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

// The tile steps the bf16 tensor-core kernels walk for a shape, a CTA
// column at a time: kind 0 the dK/dV launch (the 64-row query tiles that
// each CTA of keys walks for one query head of its GQA group), kind 1 the
// dQ launch (the 64-key tiles that each CTA of query rows walks). Writes
// column i's count to steps[i] (steps may be null) and returns the
// columns, or -1 where the head dim takes the SIMT kernels.
// kernels/flash_attention.py bwd_tile_walk mirrors it.
REPRO_EXPORT long long flash_attention_bwd_steps(int kind, int sq, int sk,
                                                 int hd, int causal,
                                                 int window, int q_offset,
                                                 long long* steps) {
  const int cn = tc_cn(hd);
  if (cn == 0 || sq <= 0 || sk <= 0) return -1;
  const BwMask m = {1.f, 0.f, 1.f / (float)sk, sq, sk, causal, window,
                    q_offset};
  int n = 0, lo, hi;
  for (int c0 = 0; c0 < (kind == 0 ? sk : sq); c0 += cn, ++n) {
    if (kind == 0)
      tc_dkdv_rows(m, c0, cn, lo, hi);
    else
      tc_dq_keys(m, c0, cn, lo, hi);
    if (steps) steps[n] = tc_tiles(lo, hi);
  }
  return n;
}
