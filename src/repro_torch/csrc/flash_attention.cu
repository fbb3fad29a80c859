// Prefill attention with an online softmax, for the port's prefill path
// (models/layers/attention.py: attention_prefill).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention  <- _kernel (flash_attention.py:28, launched at :115)
// Same contract: q [b, h, sq, hd], k/v [b, kh, sk, hd] (fp32 or bf16),
// out [b, h, sq, hd] in the input dtype; fp32 scores, softmax statistics
// and accumulator; causal mask with q_offset, sliding window, logit
// softcap, GQA through kv head = h / (h / kh). Every tensor is read (and
// the output written) through its batch, head and sequence strides, with
// the head dim contiguous, so the prefill's [b, s, h, hd] projections pass
// as transposed views without a copy.
//
// What bounds it on an H100: at the serve paths' prompts (s 8-24, h 32,
// hd 128 or 80) it moves ~0.1-0.4 MB and does ~2-20 MFLOP, far below a
// microsecond at the card's rates: latency bound (load Q and one K/V step,
// a few products, store). At zamba2's 300-token prompt (hd 80) it moves
// 6.1 MB (1.8 us) and does 1.2 GFLOP (1.2 us at 989 TFLOP/s): bytes and
// operations are level, and the kernel's time is the latency chain of the
// rows that see all 300 keys. From ~1,000 tokens on it is bound by
// operations (4 * pairs * hd FLOP, pairs = visible (q, k) pairs).
//
// bf16: flash_kernel_tc, FA2's design on mma.sync, with the keys of a CTA
// split between two warp groups.
//   * A CTA owns 64 query rows of one head: 4 row groups of 16 (the M of
//     mma.m16n8k16) times 2 key groups, 8 warps. Each step brings 128 keys
//     (64 at hd 256) into shared memory through a two-stage cp.async ring
//     of 16-byte copies (the next step is in flight while this one is
//     multiplied; rows past sq / sk are zero-filled by the copy itself);
//     key group kg takes the step's keys [64 kg, 64 kg + 64) (32 at
//     hd 256) with its own softmax state, and the groups' (m, l, O) are
//     merged through shared memory at the end. Splitting the keys halves
//     the serial chain of the rows that see the most keys: a warp alone on
//     its SM sub-partition is bound by latency, not by the tensor cores,
//     and that chain sets the time at zamba2's 300 tokens.
//   * The query tiles that see the most keys are scheduled first (the
//     grid's slowest axis, reversed), and a CTA asks for at least 120 KB
//     of shared memory, so one CTA runs per SM: at zamba2's 160 CTAs the
//     light ones then wait for a free SM instead of sharing one with a
//     heavy one (longer prompts lose a little by it).
//   * S = Q·Kᵀ on tensor cores from ldmatrix fragments, fp32 accumulators
//     in registers. The scale multiplies the fp32 scores after the product
//     (Q is not pre-scaled in bf16, which would round q * scale where the
//     plain version keeps q.float() * scale), folded with log2(e) into the
//     factor applied to s - max before each ex2; a softcap goes through
//     tanh first. Masking
//     keeps the reference's -1e30 arithmetic and runs only on tiles that a
//     row of the warp cannot see whole.
//   * Online softmax per row: tree max over the lane's keys, then over the
//     4 lanes that share a row (__shfl_xor_sync 1, 2). P is rounded to bf16
//     in registers, packed in pairs, and is the A operand of P·V as it
//     stands (the S accumulator's layout is the A fragment's); V is the B
//     operand through ldmatrix.trans; O stays fp32 in registers until the
//     epilogue divides by the row sum and rounds once to bf16.
//   * Rounding P to bf16 is the one rounding the plain version does not
//     make. The row sum l adds the same rounded values, so the output is
//     still a convex combination of V rows, each weight within 2^-8
//     relative of the fp32 one: the output moves by at most 2^-8 times
//     the spread of the V rows it mixes (far less where many keys share
//     the weight, and nothing for a key of weight 1, which bf16 holds
//     exactly), inside the 2e-2 bf16 tolerance beside the output's own
//     rounding. ex2.approx (2 ulp) is far below that rounding.
//   * Shared-memory rows are padded to hd + 8 elements: a row of hd 80 is
//     160 bytes, ten 16-byte chunks, so no power-of-two XOR swizzle fits;
//     with the pad, the 8 rows an ldmatrix reads start in 8 distinct
//     16-byte bank groups at every compiled head dim (row pitches 48, 80,
//     144, 176, 272 and 528 bytes). hd 8 zero-pads Q's and K's depth to 16
//     in shared memory (the pad columns are written once and never copied
//     over).
//   * Steps wholly above the diagonal or outside the window are never
//     loaded (the CTA's loop bounds), and a warp skips the products of a
//     tile that no row of its own can see.
//   * At hd 256 the O fragment is 128 registers a lane, so key tiles are
//     32 keys there; Q fragments are reloaded from shared memory at every
//     step rather than held in registers.
// The row log-sum-exp (training): with a non-null lse pointer ([b, h, sq]
// fp32, contiguous) each kernel also stores lse = m + log(l) of every row
// in natural-log units, from the softmax state it keeps anyway (the tc
// kernel's m is in its log2-scaled score units and is converted); the
// backward kernels (flash_attention_bwd.cu) recompute P = exp(s - lse)
// from it. The tc kernel's l sums the bf16-rounded P, so the recomputed
// fp32 P of a row sums to 1 within 2^-8. Null stores nothing: the serve
// paths pass null and their launches do not change.
//
// What is left for a later step: wgmma with TMA loads and warp
// specialisation (a producer warp, consumer warpgroups on 64-row tiles),
// which pays once a prompt long enough to be bound by operations is on a
// main path (PERF.md has its time at 2,048 tokens); and packing the q
// heads of one kv head into a CTA (GQA), not measured yet.
//
// fp32: flash_kernel, the SIMT kernel (tensor cores would take fp32 as
// TF32, outside the 1e-5 fp32 tolerance). One CTA per 16 query rows; 4
// warps of 4 rows; K/V tiles of 32 keys staged in shared memory as fp32
// (K rows padded by one float); each lane scores one key, warp shuffles
// give the row max and sum, and acc is split over the lanes by head dim.
//
// Both take any sq and sk (the TPU wrapper asserts sq % block_q == 0): the
// ragged tails of the last Q and K/V tiles are masked in the kernel, rows
// past sq are neither read nor written. Head dims 8, 16, 32, 64, 80, 128
// and 256 are compiled for each. A row that sees no key (a window ending
// before the first key: q_offset + row >= sk + window - 1) gets what the
// plain version's softmax over sk masked scores gives, the mean of V: a
// tile (and a warp) holding such a row walks every key instead of its
// window, and positions past sk weigh nothing. Which tiles do is known
// from q_offset, window and sk before any load; the prefill (q_offset 0,
// sq = sk) has none.
#include "attention_common.cuh"
#include "mma_bf16.cuh"

namespace {

// element strides of one [b, heads, s, hd] tensor (hd contiguous)
struct Strides { long long b, h, s; };
struct FaStrides { Strides q, k, v, o; };

// ------------------------------------------------------------- fp32 SIMT

constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 4;                    // query rows a warp owns
constexpr int FA_BQ = FA_WARPS * FA_ROWS;     // query rows a CTA owns
constexpr int FA_BK = 32;                     // keys a tile: one per lane

template <int HD>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (FA_BQ * HD + FA_BK * (HD + 1) + FA_BK * HD);
}

template <int HD>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, FaStrides st,
             int h, int kh, int sq, int sk, float scale, int causal,
             int window, float softcap, int q_offset) {
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

  const float* qp = q + bb * st.q.b + head * st.q.h;
  const float* kp = k + bb * st.k.b + kvh * st.k.h;
  const float* vp = v + bb * st.v.b + kvh * st.v.h;
  float* op = o + bb * st.o.b + head * st.o.h;

  for (int i = tid; i < FA_BQ * HD; i += FA_WARPS * 32) {
    const int r = q0 + i / HD;
    qs[i] = r < sq ? qp[r * st.q.s + i % HD] * scale : 0.f;
  }

  // keys any row of this tile can see: causal upper bound, window lower
  // bound (rounded down to a tile start). A tile with a blind row (one
  // the window leaves no key: q_pos >= sk + window - 1) walks every key
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + FA_BQ, sq) - 1;
  const bool blind = window > 0 && q_last >= sk + window - 1;
  const int kv_hi = causal ? min(sk, q_last + 1) : sk;
  int kv_lo = window > 0 && !blind ? max(0, q_first - window + 1) : 0;
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
        kx = kp[kr * st.k.s + d];
        vx = vp[kr * st.v.s + d];
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
      if (blind && kpos >= sk) s = ATT_NONE;
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
        op[r * st.o.s + lane + 32 * t] = acc[rr][t] * inv;
    if (lse != nullptr && lane == 0)
      lse[((long long)bb * h + head) * sq + r] = m[rr] + logf(l[rr]);
  }
}

// ----------------------------------------------------- bf16 tensor cores

using bf16 = __nv_bfloat16;

constexpr int TC_RG = 4;                // row groups of 16 query rows
constexpr int TC_KG = 2;                // key groups: warps split a step
constexpr int TC_BQ = 16 * TC_RG;       // query rows a CTA
// dynamic shared memory asked for at least: more than half an SM's, so one
// CTA runs per SM (see the note at the head of the file)
constexpr size_t TC_SMEM_MIN = 120 * 1024;
constexpr float TC_LOG2E = 1.4426950408889634f;
constexpr float TC_LN2 = 0.6931471805599453f;

template <int HD>
struct Tc {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // depth of Q·Kᵀ (k of mma)
  static constexpr int LDS = HDP + 8;            // shared row pitch
  static constexpr int BK = HD >= 256 ? 32 : 64;  // keys a warp a step
  static constexpr int WARPS = TC_RG * TC_KG;
  static constexpr int STEP = TC_KG * BK;        // keys a CTA a step
  static constexpr int CH = HD / 8;              // 16-byte chunks a row
  static constexpr size_t smem = sizeof(bf16) * LDS * (TC_BQ + 4 * STEP);
};

// 2^x in one MUFU instruction (the scores are kept in log2 units)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + STEP) of one K or V head into a shared stage; rows past
// sk are zero-filled
template <int HD>
__device__ __forceinline__ void tc_load_step(bf16* dst, const bf16* src,
                                             long long row_stride, int r0,
                                             int sk, int tid) {
  using S = Tc<HD>;
  for (int c = tid; c < S::STEP * S::CH; c += S::WARPS * 32) {
    const int r = c / S::CH, ch = c % S::CH;
    const bool ok = r0 + r < sk;
    cp_async16(smem_u32(dst + r * S::LDS + ch * 8),
               src + (ok ? (r0 + r) * row_stride : 0) + ch * 8, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(Tc<HD>::WARPS * 32)
flash_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, FaStrides st, int h, int kh, int sq, int sk, float scale,
                int causal, int window, float softcap, int q_offset) {
  using S = Tc<HD>;
  constexpr int HDP = S::HDP, LDS = S::LDS, BK = S::BK, CH = S::CH;
  constexpr int STEP = S::STEP, THREADS = S::WARPS * 32;
  constexpr int NT = BK / 8;  // key n-tiles of S
  constexpr int OT = HD / 8;  // head-dim n-tiles of O
  extern __shared__ __align__(16) unsigned char fa_tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_tc_smem);  // [TC_BQ][LDS]
  bf16* ks = qs + TC_BQ * LDS;                      // [2][STEP][LDS]
  bf16* vs = ks + 2 * STEP * LDS;                   // [2][STEP][LDS]

  // the heaviest query tiles first: the last tile of every head sees the
  // most keys, so it is scheduled before the lighter ones
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;
  const int head = blockIdx.x;
  const int bb = blockIdx.y;
  const int kvh = head / (h / kh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % TC_RG;  // rows [16 rg, 16 rg + 16) of the CTA's
  const int kg = warp / TC_RG;  // keys [kg BK, kg BK + BK) of every step

  const bf16* qp = q + bb * st.q.b + head * st.q.h;
  const bf16* kp = k + bb * st.k.b + kvh * st.k.h;
  const bf16* vp = v + bb * st.v.b + kvh * st.v.h;
  bf16* op = o + bb * st.o.b + head * st.o.h;

  // exponents in log2 units: a score x enters the softmax as x * c2 with
  // c2 = scale * log2(e), or, with a softcap, as tanh(x * scale / cap) *
  // cap * log2(e) with c2 = 1 (the max is taken before the factor: c2 > 0)
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * TC_LOG2E;
  const float c2 = softcap > 0.f ? 1.f : scale * TC_LOG2E;

  if constexpr (HDP != HD) {  // hd 8: zero Q's and K's depth padding once
    for (int r = tid; r < TC_BQ + 2 * STEP; r += THREADS) {
      bf16* row = qs + r * LDS;  // Q rows, then both K stages
#pragma unroll
      for (int d = HD; d < HDP; ++d) row[d] = __float2bfloat16(0.f);
    }
  }

  // keys any row of this CTA can see: causal upper bound, window lower
  // bound (rounded down to a tile start)
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + TC_BQ, sq) - 1;
  const bool blind = window > 0 && q_last >= sk + window - 1;
  const int kv_hi = causal ? min(sk, q_last + 1) : sk;
  int kv_lo = window > 0 && !blind ? max(0, q_first - window + 1) : 0;
  kv_lo = (kv_lo / BK) * BK;
  const int nsteps = kv_hi > kv_lo ? (kv_hi - kv_lo + STEP - 1) / STEP : 0;

  for (int c = tid; c < TC_BQ * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = q0 + r < sq;
    cp_async16(smem_u32(qs + r * LDS + ch * 8),
               qp + (ok ? (q0 + r) * st.q.s : 0) + ch * 8, ok);
  }
  if (nsteps > 0) {
    tc_load_step<HD>(ks, kp, st.k.s, kv_lo, sk, tid);
    tc_load_step<HD>(vs, vp, st.v.s, kv_lo, sk, tid);
  }
  cp_async_commit();

  // this lane holds rows g and g + 8 of its warp's 16, and in each 8-wide
  // n-tile the columns 2 * tg and 2 * tg + 1
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = q0 + rg * 16;
  const bool warp_live = row0 < sq;
  const int wq_first = q_offset + row0;
  const int wq_last = q_offset + min(row0 + 16, sq) - 1;
  const bool warp_blind = window > 0 && wq_last >= sk + window - 1;
  float m[2] = {ATT_NEG_INF, ATT_NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): A from Q, B from K (keys as n), B from V (.trans)
  const uint32_t q_addr =
      smem_u32(qs + (rg * 16 + (lane & 15)) * LDS + (lane >> 4) * 8);
  const int k_off = (kg * BK + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (kg * BK + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    (lane >> 4) * 8;

  for (int t = 0; t < nsteps; ++t) {
    const int k0 = kv_lo + t * STEP + kg * BK;  // this warp's first key
    const int stage = t & 1;
    if (t + 1 < nsteps) {
      const int next = kv_lo + (t + 1) * STEP;
      tc_load_step<HD>(ks + (stage ^ 1) * STEP * LDS, kp, st.k.s, next, sk,
                       tid);
      tc_load_step<HD>(vs + (stage ^ 1) * STEP * LDS, vp, st.v.s, next, sk,
                       tid);
      cp_async_commit();
      cp_async_wait<1>();  // all but the step just issued
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool skip = !warp_live || k0 >= kv_hi ||
                      (causal && k0 > wq_last) ||
                      (window > 0 && !warp_blind &&
                       k0 + BK - 1 <= wq_first - window);
    if (!skip) {
      const uint32_t k_base = smem_u32(ks + stage * STEP * LDS + k_off);
      const uint32_t v_base = smem_u32(vs + stage * STEP * LDS + v_off);

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_addr + kk * 16 * sizeof(bf16));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, k_base + (np * 16 * LDS + kk * 16) * sizeof(bf16));
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }

      // the scale (and softcap) apply after the product, in fp32; the
      // mask only where some key of the tile is hidden from some row of
      // the warp (element e: row g + 8 * (e >> 1), key 2 * tg + (e & 1) of
      // n-tile j)
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] * cap_in) * cap_out;
      }
      const bool whole = k0 + BK <= sk &&
                         (!causal || k0 + BK - 1 <= wq_first) &&
                         (window <= 0 || wq_last - k0 < window);
      if (!whole) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = wq_first + g + (e >> 1) * 8;
            const int kpos = k0 + j * 8 + tg * 2 + (e & 1);
            bool ok = kpos < sk;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos) < window;
            s[j][e] = ok ? s[j][e] : ATT_NEG_INF;
          }
        // past the keys: no weight, even in a row that sees no key (where
        // a row that sees one gets 0 there from its own maximum anyway)
        if (warp_blind && k0 + BK > sk) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + j * 8 + tg * 2 + (e & 1) >= sk) s[j][e] = ATT_NONE;
        }
      }

      // online softmax of rows g (r = 0) and g + 8 (r = 1): tree max over
      // this lane's keys, then over the 4 lanes of the row; P rounded to
      // bf16 once, packed in pairs as the A fragment of P·V, and the row
      // sum adds the same rounded values
      uint32_t pk[NT][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          t[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
        for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
        float mx = t[0];
        mx = fmaxf(mx, __shfl_xor_sync(ATT_FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(ATT_FULL, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float corr = ex2((m[r] - m_new) * c2);
        m[r] = m_new;
        // (s - m) first: exactly 0 for a row that sees no key yet (both
        // -1e30), where a fused s * c2 - m * c2 would leave the rounding
        // of m * c2 (~1e22) and overflow ex2
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          pk[j][r] = pack_bf16(ex2((s[j][2 * r] - m_new) * c2),
                               ex2((s[j][2 * r + 1] - m_new) * c2));
          t[j] = __uint_as_float(pk[j][r] << 16) +
                 __uint_as_float(pk[j][r] & 0xffff0000u);
        }
#pragma unroll
        for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) t[j] += t[j + w];
        float sum = t[0];
        sum += __shfl_xor_sync(ATT_FULL, sum, 1);
        sum += __shfl_xor_sync(ATT_FULL, sum, 2);
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int d = 0; d < OT; ++d) {
          acc[d][2 * r] *= corr;
          acc[d][2 * r + 1] *= corr;
        }
      }

      // O += P·V: the packed P of key n-tiles 2kk, 2kk + 1 is the A
      // fragment of key chunk kk
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                               pk[2 * kk + 1][1]};
        const uint32_t vrow = v_base + kk * 16 * LDS * sizeof(bf16);
#pragma unroll
        for (int dp = 0; dp < OT / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, vrow + dp * 16 * sizeof(bf16));
          mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
        if constexpr (OT % 2 == 1) {  // hd 8: one n-tile left
          uint32_t b[2];
          ldsm_x2_t(b, vrow + (OT / 2) * 16 * sizeof(bf16));
          mma_bf16(acc[OT - 1], a, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // this stage fully read before it is refilled
  }
  cp_async_wait<0>();

  // merge the key groups' (m, l, O) into group 0: the warps of one row
  // group hold the same rows and columns lane by lane; the K/V stages are
  // free now and hold the other groups' states
  constexpr int XS = 4 + 4 * OT;  // floats a lane: m[2], l[2], acc
  float* xs = reinterpret_cast<float*>(ks) + (rg * 32 + lane) * XS;
  __syncthreads();
  if (kg > 0) {
    float* x = xs + (kg - 1) * TC_RG * 32 * XS;
    x[0] = m[0];
    x[1] = m[1];
    x[2] = l[0];
    x[3] = l[1];
#pragma unroll
    for (int d = 0; d < OT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 + 4 * d + e] = acc[d][e];
  }
  __syncthreads();
  if (kg > 0 || !warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m_all = m[r];
#pragma unroll
    for (int i = 1; i < TC_KG; ++i)
      m_all = fmaxf(m_all, xs[(i - 1) * TC_RG * 32 * XS + r]);
    const float a0 = ex2((m[r] - m_all) * c2);
    m[r] = m_all;
    l[r] *= a0;
#pragma unroll
    for (int d = 0; d < OT; ++d) {
      acc[d][2 * r] *= a0;
      acc[d][2 * r + 1] *= a0;
    }
#pragma unroll
    for (int i = 1; i < TC_KG; ++i) {
      const float* x = xs + (i - 1) * TC_RG * 32 * XS;
      const float a = ex2((x[r] - m_all) * c2);
      l[r] += x[2 + r] * a;
#pragma unroll
      for (int d = 0; d < OT; ++d) {
        acc[d][2 * r] += x[4 + 4 * d + 2 * r] * a;
        acc[d][2 * r + 1] += x[4 + 4 * d + 2 * r + 1] * a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    // m in score units: a score x weighs 2^((x - m) c2) = e^((x - m) c2 ln2)
    if (lse != nullptr && tg == 0)
      lse[((long long)bb * h + head) * sq + row] = m[r] * c2 * TC_LN2 + logf(l[r]);
    bf16* orow = op + row * st.o.s + tg * 2;
#pragma unroll
    for (int d = 0; d < OT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  FaStrides st;
  int b, h, kh, sq, sk;
  float scale;
  int causal, window;
  float softcap;
  int q_offset;
  cudaStream_t stream;
};

template <int HD>
int launch_f32(const Args& a) {
  const size_t smem = fa_smem_bytes<HD>();
  cudaError_t err = att_smem_attr(flash_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + FA_BQ - 1) / FA_BQ, a.h, a.b);
  flash_kernel<HD><<<grid, FA_WARPS * 32, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.lse, a.st, a.h, a.kh, a.sq, a.sk, a.scale, a.causal, a.window, a.softcap,
      a.q_offset);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const Args& a) {
  const size_t smem =
      Tc<HD>::smem > TC_SMEM_MIN ? Tc<HD>::smem : TC_SMEM_MIN;
  cudaError_t err = att_smem_attr(flash_kernel_tc<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.h, a.b, (a.sq + TC_BQ - 1) / TC_BQ);
  flash_kernel_tc<HD><<<grid, Tc<HD>::WARPS * 32, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o, a.lse,
      a.st,
      a.h, a.kh, a.sq, a.sk, a.scale, a.causal, a.window, a.softcap,
      a.q_offset);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Args& a, int dtype) {
  if (dtype == ATT_F32) return launch_f32<HD>(a);
  if (dtype == ATT_BF16) return launch_tc<HD>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [b, h, sq, hd], k/v [b, kh, sk, hd], o [b, h, sq, hd], all of one dtype
// (0 = fp32 on the SIMT kernel, 1 = bf16 on the tensor-core kernel), head
// dim contiguous; strides: 12 element strides (batch, head, sequence) of
// q, k, v and o in that order. bf16 needs every row on 16 bytes.
// hd in {8, 16, 32, 64, 80, 128, 256}. lse: null, or [b, h, sq] fp32
// contiguous for the rows' log-sum-exp.
REPRO_EXPORT int flash_attention(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int b, int h, int kh, int sq, int sk,
                                 int hd, int dtype, float scale, int causal,
                                 int window, float softcap, int q_offset,
                                 const long long* strides, void* stream) {
  if (sq <= 0 || kh <= 0 || h % kh != 0) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  Args a = {q, k, v, o, lse,
            {{s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
             {s[9], s[10], s[11]}},
            b, h, kh, sq, sk, scale, causal, window, softcap, q_offset,
            (cudaStream_t)stream};
  switch (hd) {
    case 8: return launch<8>(a, dtype);
    case 16: return launch<16>(a, dtype);
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 80: return launch<80>(a, dtype);
    case 128: return launch<128>(a, dtype);
    case 256: return launch<256>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
