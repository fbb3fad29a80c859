// Backward of the chunked Mamba2 SSD scan (csrc/mamba_scan.cu), for
// training the Mamba2 layers (kernels/mamba_scan.py: Mamba2Scan).
//
// Replaces no Pallas kernel: the reference trains its Mamba2 layers by
// jax.grad of its jnp SSD (src/repro/models/layers/ssm.py:266 chunk_step),
// and its Pallas scan (src/repro/kernels/mamba_scan.py:23) has no backward.
// Contract (the plain version is kernels/mamba_scan.py:
// mamba2_scan_bwd_ref): the forward's inputs x [b, s, nh, dh] (fp32 or
// bf16), dt, dA [b, s, nh], B, C [b, s, st], h0 [b, nh, dh, st] or null,
// and the gradients dy (x's dtype, x's shape) and dh_last (fp32 or null
// = zeros); out dx (x's dtype), ddt, ddA, dB, dC, dh0, fp32. Within a
// chunk (cum the inclusive cumsum of dA, T its total, H the state
// entering, G the gradient of the state leaving, dec_tu = exp(cum_t -
// cum_u) for u <= t):
//   dx_u  = dt_u Z_u, Z_u = sum_t (C_t.B_u) dec_tu dy_t + exp(T - cum_u) G B_u
//   ddt_u = x_u . Z_u;   Q_tu = dec_tu dt_u (dy_t . x_u)
//   dC_t  = sum_u Q_tu B_u + exp(cum_t) dy_t^T H      (summed over heads)
//   dB_u  = sum_t Q_tu C_t + exp(T - cum_u) dt_u x_u^T G
//   dcum_t = rows - columns of Q (C.B) + exp(cum_t) C_t.(dy_t^T H)
//            - exp(T - cum_u) dt_u B_u.(x_u^T G), plus on the last step
//            dT = exp(T) <G, H> + sum_u of that last term; ddA = the
//            reverse cumsum of dcum over the chunk
//   G_prev = exp(T) G + sum_t exp(cum_t) dy_t C_t^T   (after chunk 0: dh0)
//
// What bounds it on an H100 at zamba2's training shape (b 1, s 8,192, nh
// 80, dh 64, st 64, fp32): x, dy and dx are 168 MB each, the rest ~20 MB:
// ~0.52 GB, 0.16 ms at 3.35 TB/s. The work the gradient needs is ~38
// GFLOP: over each chunk's causal pairs C B^T, dy x^T, P^T dy, Q B and
// Q^T C, and per step and head five [dh, st] products (the states walked
// forward again, the gradients walked back, B G^T, dy H, x G): 0.56 ms at
// the fp32 SIMT rate, 0.23 ms at a third of the TF32 peak (3xTF32, the
// products' rate here). Operations bound it. (This count, the wrapper's
// scan_bwd_cost, takes Q B and Q^T C a head; the kernel runs them once a
// head group, below it.)
//
// Design (no atomics: repeats are bit-equal). The state walks are taken
// off the serial chain in the chunk-state / state-passing form, cut into
// segments of `seg` chunks (a walk of all of a head's chunks in a row is a
// chain of nch dependent steps: 128 at the training shape, ~6 us each on
// an H100):
//   1. msb_walk_kernel, grid (nseg, 2 nh, b): each (segment, head) walks
//      its own chunks (ms_walk over [c_lo, c_hi)): the states forward from
//      zeros (from h0 in the first segment), the gradients back from zeros
//      (from dh_last in the last), each chunk's product the 3xTF32
//      [64 x 64] x [64 x st] of the walk, the next chunk's tiles in flight.
//      It writes every chunk's local state and gradient, each chunk's
//      decay since its segment's edge (DH, DG), each segment's decay (ES)
//      and each chunk's cumsum of dA and dt (one record a (chunk, head),
//      which the chunk launch copies instead of redoing the fp64 scan). st <= 64 keeps the state in 16 registers a thread and
//      two CTAs an SM. 2 nh nseg CTAs (1,280 at the training shape) fill
//      the card where the old walk ran 2 nh chains of nch steps.
//   2. msb_pass_kernel (more than one segment): an elementwise recurrence
//      over the b nh 64 st lanes (327,680 at the training shape) that
//      makes each segment's boundary state whole, in order: H_start(k) =
//      H_loc + E(k - 1) H_start(k - 1), E a segment's decay, and the same
//      backwards for G and dh0; its loads run 8 boundaries ahead.
//   3. msb_chunk_kernel, grid (groups, nch, b): one chunk and a group of
//      heads a CTA, the heads in turn; the next head's x, dy, H, G and
//      statistics arrive (cp.async, two sets) while this head's products
//      run. A state inside a segment is its local one plus its decay times
//      the segment's start (loaded into registers a head early, added on
//      arrival). C B^T is computed once a CTA; the products skip the
//      causal zeros (the two warps whose score tile is all zero take B G^T
//      then); the score sums go to per-warp slots summed once, so a head
//      costs three barriers. B and C are every head's, so the score terms
//      of dC and dB, sum_h Q_h B and sum_h Q_h^T C, are two products of
//      the group's summed Q after its heads (five products a head, not
//      seven). For st <= 64, dB and dC are summed over the group's heads
//      in order in registers and written once: one partial a group
//      instead of one a head (st > 64: in the CTA's own partial).
//   4. msb_sum_kernel (more than one group): dB, dC = the groups'
//      partials summed in order.
// The groups are chosen for the fewest waves of 132 CTAs times heads a CTA
// (mb_groups): zamba2's training shape is one group of 80 heads, 128 CTAs
// (no partials, no launch 4); its 300-token prefill 20 groups of 4.
// A ragged last chunk is masked by its length; dt and dA are read with
// stride nh. Scratch (the wrapper's, mamba2_scan_bwd_scratch floats): the
// local states and gradients [b][nch - 1][nh][64][st] each, the records
// [b][nch][nh][MS_REC] (cum, dt), the groups' partials [b][groups][s][st] twice
// (more than one group), DH, DG, ES [b][nch][nh] each (more than one
// chunk): 341 MB at the training shape (a scratch of per-head partials
// would add 335 MB).
#include "mamba_scan.cuh"

namespace {

constexpr int MB_SMS = 132;   // an H100's SMs: a wave of chunk CTAs
constexpr int MB_WALK_CTAS = 1280;  // walk CTAs the default segments aim for
constexpr int MB_SEG_MIN = 8;       // chunks a segment at least (or all of them)
constexpr int MB_SET = MS_REC + 3 * MS_CHUNK;  // a set's record, exp(cum), sw, sdec
constexpr int MB_SMALL = 2 * MB_SET + 13 * MS_CHUNK;  // floats before the tiles
constexpr int MB_TILE = MS_CHUNK * MS_LD;

// Groups of heads of the chunk launch: balanced groups, the fewest waves
// times (heads a CTA + one for a CTA's own start: its C B^T, its first
// loads), then the fewest groups.
int mb_groups(int b, int s, int nh) {
  const long long nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  long long best = -1;
  int out = 1;
  for (int g = 1; g <= nh; ++g) {
    const int gh = (nh + g - 1) / g;
    if ((nh + gh - 1) / gh != g) continue;
    const long long cost = (nch * b * g + MB_SMS - 1) / MB_SMS * (gh + 1);
    if (best < 0 || cost < best) {
      best = cost;
      out = g;
    }
  }
  return out;
}

// Chunks a segment of the walk: about MB_WALK_CTAS walk CTAs, but at
// least MB_SEG_MIN chunks a segment (a short walk costs less than the
// boundary pass's launch)
int mb_seg(int b, int s, int nh) {
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const long long per = 2LL * nh * b;
  long long nseg = (MB_WALK_CTAS + per - 1) / per;
  if (nseg > nch) nseg = nch;
  const int seg = (int)((nch + nseg - 1) / nseg);
  return seg > MB_SEG_MIN ? seg : (nch < MB_SEG_MIN ? nch : MB_SEG_MIN);
}

size_t mb_chunk_smem(bool two_sets) {
  return sizeof(float) * (MB_SMALL + (two_sets ? 12 : 8) * MB_TILE);
}

// Row sums of a warp's 16 x 32 part of a tile, from each thread's sums of
// its rows g and g + 8 (fixed order): part[(warp / 4) * 64 + row]
__device__ __forceinline__ void mb_row_put(float s0, float s1, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s0 += __shfl_xor_sync(ATT_FULL, s0, 1);
  s0 += __shfl_xor_sync(ATT_FULL, s0, 2);
  s1 += __shfl_xor_sync(ATT_FULL, s1, 1);
  s1 += __shfl_xor_sync(ATT_FULL, s1, 2);
  if ((lane & 3) == 0) {
    part[(warp >> 2) * 64 + ms_row(0)] = s0;
    part[(warp >> 2) * 64 + ms_row(2)] = s1;
  }
}

__device__ __forceinline__ void mb_row_part(const float (&a)[4][4], float* part) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    s0 += a[nt][0] + a[nt][1];
    s1 += a[nt][2] + a[nt][3];
  }
  mb_row_put(s0, s1, part);
}

// Column sums of a warp's 16 x 32 part: part[(warp % 4) * 64 + column]
__device__ __forceinline__ void mb_col_part(const float (&a)[4][4], float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = a[nt][j] + a[nt][j + 2];
      v += __shfl_xor_sync(ATT_FULL, v, 4);
      v += __shfl_xor_sync(ATT_FULL, v, 8);
      v += __shfl_xor_sync(ATT_FULL, v, 16);
      if ((lane >> 2) == 0) part[(warp & 3) * 64 + ms_col(nt, j)] = v;
    }
}

// 64 rows of a state block (columns nb .. nb + w of rows of st floats)
// into a tile of rows of MS_LD; rows past `rows` and columns past w zero,
// a null src all zero (`any`: a valid address for the zero fills). Thread
// t copies rows t / 16 + 16 k, columns 4 (t % 16) .. + 3: the elements
// mb_fix_state adds to once its own copies have landed.
__device__ __forceinline__ void mb_cp_state(float* dst, const float* src, int rows,
                                            int st, int nb, int w, const float* any) {
  const int r0 = threadIdx.x >> 4, cq = (threadIdx.x & 15) * 4;
  const bool vec = src != nullptr && (st & 3) == 0 && ((uintptr_t)src & 15) == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + 16 * k;
    float* d = dst + r * MS_LD + cq;
    if (vec) {
      const bool ok = r < rows && cq < w;
      ms_cp16(d, ok ? src + (size_t)r * st + nb + cq : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = src != nullptr && r < rows && cq + e < w;
        ms_cp4(d + e, ok ? src + (size_t)r * st + nb + cq + e : any, ok);
      }
    }
  }
}

// The elements of a 64-row state block (all st <= 64 columns) that this
// thread copies (mb_cp_state), into registers
__device__ __forceinline__ void mb_fix_load(const float* __restrict__ src, int st,
                                            float4 (&v)[4]) {
  const int r0 = threadIdx.x >> 4, cq = (threadIdx.x & 15) * 4;
  const bool vec = (st & 3) == 0 && ((uintptr_t)src & 15) == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* p = src + (size_t)(r0 + 16 * k) * st + cq;
    if (vec) {
      v[k] = cq < st ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[k].x = cq < st ? p[0] : 0.f;
      v[k].y = cq + 1 < st ? p[1] : 0.f;
      v[k].z = cq + 2 < st ? p[2] : 0.f;
      v[k].w = cq + 3 < st ? p[3] : 0.f;
    }
  }
}

// dst += D v over the elements this thread copied (v from mb_fix_load)
__device__ __forceinline__ void mb_fix_apply(float* dst, const float4 (&v)[4], float D) {
  const int r0 = threadIdx.x >> 4, cq = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float4* d = reinterpret_cast<float4*>(dst + (r0 + 16 * k) * MS_LD + cq);
    float4 a = *d;
    a.x = fmaf(D, v[k].x, a.x);
    a.y = fmaf(D, v[k].y, a.y);
    a.z = fmaf(D, v[k].z, a.z);
    a.w = fmaf(D, v[k].w, a.w);
    *d = a;
  }
}

// dst += D src over the elements this thread copied (mb_cp_state); src a
// 64-row state block
__device__ __forceinline__ void mb_fix_state(float* dst, const float* __restrict__ src,
                                             int st, int nb, int w, float D) {
  const int r0 = threadIdx.x >> 4, cq = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + 16 * k;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (cq + e < w) {
        float* d = dst + r * MS_LD + cq + e;
        *d = fmaf(D, src[(size_t)r * st + nb + cq + e], *d);
      }
  }
}

// Two neighbouring elements added to a partial this thread wrote for the
// group's earlier heads (first: written)
__device__ __forceinline__ void mb_acc2(float* p, float a, float b, int left, bool first) {
  if (left <= 0) return;
  if (!first) {
    if (left >= 2 && ((uintptr_t)p & 7) == 0) {
      const float2 o = *reinterpret_cast<const float2*>(p);
      a += o.x;
      b += o.y;
    } else {
      a += p[0];
      if (left >= 2) b += p[1];
    }
  }
  ms_store2(p, a, b, left);
}

// Launch 1. Grid (nseg, 2 nh, b): y < nh the reverse walk of head y over
// segment x, else the forward walk of head y - nh. Each writes its chunks'
// decays since the segment's edge (DG, DH; null for one chunk); the
// forward one the segment's whole decay (ES) and each chunk's statistics
// (Sm) for the chunk launch. NQ 1 (st <= 64) holds the state in 16
// registers a thread, so two CTAs share an SM.
template <typename T, int NQ>
__global__ void __launch_bounds__(MS_THREADS, NQ == 1 ? 2 : 1)
msb_walk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ dt, const float* __restrict__ dA,
                const float* __restrict__ B, const float* __restrict__ C,
                const float* __restrict__ h0, const float* __restrict__ dh_last,
                float* __restrict__ Hm, float* __restrict__ Gm,
                float* __restrict__ DH, float* __restrict__ DG,
                float* __restrict__ ES, float* __restrict__ Sm,
                float* __restrict__ dh0, int s, int nh, int dh, int st, int seg) {
  extern __shared__ double smem[];
  const int y = blockIdx.y, bb = blockIdx.z;
  const int c_lo = blockIdx.x * seg, c_hi = c_lo + seg;
  if (y < nh)
    ms_walk<T, true, NQ>(dy, dt, dA, C, dh_last, Gm, dh0, s, nh, dh, st, y, bb, 0,
                         smem, c_lo, c_hi, DG);
  else
    ms_walk<T, false, NQ>(x, dt, dA, B, h0, Hm, nullptr, s, nh, dh, st, y - nh, bb,
                          0, smem, c_lo, c_hi, DH, ES, Sm);
}

// Launch 2 (nseg > 1). Grid (lanes / 256, 2): y 0 the states, 1 the
// gradients and dh0; a thread a lane (batch row, head, row d < 64, column
// n). The first segment's states and the last's gradients are whole
// already; each later boundary takes the one before it, in order.
__global__ void __launch_bounds__(256)
msb_pass_kernel(float* __restrict__ Hm, float* __restrict__ Gm,
                const float* __restrict__ ES, float* __restrict__ dh0, int b,
                int s, int nh, int dh, int st, int seg) {
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int nseg = (nch + seg - 1) / seg;
  const size_t lanes = (size_t)b * nh * MS_DB * st;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const int n = (int)(i % st);
  const size_t r = i / st;
  const int d = (int)(r % MS_DB);
  const size_t bh = r / MS_DB;
  const int head = (int)(bh % nh), bb = (int)(bh / nh);
  const size_t tile = (size_t)MS_DB * st, off = (size_t)d * st + n;
  const float* E = ES + (size_t)bb * nch * nh + head;  // E[k nh]: segment k
  auto at = [&](float* M, int c) {  // slot c of this lane
    return M + (((size_t)bb * (nch - 1) + c) * nh + head) * tile + off;
  };
  // the boundaries in runs of 8: their loads do not wait on the chain
  constexpr int RUN = 8;
  if (blockIdx.y == 0) {  // H_start(k) = H_loc + E(k - 1) H_start(k - 1)
    float h = *at(Hm, seg - 1);
    for (int k0 = 2; k0 < nseg; k0 += RUN) {
      float v[RUN], e[RUN];
#pragma unroll
      for (int r = 0; r < RUN; ++r)
        if (k0 + r < nseg) {
          v[r] = *at(Hm, (k0 + r) * seg - 1);
          e[r] = E[(size_t)(k0 + r - 1) * nh];
        }
#pragma unroll
      for (int r = 0; r < RUN; ++r)
        if (k0 + r < nseg) {
          h = fmaf(e[r], h, v[r]);
          *at(Hm, (k0 + r) * seg - 1) = h;
        }
    }
  } else {  // G_end(k) = G_loc + E(k + 1) G_end(k + 1); dh0 = its + E(0) G
    float g = *at(Gm, (nseg - 1) * seg - 1);
    for (int k0 = nseg - 3; k0 >= 0; k0 -= RUN) {
      float v[RUN], e[RUN];
#pragma unroll
      for (int r = 0; r < RUN; ++r)
        if (k0 - r >= 0) {
          v[r] = *at(Gm, (k0 - r + 1) * seg - 1);
          e[r] = E[(size_t)(k0 - r + 1) * nh];
        }
#pragma unroll
      for (int r = 0; r < RUN; ++r)
        if (k0 - r >= 0) {
          g = fmaf(e[r], g, v[r]);
          *at(Gm, (k0 - r + 1) * seg - 1) = g;
        }
    }
    if (d < dh) {
      float* p = dh0 + (((size_t)bb * nh + head) * dh + d) * st + n;
      *p = fmaf(E[0], g, *p);
    }
  }
}

// Launch 3. Grid (groups, nch, b): chunk c of batch row bb for the heads
// grp * gh .. + gh, in turn. Shared memory (floats): the two sets'
// statistics (the forward walk's record, cum and dt, then exp(cum), sw
// and sdec computed here), the per-warp sums (score rows [2][64], score columns
// [4][64], C.(dy H) [2][64], B.(x G) [2][64], ddt [2][64]), the warps'
// <G, H> [64]; then the tiles B, C, P, Q and one set (two for more than
// one head) of x, dy, H, G: [64][MS_LD] each.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS, 1)
msb_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ B, const float* __restrict__ C,
                 const float* __restrict__ h0, const float* __restrict__ dh_last,
                 const float* __restrict__ Hm, const float* __restrict__ Gm,
                 const float* __restrict__ DHm, const float* __restrict__ DGm,
                 const float* __restrict__ Sm, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ ddA,
                 float* __restrict__ dBp, float* __restrict__ dCp, int s,
                 int nh, int dh, int st, int gh, int seg) {
  extern __shared__ double smem[];
  float* f = reinterpret_cast<float*>(smem);
  float* recs = f;  // [2][MB_SET]
  float* srp = f + 2 * MB_SET;
  float *scp = srp + 128, *chp = srp + 384, *bgp = srp + 512, *dtp = srp + 640;
  float* red = srp + 768;
  float* Bt = f + MB_SMALL;
  float* Ct = Bt + MB_TILE;
  float* Ps = Ct + MB_TILE;
  float* Qs = Ps + MB_TILE;
  float* sets = Qs + MB_TILE;  // set k: x, dy, H, G at sets + 4 k MB_TILE

  const int grp = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int ng = (nh + gh - 1) / gh;
  const int c0 = c * MS_CHUNK, L = min(MS_CHUNK, s - c0);
  const size_t row0 = (size_t)bb * s + c0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = (warp & 3) * 16, cc0 = (warp >> 2) * 32;
  const int dh8 = ms_st8(dh), L8 = ms_st8(L);
  const int hd0 = grp * gh, nhg = min(gh, nh - hd0);
  const int nst = (st + 63) / 64;
  constexpr int LD = MS_LD;
  const float* any = B;

  // the segment of this chunk: is its state (gradient) a local one?
  const int nseg = (nch + seg - 1) / seg, kseg = c / seg;
  const int c_first = kseg * seg, c_hi = min(c_first + seg, nch) - 1;
  const bool hfix = c > 0 && kseg > 0 && c != c_first;
  const bool gfix = c < nch - 1 && kseg < nseg - 1 && c != c_hi;
  const size_t slot = (size_t)MS_DB * st;
  auto hm = [&](int cs, int hd) {  // the state entering chunk cs + 1
    return Hm + (((size_t)bb * (nch - 1) + cs) * nh + hd) * slot;
  };
  auto gm = [&](int cs, int hd) {  // the gradient leaving chunk cs
    return Gm + (((size_t)bb * (nch - 1) + cs) * nh + hd) * slot;
  };
  auto hsrc = [&](int hd) -> const float* {
    if (c > 0) return hm(c - 1, hd);
    return h0 != nullptr ? h0 + ((size_t)bb * nh + hd) * dh * st : nullptr;
  };
  auto gsrc = [&](int hd) -> const float* {
    if (c < nch - 1) return gm(c, hd);
    return dh_last != nullptr ? dh_last + ((size_t)bb * nh + hd) * dh * st : nullptr;
  };
  const int hrows = c > 0 ? MS_DB : dh, grows = c < nch - 1 ? MS_DB : dh;
  // the decays since the segment's start (H) and to its end (G)
  auto dhead = [&](int hd, float& DH, float& DG) {
    const size_t i = ((size_t)bb * nch + c) * nh + hd;
    DH = hfix ? DHm[i] : 0.f;
    DG = gfix ? DGm[i] : 0.f;
  };

  // head j of the group into set j % 2 (for one st block: its H and G too)
  auto issue = [&](int j) {
    const int hd = hd0 + j;
    float* xs = sets + (j & 1) * 4 * MB_TILE;
    ms_cp_x(xs, x, row0, L, nh, hd, dh, 0);
    ms_cp_x(xs + MB_TILE, dy, row0, L, nh, hd, dh, 0);
    if (nst == 1) {
      mb_cp_state(xs + 2 * MB_TILE, hsrc(hd), hrows, st, 0, st, any);
      mb_cp_state(xs + 3 * MB_TILE, gsrc(hd), grows, st, 0, st, any);
    }
    if (tid < 32) {  // the statistics record: MS_REC / 4 copies of 16 bytes
      const float* src = Sm + (((size_t)bb * nch + c) * nh + hd) * MS_REC;
      float* dst = recs + (j & 1) * MB_SET;
      for (int i = tid; i < MS_REC / 4; i += 32) ms_cp16(dst + 4 * i, src + 4 * i, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // one st block: the next head's corrections, loaded a head early
  float4 fh[4], fg[4];
  auto fix_load = [&](int hd) {
    if (hfix) mb_fix_load(hm(c_first - 1, hd), st, fh);
    if (gfix) mb_fix_load(gm(c_hi, hd), st, fg);
  };
  issue(0);
  if (nst == 1) fix_load(hd0);

  // C B^T of the chunk over all of st (the B and C tiles end on block 0)
  float cb[4][4];
  ms_zero(cb);
  for (int q = nst - 1; q >= 0; --q) {
    const int nb = q * 64, w = min(64, st - nb);
    if (q != nst - 1) __syncthreads();
    ms_cp_tile(Bt, LD, B + row0 * st + nb, st, L, w, 64);
    ms_cp_tile(Ct, LD, C + row0 * st + nb, st, L, w, 64);
    ms_cp_wait();
    __syncthreads();
    ms_mma_tile(cb, Ct, LD, 1, Bt, LD, 1, ms_st8(w), t0, cc0);
  }

  // one st block: dB and dC summed over the group's heads here, in order;
  // Q summed over them (B and C are the heads' own: sum_h Q_h B = (sum_h
  // Q_h) B, so its two products run once a group, after the heads)
  float accB[4][4], accC[4][4], qsum[4][4];
  ms_zero(accB);
  ms_zero(accC);
  ms_zero(qsum);
  float DH, DG;  // this head's decays (the next head's loaded a head early)
  dhead(hd0, DH, DG);
  for (int j = 0; j < nhg; ++j) {
    const int hd = hd0 + j;
    float* xs = sets + (j & 1) * 4 * MB_TILE;
    float* dys = xs + MB_TILE;
    float* Ht = dys + MB_TILE;
    float* Gt = Ht + MB_TILE;
    float* rec = recs + (j & 1) * MB_SET;
    const double* cum = reinterpret_cast<const double*>(rec);
    const float* dts = rec + 2 * MS_CHUNK;
    float *ec = rec + 3 * MS_CHUNK, *sw = rec + 4 * MS_CHUNK, *sdec = rec + 5 * MS_CHUNK;
    float nDH = 0.f, nDG = 0.f;
    if (j + 1 < nhg) {
      issue(j + 1);  // into the set head j - 1 left (barrier 3 of j - 1)
      dhead(hd + 1, nDH, nDG);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      ms_cp_wait();
    }
    if (nst == 1) {
      if (hfix) mb_fix_apply(Ht, fh, DH);
      if (gfix) mb_fix_apply(Gt, fg, DG);
      if (j + 1 < nhg) fix_load(hd + 1);
    }
    __syncthreads();  // (1) this head's tiles and statistics
    const float T_ = (float)cum[MS_CHUNK - 1];
    if (tid < MS_CHUNK) {  // read from the block loop on (after barrier 2)
      const float e = expf((float)(cum[MS_CHUNK - 1] - cum[tid]));
      ec[tid] = expf((float)cum[tid]);
      sw[tid] = e * dts[tid];
      sdec[tid] = e;
    }

    // the scores: DX = dy x^T, then P = C B^T dec, Q = dec dt_u DX, S = Q
    // C B^T (a warp's tile above the diagonal is zero; for one st block
    // that warp takes its Z2 = B G^T here instead of in the block loop)
    float acc[4][4], z2[4][4];
    ms_zero(acc);
    ms_zero(z2);
    const bool z2_early = nst == 1 && cc0 >= t0 + 16;
    if (cc0 < t0 + 16) ms_mma_tile(acc, dys, LD, 1, xs, LD, 1, dh8, t0, cc0);
    else if (z2_early) ms_mma_tile(z2, Bt, LD, 1, Gt, LD, 1, ms_st8(st), t0, cc0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ms_row(i), u = ms_col(nt, i);
        const bool ok = u <= t && t < L;
        const float dec = ok ? expf((float)(cum[t] - cum[u])) : 0.f;
        const float q = dec * dts[u] * acc[nt][i];
        Ps[t * LD + u] = cb[nt][i] * dec;
        qsum[nt][i] += q;
        acc[nt][i] = q * cb[nt][i];
      }
    mb_row_part(acc, srp);
    mb_col_part(acc, scp);
    __syncthreads();  // (2) P, exp(cum), sw, sdec

    // Z1 = P^T dy (rows u: steps t >= u)
    float z1[4][4];
    ms_zero(z1);
    if (t0 < L8) ms_mma_tile(z1, Ps, 1, LD, dys, 1, LD, L8, t0, cc0, nullptr, t0);

    float ch0 = 0.f, ch1 = 0.f, bg0 = 0.f, bg1 = 0.f, gh_ = 0.f;
    for (int q = 0; q < nst; ++q) {
      const int nb = q * 64, w = min(64, st - nb), w8 = ms_st8(w);
      if (nst > 1) {  // B, C, H and G of this block
        if (q > 0) __syncthreads();
        ms_cp_tile(Bt, LD, B + row0 * st + nb, st, L, w, 64);
        ms_cp_tile(Ct, LD, C + row0 * st + nb, st, L, w, 64);
        mb_cp_state(Ht, hsrc(hd), hrows, st, nb, w, any);
        mb_cp_state(Gt, gsrc(hd), grows, st, nb, w, any);
        ms_cp_wait();
        if (hfix) mb_fix_state(Ht, hm(c_first - 1, hd), st, nb, w, DH);
        if (gfix) mb_fix_state(Gt, gm(c_hi, hd), st, nb, w, DG);
        __syncthreads();
      }

      // Z2 += B G^T (the state term of dx, before exp(T - cum_u))
      if (!z2_early) ms_mma_tile(z2, Bt, LD, 1, Gt, LD, 1, w8, t0, cc0);

      // dC's state term exp(cum_t) dy H; C.(dy H)
      float a2[4][4];
      ms_zero(a2);
      ms_mma_tile(a2, dys, LD, 1, Ht, 1, LD, dh8, t0, cc0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int t = ms_row(i), n = ms_col(nt, i);
          const float va = ec[t] * a2[nt][i], vb = ec[t] * a2[nt][i + 1];
          if (nst == 1) {
            accC[nt][i] += va;
            accC[nt][i + 1] += vb;
          } else if (t < L && n < w) {
            mb_acc2(dCp + (((size_t)bb * ng + grp) * s + c0 + t) * st + nb + n, va, vb,
                    w - n, j == 0);
          }
          const float v = a2[nt][i] * Ct[t * LD + n] + a2[nt][i + 1] * Ct[t * LD + n + 1];
          if (i == 0) ch0 += v; else ch1 += v;
        }

      // dB's state term sw x G; B.(x G)
      ms_zero(a2);
      ms_mma_tile(a2, xs, LD, 1, Gt, 1, LD, dh8, t0, cc0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int u = ms_row(i), n = ms_col(nt, i);
          const float va = sw[u] * a2[nt][i], vb = sw[u] * a2[nt][i + 1];
          if (nst == 1) {
            accB[nt][i] += va;
            accB[nt][i + 1] += vb;
          } else if (u < L && n < w) {
            mb_acc2(dBp + (((size_t)bb * ng + grp) * s + c0 + u) * st + nb + n, va, vb,
                    w - n, j == 0);
          }
          const float v = a2[nt][i] * Bt[u * LD + n] + a2[nt][i + 1] * Bt[u * LD + n + 1];
          if (i == 0) bg0 += v; else bg1 += v;
        }

      for (int i = tid; i < MS_CHUNK * 64; i += MS_THREADS)
        gh_ = fmaf(Gt[(i >> 6) * LD + (i & 63)], Ht[(i >> 6) * LD + (i & 63)], gh_);
    }

    // dx = dt_u (Z1 + exp(T - cum_u) Z2), ddt_u = x_u . (Z1 + ...)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int u = ms_row(i), d = ms_col(nt, i);
        const float za = fmaf(sdec[u], z2[nt][i], z1[nt][i]);
        const float zb = fmaf(sdec[u], z2[nt][i + 1], z1[nt][i + 1]);
        if (u < L && d < dh)
          ms_store2(dx + ((row0 + u) * nh + hd) * dh + d, dts[u] * za, dts[u] * zb, dh - d);
        acc[nt][i] = xs[u * LD + d] * za;
        acc[nt][i + 1] = xs[u * LD + d + 1] * zb;
      }
    mb_row_part(acc, dtp);
    mb_row_put(ch0, ch1, chp);
    mb_row_put(bg0, bg1, bgp);
    gh_ += __shfl_xor_sync(ATT_FULL, gh_, 16);
    gh_ += __shfl_xor_sync(ATT_FULL, gh_, 8);
    gh_ += __shfl_xor_sync(ATT_FULL, gh_, 4);
    gh_ += __shfl_xor_sync(ATT_FULL, gh_, 2);
    gh_ += __shfl_xor_sync(ATT_FULL, gh_, 1);
    if (lane == 0) red[warp] = gh_;
    __syncthreads();  // (3) the sums; this head's set is spent

    // warp 0: dcum, dT on the last step, ddA its reverse cumsum, ddt
    if (warp == 0) {
      float m[2], dv[2], v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * lane + e;
        const float srow = srp[r] + srp[64 + r];
        const float scol = ((scp[r] + scp[64 + r]) + scp[128 + r]) + scp[192 + r];
        const float chv = chp[r] + chp[64 + r], bgv = bgp[r] + bgp[64 + r];
        dv[e] = dtp[r] + dtp[64 + r];
        m[e] = r < L ? srow - scol + ec[r] * chv - sw[r] * bgv : 0.f;
        v[e] = r < L ? sw[r] * bgv : 0.f;
      }
      float dT = v[0] + v[1];
      dT += __shfl_xor_sync(ATT_FULL, dT, 16);
      dT += __shfl_xor_sync(ATT_FULL, dT, 8);
      dT += __shfl_xor_sync(ATT_FULL, dT, 4);
      dT += __shfl_xor_sync(ATT_FULL, dT, 2);
      dT += __shfl_xor_sync(ATT_FULL, dT, 1);
      float g = 0.f;
      for (int k = 0; k < MS_THREADS / 32; ++k) g += red[k];
      const float extra = fmaf(expf(T_), g, dT);
      if (2 * lane == L - 1) m[0] += extra;
      if (2 * lane + 1 == L - 1) m[1] += extra;
      float suf = m[0] + m[1];  // the pairs' sum over lanes >= this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(ATT_FULL, suf, o);
        if (lane + o < 32) suf += u;
      }
      float after = __shfl_down_sync(ATT_FULL, suf, 1);
      if (lane == 31) after = 0.f;
      const float a1 = m[1] + after, a0 = m[0] + a1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * lane + e;
        if (r < L) {
          const size_t gi = (row0 + r) * nh + hd;
          ddA[gi] = e ? a1 : a0;
          ddt[gi] = dv[e];
        }
      }
    }
    DH = nDH;
    DG = nDG;
  }

  // the score terms of the whole group: dC += Q B (rows t: steps u <= t),
  // dB += Q^T C (rows u: steps t >= u), with Q summed over the heads
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      *reinterpret_cast<float2*>(Qs + ms_row(i) * LD + ms_col(nt, i)) =
          make_float2(qsum[nt][i], qsum[nt][i + 1]);
  for (int q = 0; q < nst; ++q) {
    const int nb = q * 64, w = min(64, st - nb);
    if (nst > 1) {
      __syncthreads();  // Q written; the previous block's tiles spent
      ms_cp_tile(Bt, LD, B + row0 * st + nb, st, L, w, 64);
      ms_cp_tile(Ct, LD, C + row0 * st + nb, st, L, w, 64);
      ms_cp_wait();
    }
    __syncthreads();
    float a1[4][4], a3[4][4];
    ms_zero(a1);
    ms_zero(a3);
    ms_mma_tile(a1, Qs, LD, 1, Bt, 1, LD, min(L8, t0 + 16), t0, cc0);
    if (t0 < L8) ms_mma_tile(a3, Qs, 1, LD, Ct, 1, LD, L8, t0, cc0, nullptr, t0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int t = ms_row(i), n = ms_col(nt, i);
        if (nst == 1) {
          accC[nt][i] += a1[nt][i];
          accC[nt][i + 1] += a1[nt][i + 1];
          accB[nt][i] += a3[nt][i];
          accB[nt][i + 1] += a3[nt][i + 1];
        } else if (t < L && n < w) {
          const size_t o = (((size_t)bb * ng + grp) * s + c0 + t) * st + nb + n;
          mb_acc2(dCp + o, a1[nt][i], a1[nt][i + 1], w - n, false);
          mb_acc2(dBp + o, a3[nt][i], a3[nt][i + 1], w - n, false);
        }
      }
  }
  if (nst == 1) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int t = ms_row(i), n = ms_col(nt, i);
        if (t < L && n < st) {
          const size_t o = (((size_t)bb * ng + grp) * s + c0 + t) * st + n;
          ms_store2(dCp + o, accC[nt][i], accC[nt][i + 1], st - n);
          ms_store2(dBp + o, accB[nt][i], accB[nt][i + 1], st - n);
        }
      }
  }
}

// Launch 4 (more than one group): dB and dC = the groups' partials summed
// in order. One thread an element of [2][b][s][st].
__global__ void __launch_bounds__(256)
msb_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
               float* __restrict__ dB, float* __restrict__ dC, int b, int s,
               int ng, int st) {
  const size_t per = (size_t)s * st, n = (size_t)b * per;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool is_c = i >= n;
    const size_t j = is_c ? i - n : i;
    const size_t bb = j / per, r = j % per;
    const float* p = (is_c ? dCp : dBp) + bb * ng * per + r;
    float a = 0.f;
    for (int g = 0; g < ng; ++g) a += p[(size_t)g * per];
    (is_c ? dC : dB)[j] = a;
  }
}

// Floats of each part of the scratch: the local states (and as many
// gradients), the chunks' statistics records, the groups' partials (of dB
// and of dC), the decays (DH, DG, ES: [b][nch][nh] each)
struct MbSizes {
  long long states, recs, parts, decays;
  MbSizes(int b, int s, int nh, int st, int ng) {
    const long long nch = (s + MS_CHUNK - 1) / MS_CHUNK;
    states = (long long)b * (nch - 1) * nh * MS_DB * st;
    recs = (long long)b * nch * nh * MS_REC;
    parts = ng > 1 ? (long long)b * ng * s * st : 0;
    decays = nch > 1 ? (long long)b * nch * nh : 0;
  }
  long long floats() const { return 2 * states + recs + 2 * parts + 3 * decays; }
};

template <typename T>
int launch(const void* x, const void* dt, const void* dA, const void* B,
           const void* C, const void* h0, const void* dy, const void* dh_last,
           void* dx, void* ddt, void* ddA, void* dB, void* dC, void* dh0,
           void* scratch, int b, int s, int nh, int dh, int st, int seg,
           int ng, cudaStream_t stream) {
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int nseg = (nch + seg - 1) / seg;
  const int gh = (nh + ng - 1) / ng;
  const MbSizes z(b, s, nh, st, ng);
  float* Hm = (float*)scratch;
  float* Gm = Hm + z.states;
  float* Sm = Gm + z.states;
  float* dBp = ng > 1 ? Sm + z.recs : (float*)dB;
  float* dCp = ng > 1 ? dBp + z.parts : (float*)dC;
  float* DH = nch > 1 ? Sm + z.recs + 2 * z.parts : nullptr;
  float* DG = nch > 1 ? DH + z.decays : nullptr;
  float* ES = nch > 1 ? DG + z.decays : nullptr;
  cudaError_t err;
  const size_t walk = ms_state_smem(st);
  auto wk = st <= 64 ? msb_walk_kernel<T, 1> : msb_walk_kernel<T, 4>;
  if ((err = att_smem_attr(wk, walk)) != cudaSuccess) return (int)err;
  wk<<<dim3(nseg, 2 * nh, b), MS_THREADS, walk, stream>>>(
      (const T*)x, (const T*)dy, (const float*)dt, (const float*)dA, (const float*)B,
      (const float*)C, (const float*)h0, (const float*)dh_last, Hm, Gm, DH, DG, ES, Sm,
      (float*)dh0, s, nh, dh, st, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nseg > 1) {
    const long long lanes = (long long)b * nh * MS_DB * st;
    msb_pass_kernel<<<dim3((unsigned)((lanes + 255) / 256), 2), 256, 0, stream>>>(
        Hm, Gm, ES, (float*)dh0, b, s, nh, dh, st, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t chunk = mb_chunk_smem(gh > 1);
  if ((err = att_smem_attr(msb_chunk_kernel<T>, chunk)) != cudaSuccess) return (int)err;
  msb_chunk_kernel<T><<<dim3(ng, nch, b), MS_THREADS, chunk, stream>>>(
      (const T*)x, (const T*)dy, (const float*)B,
      (const float*)C, (const float*)h0, (const float*)dh_last, Hm, Gm, DH, DG, Sm, (T*)dx,
      (float*)ddt, (float*)ddA, dBp, dCp, s, nh, dh, st, gh, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (ng > 1) {
    const long long n = 2LL * b * s * st;
    const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
    msb_sum_kernel<<<blocks, 256, 0, stream>>>(dBp, dCp, (float*)dB, (float*)dC, b, s,
                                               ng, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call needs (16-byte aligned).
REPRO_EXPORT long long mamba2_scan_bwd_scratch(int b, int s, int nh, int dh, int st) {
  (void)dh;
  return MbSizes(b, s, nh, st, mb_groups(b, s, nh)).floats();
}

// x, dy [b, s, nh, dh] (dtype 0 = fp32, 1 = bf16), dt, dA [b, s, nh], B, C
// [b, s, st], h0 and dh_last [b, nh, dh, st] or null; dx in x's dtype,
// ddt, ddA [b, s, nh], dB, dC [b, s, st], dh0 [b, nh, dh, st] fp32; all
// contiguous; s >= 1, 1 <= dh <= 64, 1 <= st <= 256.
REPRO_EXPORT int mamba2_scan_bwd(const void* x, const void* dt, const void* dA,
                                 const void* B, const void* C, const void* h0,
                                 const void* dy, const void* dh_last, void* dx,
                                 void* ddt, void* ddA, void* dB, void* dC,
                                 void* dh0, void* scratch, int b, int s, int nh,
                                 int dh, int st, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || dh <= 0 || dh > MS_DB || st <= 0 || st > 256 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int ng = mb_groups(b, s, nh), seg = mb_seg(b, s, nh);
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return launch<float>(x, dt, dA, B, C, h0, dy, dh_last, dx, ddt, ddA, dB, dC, dh0,
                         scratch, b, s, nh, dh, st, seg, ng, cs);
  if (dtype == ATT_BF16)
    return launch<__nv_bfloat16>(x, dt, dA, B, C, h0, dy, dh_last, dx, ddt, ddA, dB,
                                 dC, dh0, scratch, b, s, nh, dh, st, seg, ng, cs);
  return (int)cudaErrorInvalidValue;
}
