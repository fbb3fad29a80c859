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
// products' rate here). Operations bound it; the kernel runs whole 64 x 64
// tiles (~48 GFLOP) and, at this shape, its two walks are serial chains of
// 128 chunk steps.
//
// Design (three launches a call, no atomics: repeats are bit-equal):
//   1. msb_walk_kernel, grid (1, 2 nh + nch, b): the reverse walk of each
//      (head, batch) over the chunks (ms_walk<REV>: G of every chunk but
//      the last, and dh0), the forward walk again (the state entering
//      every chunk), and C B^T of every chunk. The entering states are
//      recomputed, not kept from the forward: keeping them costs the
//      forward's 168 MB scratch per layer at the training shape for as
//      long as autograd holds the layer, and the walk runs beside the
//      reverse walk in the same launch (both are 80 CTAs of serial chunk
//      steps, far from filling the card).
//   2. msb_chunk_kernel, grid (nh, nch, b): every (chunk, head) at once,
//      all of dh in one CTA (dh <= 64): dx, ddt and ddA, and this head's
//      partials of dB and dC; the products are the forward's 3xTF32
//      mma.sync tiles, the row and column sums of the scores fixed-order
//      shuffles and shared-memory sums. st is walked in 64-column blocks.
//   3. msb_sum_kernel: dB, dC = the partials summed over the heads in
//      order.
// A ragged last chunk is masked by its length; dt and dA are read with
// stride nh. Scratch (the wrapper's, mamba2_scan_bwd_scratch floats): C
// B^T [b][nch][64][64], the entering states and the leaving gradients
// [b][nch - 1][nh][64][st] each, the partials [b][nh][s][st] twice.
#include "mamba_scan.cuh"

namespace {

constexpr int MB_SMALL = 15 * MS_CHUNK;  // floats before the tiles (msb_chunk_kernel)

size_t mb_chunk_smem() {
  return sizeof(double) * MS_CHUNK + sizeof(float) * (MB_SMALL + 8 * MS_CHUNK * MS_LD);
}

// out[row] += sum over the 64 columns of a 64 x 64 tile held as the warps'
// mma fragments (fixed order; buf: 2 x 64 floats of shared memory)
__device__ __forceinline__ void mb_row_sums(const float (&a)[4][4], float* buf, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    s0 += a[nt][0] + a[nt][1];
    s1 += a[nt][2] + a[nt][3];
  }
  s0 += __shfl_xor_sync(ATT_FULL, s0, 1);
  s0 += __shfl_xor_sync(ATT_FULL, s0, 2);
  s1 += __shfl_xor_sync(ATT_FULL, s1, 1);
  s1 += __shfl_xor_sync(ATT_FULL, s1, 2);
  if ((lane & 3) == 0) {
    buf[(warp >> 2) * 64 + ms_row(0)] = s0;
    buf[(warp >> 2) * 64 + ms_row(2)] = s1;
  }
  __syncthreads();
  if (threadIdx.x < 64) out[threadIdx.x] += buf[threadIdx.x] + buf[64 + threadIdx.x];
  __syncthreads();
}

// out[column] += sum over the 64 rows (fixed order; buf: 4 x 64 floats)
__device__ __forceinline__ void mb_col_sums(const float (&a)[4][4], float* buf, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = a[nt][j] + a[nt][j + 2];
      v += __shfl_xor_sync(ATT_FULL, v, 4);
      v += __shfl_xor_sync(ATT_FULL, v, 8);
      v += __shfl_xor_sync(ATT_FULL, v, 16);
      if ((lane >> 2) == 0) buf[(warp & 3) * 64 + ms_col(nt, j)] = v;
    }
  __syncthreads();
  if (threadIdx.x < 64) {
    const int c = threadIdx.x;
    out[c] += ((buf[c] + buf[64 + c]) + buf[128 + c]) + buf[192 + c];
  }
  __syncthreads();
}

// Launch 1. Grid (1, 2 nh + nch, b) for s > 64, (1, nh + 1, b) for one
// chunk: y < nh the reverse walk of head y; y < 2 nh (s > 64) the forward
// walk of head y - nh; then C B^T of chunk y - nh - nfw.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
msb_walk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ dt, const float* __restrict__ dA,
                const float* __restrict__ B, const float* __restrict__ C,
                const float* __restrict__ h0, const float* __restrict__ dh_last,
                float* __restrict__ cbg, float* __restrict__ Hm,
                float* __restrict__ Gm, float* __restrict__ dh0, int s, int nh,
                int dh, int st) {
  extern __shared__ double smem[];
  const int y = blockIdx.y, bb = blockIdx.z;
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int nfw = nch > 1 ? nh : 0;
  if (y < nh)
    ms_walk<T, true>(dy, dt, dA, C, dh_last, Gm, dh0, s, nh, dh, st, y, bb, 0, smem);
  else if (y < nh + nfw)
    ms_walk<T, false>(x, dt, dA, B, h0, Hm, nullptr, s, nh, dh, st, y - nh, bb, 0, smem);
  else
    ms_cb_tile(B, C, cbg, s, st, y - nh - nfw, bb, reinterpret_cast<float*>(smem + MS_CHUNK));
}

// Launch 2. Grid (nh, nch, b): one (head, chunk, batch row) a CTA.
// Shared memory: the fp64 cumsum [64], then floats: ec, dt, sw, T (the
// forward's statistics), sdec = exp(T - cum), and the sums over 64 steps
// (score rows, score columns, C.(dy H), B.(x G), ddt), a 4 x 64 reduction
// buffer, 64 scratch floats; then eight [64][MS_LD] tiles: x, dy, P, Q,
// and the 64-column blocks of B, C, H (the entering state) and G.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
msb_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ dA,
                 const float* __restrict__ B, const float* __restrict__ C,
                 const float* __restrict__ h0, const float* __restrict__ dh_last,
                 const float* __restrict__ cbg, const float* __restrict__ Hm,
                 const float* __restrict__ Gm, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ ddA,
                 float* __restrict__ dBp, float* __restrict__ dCp, int s,
                 int nh, int dh, int st) {
  extern __shared__ double smem[];
  double* cum = smem;
  float* f = reinterpret_cast<float*>(smem + MS_CHUNK);
  float *ec = f, *dts = f + MS_CHUNK, *sw = f + 2 * MS_CHUNK, *Ts = f + 3 * MS_CHUNK;
  float* sdec = f + 4 * MS_CHUNK;
  float* srow = f + 5 * MS_CHUNK;  // sum_u S_tu
  float* scol = f + 6 * MS_CHUNK;  // sum_t S_tu
  float* ch = f + 7 * MS_CHUNK;    // C_t . (dy_t^T H)
  float* bg = f + 8 * MS_CHUNK;    // B_u . (x_u^T G)
  float* dtv = f + 9 * MS_CHUNK;   // x_u . Z_u
  float* red = f + 10 * MS_CHUNK;  // [4][64]
  float* misc = f + 14 * MS_CHUNK; // [64]: dcum, then the warps' <G, H>
  float* xs = f + MB_SMALL;
  float* dys = xs + MS_CHUNK * MS_LD;
  float* Ps = dys + MS_CHUNK * MS_LD;
  float* Qs = Ps + MS_CHUNK * MS_LD;
  float* Bt = Qs + MS_CHUNK * MS_LD;
  float* Ct = Bt + MS_CHUNK * MS_LD;
  float* Ht = Ct + MS_CHUNK * MS_LD;
  float* Gt = Ht + MS_CHUNK * MS_LD;

  const int head = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int c0 = c * MS_CHUNK, L = min(MS_CHUNK, s - c0);
  const size_t row0 = (size_t)bb * s + c0;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int t0 = (warp & 3) * 16, cc0 = (warp >> 2) * 32;
  const int dh8 = ms_st8(dh), L8 = ms_st8(L);
  constexpr int LD = MS_LD;

  float cb[4][4];  // this warp's part of C B^T (the walk launch's)
  {
    const float* tile = cbg + ((size_t)bb * nch + c) * MS_CB;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(
            tile + ms_row(i) * MS_CHUNK + ms_col(nt, i));
        cb[nt][i] = v.x;
        cb[nt][i + 1] = v.y;
      }
  }
  ms_cp_x(xs, x, row0, L, nh, head, dh, 0);
  ms_cp_x(dys, dy, row0, L, nh, head, dh, 0);
  if (tid < 32)
    ms_stats(ms_stats_load(dt, dA, row0 * nh + head, nh, L), cum, ec, dts, sw, Ts);
  for (int i = tid; i < 5 * MS_CHUNK; i += MS_THREADS) srow[i] = 0.f;  // srow .. dtv
  ms_cp_wait();
  __syncthreads();
  if (tid < MS_CHUNK) sdec[tid] = expf((float)(cum[MS_CHUNK - 1] - cum[tid]));

  // the scores: DX = dy x^T, then P = C B^T dec, Q = dec dt_u DX, S = Q C B^T
  float acc[4][4];
  ms_zero(acc);
  ms_mma_tile(acc, dys, LD, 1, xs, LD, 1, dh8, t0, cc0);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ms_row(i), u = ms_col(nt, i);
      const bool ok = u <= t && t < L;
      const float dec = ok ? expf((float)(cum[t] - cum[u])) : 0.f;
      const float q = dec * dts[u] * acc[nt][i];
      Ps[t * LD + u] = cb[nt][i] * dec;
      Qs[t * LD + u] = q;
      acc[nt][i] = q * cb[nt][i];
    }
  mb_row_sums(acc, red, srow);  // (its barriers also publish P and Q)
  mb_col_sums(acc, red, scol);

  // Z1 = P^T dy
  float z1[4][4], z2[4][4];
  ms_zero(z1);
  ms_zero(z2);
  ms_mma_tile(z1, Ps, 1, LD, dys, 1, LD, L8, t0, cc0);

  const float* hsrc = c == 0 ? (h0 != nullptr ? h0 + ((size_t)bb * nh + head) * dh * st : nullptr)
                             : Hm + (((size_t)bb * (nch - 1) + c - 1) * nh + head) * (size_t)MS_DB * st;
  const float* gsrc = c == nch - 1
      ? (dh_last != nullptr ? dh_last + ((size_t)bb * nh + head) * dh * st : nullptr)
      : Gm + (((size_t)bb * (nch - 1) + c) * nh + head) * (size_t)MS_DB * st;
  float gh = 0.f;  // this thread's part of <G, H>
  for (int nb = 0; nb < st; nb += 64) {
    const int w = min(64, st - nb), w8 = ms_st8(w);
    __syncthreads();  // the previous block's tiles are spent
    ms_cp_tile(Bt, LD, B + row0 * st + nb, st, L, w, 64);
    ms_cp_tile(Ct, LD, C + row0 * st + nb, st, L, w, 64);
    ms_cp_tile(Ht, LD, hsrc != nullptr ? hsrc + nb : B, st, hsrc != nullptr ? dh : 0, w, 64);
    ms_cp_tile(Gt, LD, gsrc != nullptr ? gsrc + nb : B, st, gsrc != nullptr ? dh : 0, w, 64);
    ms_cp_wait();
    __syncthreads();

    // Z2 += B G^T (the state term of dx, before exp(T - cum_u))
    ms_mma_tile(z2, Bt, LD, 1, Gt, LD, 1, w8, t0, cc0);

    // dC = Q B + exp(cum_t) dy H; C.(dy H) for dcum
    float a1[4][4], a2[4][4];
    ms_zero(a1);
    ms_zero(a2);
    ms_mma_tile(a1, Qs, LD, 1, Bt, 1, LD, L8, t0, cc0);
    ms_mma_tile(a2, dys, LD, 1, Ht, 1, LD, dh8, t0, cc0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int t = ms_row(i), n = ms_col(nt, i);
        if (t < L && n < w)
          ms_store2(dCp + (((size_t)bb * nh + head) * s + c0 + t) * st + nb + n,
                    a1[nt][i] + ec[t] * a2[nt][i], a1[nt][i + 1] + ec[t] * a2[nt][i + 1],
                    w - n);
        a2[nt][i] *= Ct[t * LD + n];
        a2[nt][i + 1] *= Ct[t * LD + n + 1];
      }
    mb_row_sums(a2, red, ch);

    // dB = Q^T C + sw x G; B.(x G) for dcum
    ms_zero(a1);
    ms_zero(a2);
    ms_mma_tile(a1, Qs, 1, LD, Ct, 1, LD, L8, t0, cc0);
    ms_mma_tile(a2, xs, LD, 1, Gt, 1, LD, dh8, t0, cc0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int u = ms_row(i), n = ms_col(nt, i);
        if (u < L && n < w)
          ms_store2(dBp + (((size_t)bb * nh + head) * s + c0 + u) * st + nb + n,
                    a1[nt][i] + sw[u] * a2[nt][i], a1[nt][i + 1] + sw[u] * a2[nt][i + 1],
                    w - n);
        a2[nt][i] *= Bt[u * LD + n];
        a2[nt][i + 1] *= Bt[u * LD + n + 1];
      }
    mb_row_sums(a2, red, bg);

    for (int i = tid; i < MS_CHUNK * 64; i += MS_THREADS)
      gh = fmaf(Gt[(i >> 6) * LD + (i & 63)], Ht[(i >> 6) * LD + (i & 63)], gh);
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
        ms_store2(dx + ((row0 + u) * nh + head) * dh + d, dts[u] * za, dts[u] * zb, dh - d);
      acc[nt][i] = xs[u * LD + d] * za;
      acc[nt][i + 1] = xs[u * LD + d + 1] * zb;
    }
  mb_row_sums(acc, red, dtv);

  // <G, H>: the warps' sums, then in order
  gh += __shfl_xor_sync(ATT_FULL, gh, 16);
  gh += __shfl_xor_sync(ATT_FULL, gh, 8);
  gh += __shfl_xor_sync(ATT_FULL, gh, 4);
  gh += __shfl_xor_sync(ATT_FULL, gh, 2);
  gh += __shfl_xor_sync(ATT_FULL, gh, 1);
  if ((tid & 31) == 0) red[warp] = gh;
  if (tid < MS_CHUNK)
    misc[tid] = srow[tid] - scol[tid] + ec[tid] * ch[tid] - sw[tid] * bg[tid];
  __syncthreads();
  if (tid == 0) {
    float dT = 0.f;
    for (int u = 0; u < L; ++u) dT += sw[u] * bg[u];
    float g = 0.f;
    for (int k = 0; k < MS_THREADS / 32; ++k) g += red[k];
    misc[L - 1] += fmaf(expf(*Ts), g, dT);
  }
  __syncthreads();
  if (tid < L) {
    float a = 0.f;  // ddA_t = sum_{k >= t} dcum_k
    for (int k = L - 1; k >= tid; --k) a += misc[k];
    const size_t gi = (row0 + tid) * nh + head;
    ddA[gi] = a;
    ddt[gi] = dtv[tid];
  }
}

// Launch 3: dB and dC = their per-head partials summed over the heads in
// order. One thread an element of [2][b][s][st].
__global__ void __launch_bounds__(256)
msb_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
               float* __restrict__ dB, float* __restrict__ dC, int b, int s,
               int nh, int st) {
  const size_t per = (size_t)s * st, n = (size_t)b * per;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool is_c = i >= n;
    const size_t j = is_c ? i - n : i;
    const size_t bb = j / per, r = j % per;
    const float* p = (is_c ? dCp : dBp) + bb * nh * per + r;
    float a = 0.f;
    for (int h = 0; h < nh; ++h) a += p[(size_t)h * per];
    (is_c ? dC : dB)[j] = a;
  }
}

// Floats of each part of the scratch: C B^T, the states (and the
// gradients), the partials (of dB and of dC)
struct MbSizes {
  long long cb, states, parts;
  MbSizes(int b, int s, int nh, int st) {
    const long long nch = (s + MS_CHUNK - 1) / MS_CHUNK;
    cb = (long long)b * nch * MS_CB;
    states = (long long)b * (nch - 1) * nh * MS_DB * st;
    parts = (long long)b * nh * s * st;
  }
  long long floats() const { return cb + 2 * states + 2 * parts; }
};

struct MbScratch {
  float *cbg, *Hm, *Gm, *dBp, *dCp;
  MbScratch(float* base, const MbSizes& z) {
    cbg = base;
    Hm = cbg + z.cb;
    Gm = Hm + z.states;
    dBp = Gm + z.states;
    dCp = dBp + z.parts;
  }
};

template <typename T>
int launch(const void* x, const void* dt, const void* dA, const void* B,
           const void* C, const void* h0, const void* dy, const void* dh_last,
           void* dx, void* ddt, void* ddA, void* dB, void* dC, void* dh0,
           void* scratch, int b, int s, int nh, int dh, int st,
           cudaStream_t stream) {
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const MbScratch sc((float*)scratch, MbSizes(b, s, nh, st));
  cudaError_t err;
  const size_t walk = ms_state_smem(st);
  if ((err = att_smem_attr(msb_walk_kernel<T>, walk)) != cudaSuccess) return (int)err;
  msb_walk_kernel<T><<<dim3(1, nh + (nch > 1 ? nh : 0) + nch, b), MS_THREADS, walk, stream>>>(
      (const T*)x, (const T*)dy, (const float*)dt, (const float*)dA, (const float*)B,
      (const float*)C, (const float*)h0, (const float*)dh_last, sc.cbg, sc.Hm, sc.Gm,
      (float*)dh0, s, nh, dh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t chunk = mb_chunk_smem();
  if ((err = att_smem_attr(msb_chunk_kernel<T>, chunk)) != cudaSuccess) return (int)err;
  msb_chunk_kernel<T><<<dim3(nh, nch, b), MS_THREADS, chunk, stream>>>(
      (const T*)x, (const T*)dy, (const float*)dt, (const float*)dA, (const float*)B,
      (const float*)C, (const float*)h0, (const float*)dh_last, sc.cbg, sc.Hm, sc.Gm,
      (T*)dx, (float*)ddt, (float*)ddA, sc.dBp, sc.dCp, s, nh, dh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = 2LL * b * s * st;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  msb_sum_kernel<<<blocks, 256, 0, stream>>>(sc.dBp, sc.dCp, (float*)dB, (float*)dC, b,
                                             s, nh, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call needs (16-byte aligned).
REPRO_EXPORT long long mamba2_scan_bwd_scratch(int b, int s, int nh, int dh, int st) {
  (void)dh;
  return MbSizes(b, s, nh, st).floats();
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
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return launch<float>(x, dt, dA, B, C, h0, dy, dh_last, dx, ddt, ddA, dB, dC, dh0,
                         scratch, b, s, nh, dh, st, cs);
  if (dtype == ATT_BF16)
    return launch<__nv_bfloat16>(x, dt, dA, B, C, h0, dy, dh_last, dx, ddt, ddA, dB,
                                 dC, dh0, scratch, b, s, nh, dh, st, cs);
  return (int)cudaErrorInvalidValue;
}
