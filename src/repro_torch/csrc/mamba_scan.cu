// Chunked Mamba2 SSD scan, for the port's SSM prefill
// (models/layers/ssm.py: mamba2_forward).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/mamba_scan.py:
//   mamba2_scan  <- _kernel (mamba_scan.py:23, launched at :84)
// Same contract, plus the reference oracle's initial state
// (src/repro/kernels/ref.py:88 mamba2_scan_ref): x [b, s, nh, dh] (fp32 or
// bf16), dt and dA [b, s, nh] fp32, B and C [b, s, st] fp32 (one group,
// shared by every head), h0 [b, nh, dh, st] fp32 or null (= zeros);
// y [b, s, nh, dh] in x's dtype, h_last [b, nh, dh, st] fp32. Within a
// chunk of steps, with cum the inclusive cumsum of dA over the chunk and
// T its total:
//   y_t = sum_{u<=t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//         + exp(cum_t) (C_t . h_prev^T)
//   h  <- exp(T) h_prev + S,  S = sum_u exp(T - cum_u) dt_u x_u B_u^T
// The decay stays in the difference form exp(cum_t - cum_u), which never
// overflows (dA <= 0); cum is summed and differenced in fp64 (in fp32 a
// prefix sum of ~-50 keeps only ~4e-6 of absolute precision, which made
// y's error ~1e-4 relative at the serve shape; in fp64 it is ~1e-5, that
// of the other fp32 sums).
//
// What bounds it on an H100: at the serve path's long prefill (b 1, s 300,
// nh 80, dh 64, st 64, fp32) the inputs and outputs are ~15 MB (4.6 us at
// 3.35 TB/s) and the fp32 work ~0.5 GFLOP (7.3 us at 67 TFLOP/s SIMT).
// The first design (one CTA per 32 rows of dh and head, the chunks a
// serial loop, C B^T recomputed by every CTA, products as shared-memory FMA
// chains) took 223 us, 30x that: bound by its dependency chain. At the
// short prefills (s 8-24, one chunk) the work is ~40x smaller and the
// time is one CTA's chain of loads, products and barriers.
//
// Design (the SSD's chunk-parallel form):
//   * s <= 64 (one chunk): one launch, ms_chunk_kernel, one CTA per (64
//     rows of dh, head, batch): C B^T, y = W x + exp(cum) C h0^T and
//     h_last = exp(T) h0 + S all in the CTA.
//   * s > 64: two launches. ms_state_kernel walks the chunks of each (64
//     rows of dh, head) in order, h_c = exp(T_c) h_{c-1} + S_c: one product
//     a chunk, h in registers, the next chunk's tiles in flight (cp.async,
//     double-buffered); it writes the state entering each chunk and h_last
//     (80 CTAs at the serve shape, 5 steps in a row). Extra CTAs
//     of the same launch compute C B^T once per (batch, chunk) for all 80
//     heads. Then ms_chunk_kernel runs every (chunk, head) at once (400
//     CTAs at the serve shape): y from C B^T (L2), the entering state and
//     x. Scratch (allocated by the wrapper): C B^T and the entering states.
//   * Every product runs on the tensor cores as mma.sync m16n8k8 TF32 in
//     the 3-term split form (a_hi b_hi + a_hi b_lo + a_lo b_hi), which
//     holds y to ~3e-5 of the fp32 plain version (plain TF32 keeps ~3
//     digits): each of 8 warps owns a 16 x 32 output tile. Tiles are
//     copied in their natural layout with 16-byte cp.async, all in flight
//     before the first barrier; rows are padded so fragment reads are
//     conflict-free.
//   * A ragged last chunk is masked by its length (any s is one call); dt
//     and dA are read with stride nh.
#include "mamba_scan.cuh"

namespace {

// State launch (s > 64). Grid (ndb, nh + nch, b). y < nh: the walk of
// (64 rows of dh, head) along the chunks (ms_walk): it writes the state
// entering every chunk but the first, and h_last. y = nh + c, x == 0: the
// C B^T tile of chunk c, for every head. Scratch: CB [b][nch][64][64], H
// [b][nch - 1][nh][ndb][64][st].
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
ms_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ dA, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ h0,
                float* __restrict__ cbg, float* __restrict__ H,
                float* __restrict__ h_last, int s, int nh, int dh, int st) {
  extern __shared__ double smem[];
  const int head = blockIdx.y, bb = blockIdx.z;
  if (head >= nh) {  // C B^T of chunk head - nh, shared by every head
    if (blockIdx.x == 0)
      ms_cb_tile(B, C, cbg, s, st, head - nh, bb, reinterpret_cast<float*>(smem + MS_CHUNK));
    return;
  }
  ms_walk<T, false, 4, false>(x, dt, dA, B, h0, H, h_last, s, nh, dh, st, head, bb,
                              blockIdx.x, smem);
}

// Chunk launch. Grid (ndb, nh, b * nch). One chunk (cbg null): C B^T, y
// and h_last here. Several: C B^T and the entering states from the state
// launch, y only.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
ms_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ dA, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ h0,
                const float* __restrict__ cbg, const float* __restrict__ S,
                T* __restrict__ y, float* __restrict__ h_last, int s, int nh,
                int dh, int st) {
  extern __shared__ double smem[];
  const bool one = cbg == nullptr;
  const MsLayout lay(st, one);
  double* cum = smem;
  float* f = reinterpret_cast<float*>(smem + MS_CHUNK);
  float *ec = f, *dts = f + MS_CHUNK, *sw = f + 2 * MS_CHUNK, *Ts = f + 3 * MS_CHUNK;
  float *xs = f + lay.x, *Cs = f + lay.c, *Hs = f + lay.h, *Bs = f + lay.b;

  const int nch = max(1, (s + MS_CHUNK - 1) / MS_CHUNK);
  const int ndb = (dh + MS_DB - 1) / MS_DB;
  const int c = (int)(blockIdx.z % nch), bb = blockIdx.z / nch;
  const int head = blockIdx.y, dblk = blockIdx.x, d0 = dblk * MS_DB;
  const int c0 = c * MS_CHUNK, L = max(0, min(MS_CHUNK, s - c0));
  const size_t row0 = (size_t)bb * s + c0;
  const int tid = threadIdx.x, warp = tid >> 5;
  // this warp's rows t0.. t0 + 15 and columns cc0.. cc0 + 31 of a tile
  const int t0 = (warp & 3) * 16, cc0 = (warp >> 2) * 32;
  const bool has_prev = h0 != nullptr || c > 0;
  const int lds = ms_lds(st), st8 = ms_st8(st);
  const size_t hrow = ((size_t)bb * nh + head) * dh + d0;  // h row of d = 0

  // every tile in flight at once (cp.async); C B^T into registers
  float cb[4][4];
  if (!one) {
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
  ms_cp_x(xs, x, row0, L, nh, head, dh, d0);
  ms_cp_tile(Cs, lds, C + row0 * st, st, L, st, st8);
  if (c > 0)  // the state entering chunk c, from the state launch
    ms_cp_tile(Hs, lds,
               S + ((((size_t)bb * (nch - 1) + c - 1) * nh + head) * ndb + dblk) *
                       (size_t)MS_DB * st,
               st, MS_DB, st, st8);
  else if (h0 != nullptr)
    ms_cp_tile(Hs, lds, h0 + hrow * st, st, dh - d0, st, st8);
  if (one) ms_cp_tile(Bs, lds, B + row0 * st, st, L, st, st8);
  if (tid < 32)
    ms_stats(ms_stats_load(dt, dA, row0 * nh + head, nh, L), cum, ec, dts, sw, Ts);
  ms_cp_wait();
  __syncthreads();

  // y = exp(cum_t) (C_t . h_prev^T) + W x, W[t][u] = (C_t . B_u)
  // exp(cum_t - cum_u) dt_u for u <= t < L (W^T goes over C)
  const bool rows = t0 < L;
  float yacc[4][4];
  ms_zero(yacc);
  if (one) {
    ms_zero(cb);
    if (rows && cc0 < L)
      ms_mma_tile<false, false>(cb, Cs, lds, 1, Bs, lds, 1, st8, t0, cc0);
  }
  if (has_prev && rows) {
    ms_mma_tile<false, false>(yacc, Cs, lds, 1, Hs, lds, 1, st8, t0, cc0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[nt][i] *= ec[ms_row(i)];
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ms_row(i), u = ms_col(nt, i);
      cb[nt][i] = (u <= t && t < L)
          ? cb[nt][i] * __expf((float)(cum[t] - cum[u])) * dts[u] : 0.f;
    }
  __syncthreads();  // every read of C done
  float* Wt = Cs;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) Wt[ms_col(nt, i) * MS_LD + ms_row(i)] = cb[nt][i];
  __syncthreads();
  if (rows) {
    ms_mma_tile<false, false>(yacc, Wt, 1, MS_LD, xs, 1, MS_LD, ms_st8(min(L, t0 + 16)),
                              t0, cc0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int t = ms_row(i), d = d0 + ms_col(nt, i);
        if (t < L)
          ms_store2(y + ((row0 + t) * nh + head) * dh + d, yacc[nt][i], yacc[nt][i + 1],
                    dh - d);
      }
  }
  if (!one) return;

  // one chunk: h_last = exp(T) h0 + sum_u (sw_u x_u) B_u^T
  const float e = expf(*Ts);
  for (int nb = 0; nb < st; nb += 64) {
    float acc[4][4];
    ms_state_tile<false>(acc, xs, Bs, lds, sw, L, nb);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int d = ms_row(i), n = nb + ms_col(nt, i);
        if (d >= dh - d0) continue;
        const float h0v = has_prev ? Hs[d * lds + n] : 0.f;
        const float h1v = has_prev ? Hs[d * lds + n + 1] : 0.f;
        ms_store2(h_last + (hrow + d) * st + n, fmaf(e, h0v, acc[nt][i]),
                  fmaf(e, h1v, acc[nt][i + 1]), st - n);
      }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* dA, const void* B,
           const void* C, const void* h0, void* y, void* h_last, void* scratch,
           int b, int s, int nh, int dh, int st, cudaStream_t stream) {
  const int nch = s > MS_CHUNK ? (s + MS_CHUNK - 1) / MS_CHUNK : 1;
  const int ndb = (dh + MS_DB - 1) / MS_DB;
  float* cbg = nullptr;
  float* S = nullptr;
  cudaError_t err;
  if (nch > 1) {
    cbg = (float*)scratch;
    S = cbg + (size_t)b * nch * MS_CB;
    const size_t smem = ms_state_smem(st);
    if ((err = att_smem_attr(ms_state_kernel<T>, smem)) != cudaSuccess) return (int)err;
    ms_state_kernel<T><<<dim3(ndb, nh + nch, b), MS_THREADS, smem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)dA, (const float*)B,
        (const float*)C, (const float*)h0, cbg, S, (float*)h_last, s, nh, dh, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t smem = MsLayout(st, nch == 1).bytes();
  if ((err = att_smem_attr(ms_chunk_kernel<T>, smem)) != cudaSuccess) return (int)err;
  ms_chunk_kernel<T><<<dim3(ndb, nh, b * nch), MS_THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)dA, (const float*)B,
      (const float*)C, (const float*)h0, cbg, S, (T*)y, (float*)h_last, s, nh,
      dh, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call needs (0 for s <= 64): C B^T of every chunk,
// then the state entering every chunk but the first.
REPRO_EXPORT long long mamba2_scan_scratch(int b, int s, int nh, int dh, int st) {
  const long long nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  if (nch <= 1) return 0;
  const long long ndb = (dh + MS_DB - 1) / MS_DB;
  return b * nch * MS_CB + b * (nch - 1) * nh * ndb * MS_DB * st;
}

// x [b, s, nh, dh] (dtype 0 = fp32, 1 = bf16); dt, dA [b, s, nh], B, C
// [b, s, st], h0 [b, nh, dh, st] or null, h_last [b, nh, dh, st]: fp32;
// y [b, s, nh, dh] in x's dtype; all contiguous; 1 <= st <= 256. For
// s > 64, scratch holds mamba2_scan_scratch() floats, 16-byte aligned (it
// may be null for s <= 64).
REPRO_EXPORT int mamba2_scan(const void* x, const void* dt, const void* dA,
                             const void* B, const void* C, const void* h0,
                             void* y, void* h_last, void* scratch, int b, int s,
                             int nh, int dh, int st, int dtype, void* stream) {
  if (b <= 0 || s < 0 || nh <= 0 || dh <= 0 || st <= 0 || st > 256)
    return (int)cudaErrorInvalidValue;
  if (mamba2_scan_scratch(b, s, nh, dh, st) > 0 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return launch<float>(x, dt, dA, B, C, h0, y, h_last, scratch, b, s, nh, dh,
                         st, cs);
  if (dtype == ATT_BF16)
    return launch<__nv_bfloat16>(x, dt, dA, B, C, h0, y, h_last, scratch, b, s,
                                 nh, dh, st, cs);
  return (int)cudaErrorInvalidValue;
}
