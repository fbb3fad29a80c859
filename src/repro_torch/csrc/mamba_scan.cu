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
// tile of steps, with cum the inclusive cumsum of dA over the tile:
//   y_t = sum_{u<=t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//         + exp(cum_t) (C_t . h_prev^T)
//   h  <- exp(cum_last) h + sum_u exp(cum_last - cum_u) dt_u x_u B_u^T
// The math does not depend on the tile length; the decay stays in the
// difference form exp(cum_t - cum_u), which never overflows (dA <= 0).
// cum is summed and differenced in fp64: in fp32 a prefix sum that has
// grown to ~-50 over a 64-step tile keeps only ~4e-6 of absolute
// precision, which made y's error against an exact sum ~1e-4 relative at
// the serve shape; in fp64 it is ~1e-5, that of the other fp32 sums.
//
// What bounds it on an H100: at the serve path's prefill (b 1, s 300,
// nh 80, dh 64, st 64, fp32) the inputs and outputs are ~15 MB (4.5 us at
// 3.35 TB/s), and the fp32 work is the intra-tile [c, c] products (C B^T
// once per batch and tile, W x per head) plus the two [dh, st] state
// products per step and head (y's C h^T and h's x B^T): ~0.5 GFLOP, ~7 us
// at the card's 67 TFLOP/s fp32 SIMT rate. So operations bound it, by a
// little.
//
// Design (a simple SIMT fp32 kernel that is right first; wgmma and TMA
// later):
//   * the TPU grid's sequential chunk axis becomes a loop inside the CTA:
//     one CTA per (32 rows of dh, head, batch), so the serve shape gives
//     2 x 80 = 160 CTAs for the 132 SMs; the rows of h are independent
//     given B, C, dt and dA, which is what makes the dh split free;
//   * the CTA keeps its h [32, st] slice in shared memory (fp32, rows
//     padded by one float) for the whole sequence and walks tiles of 64
//     steps; a ragged last tile is masked by its length, so any s is one
//     launch (the TPU wrapper halves its chunk until it divides s);
//   * per tile: B, C (rows padded: conflict-free dot products), the x
//     slice, dt and dA are staged in shared memory; one warp takes the
//     inclusive cumsum of dA (fp64) with a shuffle scan; the [64, 64] weight
//     tile W[t][u] = (C_t . B_u) exp(cum_t - cum_u) dt_u (u <= t) is
//     built once and serves every row, then y (intra + inter) and the
//     state update each take one thread per output;
//   * the cost of the split: every CTA recomputes C B^T, which is shared
//     by all heads (one group); a later version computes it once per
//     tile and moves the products onto the tensor cores.
#include "attention_common.cuh"

namespace {

constexpr int MS_CHUNK = 64;    // steps a tile (two per lane of one warp)
constexpr int MS_ROWS = 32;     // rows of h (entries of dh) a CTA owns
constexpr int MS_THREADS = 256;

size_t ms_smem_bytes(int st) {
  const size_t sp = (size_t)st + 1;
  return sizeof(double) * MS_CHUNK                          // cum
         + sizeof(float) * (2 * MS_CHUNK * sp               // B, C tiles
                            + MS_CHUNK * (MS_CHUNK + 1)     // W
                            + MS_CHUNK * MS_ROWS            // x tile
                            + MS_ROWS * sp                  // h slice
                            + 2 * MS_CHUNK);                // dt, sw
}

template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ dA, const float* __restrict__ B,
                  const float* __restrict__ C, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ h_last, int s,
                  int nh, int dh, int st) {
  extern __shared__ double smem[];
  const int sp = st + 1;
  constexpr int WP = MS_CHUNK + 1;
  double* cum = smem;                      // [MS_CHUNK] inclusive cumsum
  float* Bs = (float*)(cum + MS_CHUNK);    // [MS_CHUNK][st + 1]
  float* Cs = Bs + MS_CHUNK * sp;          // [MS_CHUNK][st + 1]
  float* W = Cs + MS_CHUNK * sp;           // [MS_CHUNK][MS_CHUNK + 1]
  float* xs = W + MS_CHUNK * WP;           // [MS_CHUNK][MS_ROWS]
  float* hs = xs + MS_CHUNK * MS_ROWS;     // [MS_ROWS][st + 1]
  float* dts = hs + MS_ROWS * sp;          // [MS_CHUNK]
  float* sw = dts + MS_CHUNK;              // [MS_CHUNK] exp(total-cum_u) dt_u

  const int d0 = blockIdx.x * MS_ROWS;
  const int head = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(MS_ROWS, dh - d0);
  const size_t hbase = (((size_t)bb * nh + head) * dh + d0) * st;

  for (int i = tid; i < MS_ROWS * st; i += MS_THREADS) {
    const int r = i / st, n = i % st;
    hs[r * sp + n] = (h0 != nullptr && r < rows) ? h0[hbase + i] : 0.f;
  }

  for (int c0 = 0; c0 < s; c0 += MS_CHUNK) {
    const int L = min(MS_CHUNK, s - c0);
    __syncthreads();  // h initialised / the previous tile fully consumed
    for (int i = tid; i < L * st; i += MS_THREADS) {
      const int t = i / st, n = i % st;
      const size_t g = ((size_t)bb * s + c0 + t) * st + n;
      Bs[t * sp + n] = B[g];
      Cs[t * sp + n] = C[g];
    }
    for (int i = tid; i < L * MS_ROWS; i += MS_THREADS) {
      const int t = i / MS_ROWS, r = i % MS_ROWS;
      xs[i] = r < rows
          ? att_load(x + (((size_t)bb * s + c0 + t) * nh + head) * dh + d0 + r)
          : 0.f;
    }
    if (tid < 32) {  // inclusive cumsum of dA over the tile, two steps a lane
      const int t0 = 2 * tid, t1 = t0 + 1;
      const size_t base = ((size_t)bb * s + c0) * nh + head;
      const double a0 = t0 < L ? dA[base + (size_t)t0 * nh] : 0.0;
      const double a1 = t1 < L ? dA[base + (size_t)t1 * nh] : 0.0;
      double incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(ATT_FULL, incl, o);
        if (tid >= o) incl += v;
      }
      double excl = __shfl_up_sync(ATT_FULL, incl, 1);
      if (tid == 0) excl = 0.0;
      cum[t0] = excl + a0;
      cum[t1] = (excl + a0) + a1;
      dts[t0] = t0 < L ? dt[base + (size_t)t0 * nh] : 0.f;
      dts[t1] = t1 < L ? dt[base + (size_t)t1 * nh] : 0.f;
    }
    __syncthreads();
    const double total = cum[L - 1];
    for (int i = tid; i < L * L; i += MS_THREADS) {
      const int t = i / L, u = i % L;
      if (u > t) continue;
      const float* cr = Cs + t * sp;
      const float* br = Bs + u * sp;
      float cb = 0.f;
#pragma unroll 8
      for (int n = 0; n < st; ++n) cb = fmaf(cr[n], br[n], cb);
      W[t * WP + u] = cb * expf((float)(cum[t] - cum[u])) * dts[u];
    }
    if (tid < L) sw[tid] = expf((float)(total - cum[tid])) * dts[tid];
    __syncthreads();
    // y: one thread a (step, row); the warp shares the step, so W and C
    // are broadcasts and x, h run along the row
    for (int i = tid; i < L * MS_ROWS; i += MS_THREADS) {
      const int t = i / MS_ROWS, r = i % MS_ROWS;
      const float* wr = W + t * WP;
      float acc = 0.f;
      for (int u = 0; u <= t; ++u) acc = fmaf(wr[u], xs[u * MS_ROWS + r], acc);
      const float* cr = Cs + t * sp;
      const float* hr = hs + r * sp;
      float ch = 0.f;
#pragma unroll 8
      for (int n = 0; n < st; ++n) ch = fmaf(cr[n], hr[n], ch);
      acc = fmaf(expf((float)cum[t]), ch, acc);
      if (r < rows)
        att_store(y + (((size_t)bb * s + c0 + t) * nh + head) * dh + d0 + r,
                  acc);
    }
    __syncthreads();  // every y read h_prev before the update
    const float dec = expf((float)total);
    for (int i = tid; i < MS_ROWS * st; i += MS_THREADS) {
      const int r = i / st, n = i % st;
      float acc = 0.f;
      for (int u = 0; u < L; ++u)
        acc = fmaf(sw[u] * xs[u * MS_ROWS + r], Bs[u * sp + n], acc);
      hs[r * sp + n] = fmaf(dec, hs[r * sp + n], acc);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * st; i += MS_THREADS)
    h_last[hbase + i] = hs[(i / st) * sp + i % st];
}

template <typename T>
int launch(const void* x, const void* dt, const void* dA, const void* B,
           const void* C, const void* h0, void* y, void* h_last, int b, int s,
           int nh, int dh, int st, cudaStream_t stream) {
  const size_t smem = ms_smem_bytes(st);
  cudaError_t err = att_smem_attr(mamba_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((dh + MS_ROWS - 1) / MS_ROWS, nh, b);
  mamba_scan_kernel<T><<<grid, MS_THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)dA, (const float*)B,
      (const float*)C, (const float*)h0, (T*)y, (float*)h_last, s, nh, dh,
      st);
  return (int)cudaGetLastError();
}

}  // namespace

// x [b, s, nh, dh] (dtype 0 = fp32, 1 = bf16); dt, dA [b, s, nh], B, C
// [b, s, st], h0 [b, nh, dh, st] or null, h_last [b, nh, dh, st]: fp32;
// y [b, s, nh, dh] in x's dtype; all contiguous; 1 <= st <= 256.
REPRO_EXPORT int mamba2_scan(const void* x, const void* dt, const void* dA,
                             const void* B, const void* C, const void* h0,
                             void* y, void* h_last, int b, int s, int nh,
                             int dh, int st, int dtype, void* stream) {
  if (b <= 0 || s < 0 || nh <= 0 || dh <= 0 || st <= 0 || st > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == ATT_F32)
    return launch<float>(x, dt, dA, B, C, h0, y, h_last, b, s, nh, dh, st, cs);
  if (dtype == ATT_BF16)
    return launch<__nv_bfloat16>(x, dt, dA, B, C, h0, y, h_last, b, s, nh, dh,
                                 st, cs);
  return (int)cudaErrorInvalidValue;
}
