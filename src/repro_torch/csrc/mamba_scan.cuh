// Device helpers of the chunked Mamba2 SSD scan, shared by its forward
// (mamba_scan.cu) and its backward (mamba_scan_bwd.cu): the tile copies,
// the 3xTF32 mma.sync products, the chunk statistics, the C B^T tile of a
// chunk and the walk of a state along the chunks (forward: the states
// entering each chunk; reversed: the gradients of the states leaving it).
#pragma once
#include "attention_common.cuh"

namespace {


constexpr int MS_CHUNK = 64;            // steps a chunk
constexpr int MS_DB = 64;               // rows of dh a CTA
constexpr int MS_LD = MS_CHUNK + 8;     // padded row of x and W^T
constexpr int MS_THREADS = 256;         // 8 warps, 16 x 32 outputs each
constexpr int MS_CB = MS_CHUNK * MS_CHUNK;

__host__ __device__ inline int ms_max(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int ms_st8(int st) { return (st + 7) & ~7; }
// Rows of the shared tiles (floats): whole 64-column blocks plus 4 for the
// C, B and h tiles, whose mma fragments run along the row (rows 4 banks
// apart), plus 8 for x, W^T and the walk's B tile, whose fragments run
// down the column (rows 8 banks apart): conflict-free fragment reads.
__host__ __device__ inline int ms_lds(int st) { return (st + 63) / 64 * 64 + 4; }
__host__ __device__ inline int ms_ldw(int st) { return (st + 63) / 64 * 64 + 8; }

// Shared memory: the fp64 cumsum [64], then floats: ec, dts, sw and T
// [64 each], x [u][d] (rows of MS_LD), C [t][n] (then W^T [u][t], rows of
// MS_LD), h_prev [d][n] and, for one chunk, B [u][n] (rows of ms_lds).
struct MsLayout {
  int x, c, h, b, floats;
  __host__ __device__ MsLayout(int st, bool one_chunk) {
    const int tile = MS_CHUNK * ms_lds(st);
    x = 4 * MS_CHUNK;
    c = x + MS_CHUNK * MS_LD;
    h = c + ms_max(tile, MS_CHUNK * MS_LD);
    b = h + tile;
    floats = b + (one_chunk ? tile : 0);
  }
  size_t bytes() const { return sizeof(double) * MS_CHUNK + sizeof(float) * floats; }
};

// cp.async of 4 or 16 bytes, global -> shared; ok == false zero-fills
// (no byte is read: src is then any valid address)
__device__ __forceinline__ void ms_cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void ms_cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void ms_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 64 rows of `cols` floats into shared rows of `ld`: source row r at
// src + r * sld, present for r < rows, its first vcols columns real, the
// rest (to cols) zero.
__device__ __forceinline__ void ms_cp_tile(float* dst, int ld, const float* src,
                                           size_t sld, int rows, int vcols, int cols) {
  const int c4 = cols >> 2;
  const bool vec = (vcols & 3) == 0 && (sld & 3) == 0 && ((uintptr_t)src & 15) == 0;
  if (vec && cols == 64) {  // the common tile: 4 copies a thread, no division
    const int r0 = threadIdx.x >> 4, c = (threadIdx.x & 15) * 4;
    const float* sp = src + r0 * sld + c;
#pragma unroll
    for (int k = 0; k < MS_CHUNK * 16 / MS_THREADS; ++k) {
      const int r = r0 + k * (MS_THREADS / 16);
      const bool ok = r < rows && c < vcols;
      ms_cp16(dst + r * ld + c, ok ? sp + (size_t)k * (MS_THREADS / 16) * sld : src, ok);
    }
  } else if (vec) {
    for (int i = threadIdx.x; i < MS_CHUNK * c4; i += MS_THREADS) {
      const int r = i / c4, c = (i % c4) * 4;
      const bool ok = r < rows && c < vcols;
      ms_cp16(dst + r * ld + c, ok ? src + r * sld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < MS_CHUNK * cols; i += MS_THREADS) {
      const int r = i / cols, c = i % cols;
      const bool ok = r < rows && c < vcols;
      ms_cp4(dst + r * ld + c, ok ? src + r * sld + c : src, ok);
    }
  }
}

__device__ __forceinline__ void ms_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// fp32 products on the tensor cores: mma.sync m16n8k8 TF32 in the split
// form a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi (a_hi: a's top 10 mantissa
// bits, a_lo = a - a_hi exactly, of which the mma reads the top bits),
// which keeps about fp32's accuracy where plain TF32 keeps ~3 digits.
__device__ __forceinline__ void ms_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void ms_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 x 32 output tile, four 16 x 8 mma tiles: acc[nt][i] is row
// r0 + g + 8 (i / 2), column c0 + 8 nt + 2 q + i % 2 (g = lane / 4,
// q = lane % 4). acc += sum_{k < K} A(row, k) B(k, column) (* bs[k]), K a
// multiple of 8, A(r, k) = A[r * ars + k * aks], B(k, n) = Bm[n * bns +
// k * bks]; the small terms go to their own accumulators (three
// independent chains). k0 (a multiple of 8) skips the steps k < k0, where
// a causal operand is zero for every row of the tile. ROUNDS: each step
// issues its 12 mma in three rounds of four independent ones, the steps
// unrolled by 4 (the backward's kernels: on an H100 its walk runs 12 % and
// its chunk launch 9 % faster so); else the three mma of a column block in
// turn, the steps not unrolled (the forward's kernels: with the rounds its
// state launch ran 7 % faster, but its chunk launch after it 17 % slower,
// at s 8,192). Each accumulator sums the same products in the same order
// either way.
template <bool SCALE_B = false, bool ROUNDS = true>
__device__ __forceinline__ void ms_mma_tile(float (&acc)[4][4], const float* A,
                                            int ars, int aks, const float* Bm,
                                            int bns, int bks, int K, int r0,
                                            int c0, const float* bs = nullptr,
                                            int k0 = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* ap = A + (r0 + g) * ars + q * aks;
  const float* bp = Bm + (c0 + g) * bns + q * bks;
  float sm[4][4];
  ms_zero(sm);
  if constexpr (ROUNDS) {
#pragma unroll 4
    for (int k = k0; k < K; k += 8) {
      uint32_t ah[4], al[4];
      ms_split(ap[k * aks], ah[0], al[0]);
      ms_split(ap[k * aks + 8 * ars], ah[1], al[1]);
      ms_split(ap[(k + 4) * aks], ah[2], al[2]);
      ms_split(ap[(k + 4) * aks + 8 * ars], ah[3], al[3]);
      const float s0 = SCALE_B ? bs[k + q] : 1.f, s1 = SCALE_B ? bs[k + q + 4] : 1.f;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        ms_split(bp[nt * 8 * bns + k * bks] * s0, bh[nt][0], bl[nt][0]);
        ms_split(bp[nt * 8 * bns + (k + 4) * bks] * s1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) ms_mma(sm[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) ms_mma(acc[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) ms_mma(sm[nt], ah, bl[nt][0], bl[nt][1]);
    }
  } else {
    for (int k = k0; k < K; k += 8) {
      uint32_t ah[4], al[4];
      ms_split(ap[k * aks], ah[0], al[0]);
      ms_split(ap[k * aks + 8 * ars], ah[1], al[1]);
      ms_split(ap[(k + 4) * aks], ah[2], al[2]);
      ms_split(ap[(k + 4) * aks + 8 * ars], ah[3], al[3]);
      const float s0 = SCALE_B ? bs[k + q] : 1.f, s1 = SCALE_B ? bs[k + q + 4] : 1.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        ms_split(bp[nt * 8 * bns + k * bks] * s0, bh0, bl0);
        ms_split(bp[nt * 8 * bns + (k + 4) * bks] * s1, bh1, bl1);
        ms_mma(sm[nt], al, bh0, bh1);
        ms_mma(sm[nt], ah, bl0, bl1);
        ms_mma(acc[nt], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += sm[nt][i];
}

// dA and dt of steps 2 lane and 2 lane + 1 of a chunk (0 past L)
__device__ __forceinline__ float4 ms_stats_load(const float* __restrict__ dt,
                                                const float* __restrict__ dA,
                                                size_t base, int nh, int L) {
  const int t0 = 2 * (threadIdx.x & 31), t1 = t0 + 1;
  return make_float4(t0 < L ? dA[base + (size_t)t0 * nh] : 0.f,
                     t1 < L ? dA[base + (size_t)t1 * nh] : 0.f,
                     t0 < L ? dt[base + (size_t)t0 * nh] : 0.f,
                     t1 < L ? dt[base + (size_t)t1 * nh] : 0.f);
}

// The inclusive cumsum of dA over the chunk (fp64, one warp, two steps a
// lane; steps past L add 0, so cum[63] is the total T), dt, exp(cum_t) and
// sw_u = exp(T - cum_u) dt_u, into shared memory. Warp 0 only.
__device__ __forceinline__ void ms_stats(float4 v, double* cum, float* ec,
                                         float* dts, float* sw, float* Ts) {
  const int lane = threadIdx.x;
  const int t0 = 2 * lane, t1 = t0 + 1;
  const double a0 = v.x, a1 = v.y;
  double incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(ATT_FULL, incl, o);
    if (lane >= o) incl += u;
  }
  double excl = __shfl_up_sync(ATT_FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  const double c0 = excl + a0, c1 = c0 + a1;
  const double total = __shfl_sync(ATT_FULL, c1, 31);
  cum[t0] = c0;
  cum[t1] = c1;
  ec[t0] = expf((float)c0);
  ec[t1] = expf((float)c1);
  dts[t0] = v.z;
  dts[t1] = v.w;
  sw[t0] = expf((float)(total - c0)) * v.z;
  sw[t1] = expf((float)(total - c1)) * v.w;
  if (lane == 0) *Ts = (float)total;
}

// x [u][d] of (rows row0.., head, d0..) into xs (rows of MS_LD)
__device__ __forceinline__ void ms_cp_x(float* xs, const float* __restrict__ x,
                                        size_t row0, int L, int nh, int head,
                                        int dh, int d0) {
  ms_cp_tile(xs, MS_LD, x + (row0 * nh + head) * dh + d0, (size_t)nh * dh, L,
             min(MS_DB, dh - d0), MS_DB);
}
__device__ __forceinline__ void ms_cp_x(float* xs, const __nv_bfloat16* __restrict__ x,
                                        size_t row0, int L, int nh, int head,
                                        int dh, int d0) {
#pragma unroll
  for (int k = 0; k < MS_CB / MS_THREADS; ++k) {
    const int i = threadIdx.x + k * MS_THREADS;
    const int u = i >> 6, d = i & 63;
    xs[u * MS_LD + d] = (u < L && d0 + d < dh)
        ? __bfloat162float(x[((row0 + u) * nh + head) * dh + d0 + d]) : 0.f;
  }
}

// The warp's part of S[d][n] = sum_u sw_u x_u[d] B_u[n] for the 64-column
// block nb of the state (x [u][d] rows of MS_LD, B [u][n] rows of ldb)
template <bool ROUNDS = true>
__device__ __forceinline__ void ms_state_tile(float (&acc)[4][4], const float* xs,
                                              const float* Bs, int ldb,
                                              const float* sw, int L, int nb) {
  const int warp = threadIdx.x >> 5;
  ms_zero(acc);
  ms_mma_tile<true, ROUNDS>(acc, xs, 1, MS_LD, Bs + nb, 1, ldb, ms_st8(L),
                            (warp & 3) * 16, (warp >> 2) * 32, sw);
}

// Two neighbouring elements (p[0], p[1]) of which `left` (> 0) lie in the
// row: one 8-byte store where they are aligned, else one or two scalars.
template <typename T>
__device__ __forceinline__ void ms_store2(T* p, float a, float b, int left) {
  if (left <= 0) return;
  if (left >= 2 && ((uintptr_t)p & (2 * sizeof(T) - 1)) == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    }
    return;
  }
  att_store(p, a);
  if (left >= 2) att_store(p + 1, b);
}

// Element i of a warp tile: its row and column within the [64][64] block
__device__ __forceinline__ int ms_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int ms_col(int nt, int i) {
  return (threadIdx.x >> 7) * 32 + 8 * nt + 2 * (threadIdx.x & 3) + (i & 1);
}

// A chunk's statistics as one record (floats): cum [64] as fp64, dt [64]
constexpr int MS_REC = 3 * MS_CHUNK;

// Warp 0, after ms_stats: the record of this chunk into rec (global)
__device__ __forceinline__ void ms_stats_store(float* __restrict__ rec, const double* cum,
                                               const float* dts) {
  __syncwarp();
  const int lane = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    reinterpret_cast<double*>(rec)[t] = cum[t];
    rec[2 * MS_CHUNK + t] = dts[t];
  }
}

// Floats of one slot of the walk (x [64][MS_LD], B [64][ldw], dA, dt)
__host__ __device__ inline int ms_slot(int st) {  // floats of a slot
  return MS_CHUNK * (MS_LD + ms_ldw(st)) + 2 * MS_CHUNK;
}
size_t ms_state_smem(int st) {
  const size_t walk = 4 * MS_CHUNK + 2 * (size_t)ms_slot(st);
  const size_t cb = 2 * (size_t)MS_CHUNK * ms_lds(st);
  return sizeof(double) * MS_CHUNK + sizeof(float) * (walk > cb ? walk : cb);
}

// The C B^T tile [64][64] of chunk c of batch row bb (rows and columns
// past the chunk's length zero), for every head (the forward's state
// launch). f: shared memory for two [64][ms_lds(st)] tiles.
__device__ __forceinline__ void ms_cb_tile(const float* __restrict__ B,
                                           const float* __restrict__ C,
                                           float* __restrict__ cbg, int s,
                                           int st, int c, int bb, float* f) {
  const int lds = ms_lds(st), st8 = ms_st8(st), warp = threadIdx.x >> 5;
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int L = min(MS_CHUNK, s - c * MS_CHUNK);
  const size_t row0 = (size_t)bb * s + c * MS_CHUNK;
  float *Cs = f, *Bs = f + MS_CHUNK * lds;
  ms_cp_tile(Cs, lds, C + row0 * st, st, L, st, st8);
  ms_cp_tile(Bs, lds, B + row0 * st, st, L, st, st8);
  ms_cp_wait();
  __syncthreads();
  float acc[4][4];
  ms_zero(acc);
  ms_mma_tile<false, false>(acc, Cs, lds, 1, Bs, lds, 1, st8, (warp & 3) * 16,
                            (warp >> 2) * 32);
  float* out = cbg + ((size_t)bb * nch + c) * MS_CB;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      *reinterpret_cast<float2*>(out + ms_row(i) * MS_CHUNK + ms_col(nt, i)) =
          make_float2(acc[nt][i], acc[nt][i + 1]);
}

// The walk of (64 rows of dh from dblk, head, batch row bb) along the
// chunks, with the state in registers (mma fragments) and the next chunk's
// tiles, dA and dt arriving (cp.async, two slots) while this chunk's
// product runs. Forward (REV false): h_c = exp(T_c) h_{c-1} + sum_u sw_u
// x_u B_u^T from init (h0; null = zeros), written after chunk c to mid
// slot c (the state entering chunk c + 1) and after the last chunk to end
// (h_last; null: not written). Reverse (REV true, x = dy, B = C): g_c =
// exp(T_c) g_{c+1} + sum_t exp(cum_t) dy_t C_t^T from init (dh_last; null
// = zeros), the chunks last to first, written after chunk c to mid slot
// c - 1 (the gradient of the state leaving chunk c - 1) and after chunk 0
// to end (dh0). mid: [b][nch - 1][nh][ndb][64][st], rows past dh zero;
// end: [b][nh][dh][st]. Shared memory: ms_state_smem(st). [c_lo, c_hi)
// limits the walk to a segment of the chunks: it starts from init only
// where the segment holds the walk's first chunk (the first forward, the
// last reversed), else from zeros. Dout (not null): for each chunk c the
// product of exp(T) over the segment's chunks walked before c, at
// [b][nch][nh]; Eout (not null): the product over the whole segment, at
// [b][c_lo / (c_hi - c_lo)][nh]; Sout (not null): each chunk's
// statistics record (MS_REC floats) at [b][nch][nh]. NQ: the 64-column
// blocks of st the state holds in registers (st <= 64 NQ); fewer
// registers let two CTAs share an SM. ROUNDS: ms_mma_tile's form.
template <typename T, bool REV, int NQ = 4, bool ROUNDS = true>
__device__ __forceinline__ void ms_walk(const T* __restrict__ x,
                                        const float* __restrict__ dt,
                                        const float* __restrict__ dA,
                                        const float* __restrict__ B,
                                        const float* __restrict__ init,
                                        float* __restrict__ mid,
                                        float* __restrict__ end, int s, int nh,
                                        int dh, int st, int head, int bb,
                                        int dblk, double* smem, int c_lo = 0,
                                        int c_hi = 1 << 30,
                                        float* __restrict__ Dout = nullptr,
                                        float* __restrict__ Eout = nullptr,
                                        float* __restrict__ Sout = nullptr) {
  const int ldw = ms_ldw(st);
  float* f = reinterpret_cast<float*>(smem + MS_CHUNK);
  const int nch = (s + MS_CHUNK - 1) / MS_CHUNK;
  const int ndb = (dh + MS_DB - 1) / MS_DB;
  const int tid = threadIdx.x;
  const int d0 = dblk * MS_DB;
  const int seg_len = c_hi - c_lo;
  c_hi = min(c_hi, nch);
  const int nk = c_hi - c_lo;
  if (!(REV ? c_hi == nch : c_lo == 0)) init = nullptr;
  double* cum = smem;
  float *ec = f, *dts = f + MS_CHUNK, *sw = f + 2 * MS_CHUNK, *Ts = f + 3 * MS_CHUNK;
  const float* wgt = REV ? ec : sw;  // the weight of a step's product
  float* slots = f + 4 * MS_CHUNK;  // two slots: x [64][MS_LD], B [64][ldw], dA, dt
  const int slot = ms_slot(st);
  const int dh_left = dh - d0;
  const size_t hrow = ((size_t)bb * nh + head) * dh + d0;  // h row of d = 0
  const size_t tile_h = (size_t)MS_DB * st;

  float h[NQ][4][4];  // the 64-column blocks q < NQ (st <= 64 NQ), mma fragments
#pragma unroll
  for (int qb = 0; qb < NQ; ++qb)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = ms_row(i), n = qb * 64 + ms_col(nt, i);
        h[qb][nt][i] = (init != nullptr && n < st && d < dh_left) ? init[(hrow + d) * st + n] : 0.f;
      }

  // the k-th chunk of the walk into slot k % 2; warp 0 copies dA and dt
  // itself, so its statistics need only its own wait
  auto chunk_of = [&](int k) { return REV ? c_hi - 1 - k : c_lo + k; };
  auto issue = [&](int k) {
    const int c = chunk_of(k);
    const int L = min(MS_CHUNK, s - c * MS_CHUNK);
    const size_t row0 = (size_t)bb * s + c * MS_CHUNK;
    float* sl = slots + (k & 1) * slot;
    ms_cp_x(sl, x, row0, L, nh, head, dh, d0);
    ms_cp_tile(sl + MS_CHUNK * MS_LD, ldw, B + row0 * st, st, L, st, ldw - 8);
    if (tid < 32) {
      float* st_a = sl + MS_CHUNK * (MS_LD + ldw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 2 * tid + j;
        const size_t gi = (row0 + t) * nh + head;
        ms_cp4(st_a + t, t < L ? dA + gi : dA, t < L);
        ms_cp4(st_a + MS_CHUNK + t, t < L ? dt + gi : dt, t < L);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  issue(0);
  float run = 1.f;  // thread 0: the product of exp(T) walked so far
  for (int k = 0; k < nk; ++k) {
    const int c = chunk_of(k);
    const int L = min(MS_CHUNK, s - c * MS_CHUNK);
    if (k + 1 < nk) {
      issue(k + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      ms_cp_wait();
    }
    float* sl = slots + (k & 1) * slot;
    if (tid < 32) {
      const float* st_a = sl + MS_CHUNK * (MS_LD + ldw);
      ms_stats(make_float4(st_a[2 * tid], st_a[2 * tid + 1], st_a[MS_CHUNK + 2 * tid],
                           st_a[MS_CHUNK + 2 * tid + 1]),
               cum, ec, dts, sw, Ts);
      if (Sout != nullptr)
        ms_stats_store(Sout + (((size_t)bb * nch + c) * nh + head) * MS_REC, cum, dts);
    }
    __syncthreads();
    const float e = expf(*Ts);
    if (Dout != nullptr && tid == 0) {
      Dout[((size_t)bb * nch + c) * nh + head] = run;
      run *= e;
    }
    const bool last = REV ? c == 0 : c == nch - 1;
    float* out = !last
        ? mid + ((((size_t)bb * (nch - 1) + (REV ? c - 1 : c)) * nh + head) * ndb + dblk) * tile_h
        : (end != nullptr ? end + hrow * st : nullptr);
#pragma unroll
    for (int qb = 0; qb < NQ; ++qb) {
      if (qb * 64 >= st) break;
      float acc[4][4];
      ms_state_tile<ROUNDS>(acc, sl, sl + MS_CHUNK * MS_LD, ldw, wgt, L, qb * 64);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          h[qb][nt][i] = fmaf(e, h[qb][nt][i], acc[nt][i]);
          h[qb][nt][i + 1] = fmaf(e, h[qb][nt][i + 1], acc[nt][i + 1]);
          const int d = ms_row(i), n = qb * 64 + ms_col(nt, i);
          // mid rows past dh stay zero (the chunk kernels read 64 rows)
          if (out != nullptr && (!last || d < dh_left))
            ms_store2(out + (size_t)d * st + n, h[qb][nt][i], h[qb][nt][i + 1], st - n);
        }
    }
    __syncthreads();  // this slot and the statistics are spent
  }
  if (Eout != nullptr && tid == 0) Eout[((size_t)bb * nch + c_lo / seg_len) * nh + head] = run;
}

}  // namespace
