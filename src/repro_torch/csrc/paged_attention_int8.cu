// Decode attention over an int8 paged KV arena (serving/paged.py's
// quant=True island): the exported entry of the kernel in
// paged_attention.cuh for int8 arenas, compiled beside paged_attention.cu.
// Its reference is the pure-JAX int8 island of
// src/repro/serving/paged.py:137-205 (the Pallas kernel of
// src/repro/kernels/paged_attention.py has no int8 path); the header says
// how the read path dequantizes and how the self term is folded in.
#include "paged_attention.cuh"

// paged_attention's contract (paged_attention.cu) with an int8 arena:
// arena_dtype 2, scales [cap, 2, block, kh] fp32 (one a row, k/v,
// position and kv head), the arena 16-byte aligned (8 for hd 8); q fp32 or
// bf16; blk_start and lse as there. Scratch sizes are
// paged_attention_scratch()'s.
REPRO_EXPORT int paged_attention_int8(const void* q, const void* arena,
                                      const void* scales, const void* kself,
                                      const void* vself, const void* pages,
                                      const void* lengths,
                                      const void* blk_start, void* out,
                                      void* lse, void* part, void* counters,
                                      int b, int h, int kh, int hd, int cap,
                                      int block, int nblk, int dtype,
                                      int arena_dtype, float scale,
                                      float softcap, int window, void* stream) {
  return pa_entry<true>(q, arena, scales, kself, vself, pages, lengths,
                        blk_start, out, lse, part, counters, b, h, kh, hd, cap,
                        block, nblk, dtype, arena_dtype, scale, softcap,
                        window, stream);
}
