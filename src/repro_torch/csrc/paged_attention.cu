// Decode attention over the paged KV arena, arenas of q's dtype (fp32,
// bf16): the exported entry of the kernel in paged_attention.cuh, whose
// header says what it replaces, what bounds it and how it is designed.
// paged_attention_int8.cu exports the int8 arenas' instantiations.
#include "paged_attention.cuh"

// Floats of the partials' scratch paged_attention needs for these shapes:
// b * kh * nsplit * g * (hd + 2) (o, m, l of every split), or 0 when a
// sequence is one split and the kernel needs no scratch. With partials it
// also needs b * kh counters. The same for an int8 arena.
REPRO_EXPORT long long paged_attention_scratch(int b, int h, int hd, int block,
                                               int nblk) {
  if (block <= 0) return 0;
  const long long nsplit = pa_nsplit(block, nblk);
  return nsplit > 1 ? (long long)b * h * nsplit * (hd + 2) : 0;
}

// The kernel a call launches (the same for an int8 arena): 0
// paged_split_kernel (no block starts, no lse, block <= 64), 1
// paged_wide_kernel with an output of q's dtype (block starts, or pages
// of 256 cut into 64-position parts), 2 paged_wide_kernel with the lse
// and an fp32 output. The wrapper counts each launch under its form.
REPRO_EXPORT int paged_attention_form(int block, int blk_start, int lse) {
  return pa_form(block, blk_start != 0, lse != 0);
}

// q [b, h, hd] (dtype 0 = fp32, 1 = bf16); arena [cap, 2, block, kh, hd]
// in q's dtype (arena_dtype = dtype; scales null), 16-byte aligned;
// k_self / v_self [b, kh, hd] in q's dtype, or both null (no self term);
// pages [b, nblk] int32; lengths [b] int32; blk_start [b, nblk] int32,
// each page's first global position, or null (page j starts at j *
// block); out [b, h, hd]; lse [b, h] fp32, the rows' log-sum-exp, or null.
// Where paged_attention_scratch() is not 0, part holds that many floats
// and counters b * kh zeroed uint32 (left at zero by every launch); else
// both may be null.
REPRO_EXPORT int paged_attention(const void* q, const void* arena,
                                 const void* scales, const void* kself,
                                 const void* vself, const void* pages,
                                 const void* lengths, const void* blk_start,
                                 void* out, void* lse, void* part,
                                 void* counters, int b, int h, int kh, int hd,
                                 int cap, int block, int nblk, int dtype,
                                 int arena_dtype, float scale, float softcap,
                                 int window, void* stream) {
  return pa_entry<false>(q, arena, scales, kself, vself, pages, lengths,
                         blk_start, out, lse, part, counters, b, h, kh, hd,
                         cap, block, nblk, dtype, arena_dtype, scale, softcap,
                         window, stream);
}
