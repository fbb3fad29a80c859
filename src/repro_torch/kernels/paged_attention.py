"""Decode attention over the paged KV arena through a page table (port of
``repro.kernels.paged_attention``).

The kernel is ``csrc/paged_attention.cuh``, exported by
``csrc/paged_attention.cu`` (arenas of q's dtype) and
``csrc/paged_attention_int8.cu`` (int8 arenas); :func:`paged_attention_ref`
beside it is its plain PyTorch version (the counterpart of
``repro.kernels.ref.paged_attention_ref``). The wrapper serves a CPU
tensor with the plain version and a CUDA tensor with the kernel; there is
no other route.

Contract: position ``j * block + t`` of sequence ``b`` lives at
``arena[pages[b, j], :, t]``; page ids outside ``[0, cap)`` (``-1``) are
missing; the first ``lengths[b]`` positions are visible, and with
``window > 0`` only those with ``lengths[b] - pos < window``. A sequence
with no visible position gives 0 (the reference's masking gives a mean of
masked rows there, which no caller reads).

The int8 arena (``scales`` given): the arena is int8 and ``scales``
``[cap, 2, block, kh]`` fp32 holds one dequantization scale a (row, k/v,
position, kv head); q is fp32 or bf16 and the math fp32, the K/V rows
dequantized as they are read. The self term (``kv_self = (k, v)``, each
``[b, kh, hd]`` in q's dtype) is one more key outside the arena, the
reference island's unquantized new token: with it, a sequence with
``lengths >= 0`` attends its ``lengths`` pool positions and that key, and
one with ``lengths < 0`` nothing (0).

The serving mesh's striped call form (``serving/paged.py``'s island over
a device mesh, where each stripe holds every ``stripe_total``-th block of
a sequence): ``blk_start`` [b, nblk] int32 gives the global position of
each page's first token, so that page ``j``'s position ``t`` is
``blk_start[b, j] + t`` (None: ``j * block``); the visibility test, the
window and the softcap read those positions. ``return_lse=True`` also
returns each row's log-sum-exp [b, h] fp32 (``m + log l`` of the scaled,
softcapped scores, the self term included), -1e30 for a row that sees
nothing (the self score where only the self term is visible), and then
the output is fp32: a partial that the island's combine across stripes
reads and rounds once, as the reference combines fp32 partials.

Each launch counts under the kernel it runs, as the library's
``paged_attention_form`` says: ``paged_attention`` (paged_split_kernel:
no ``blk_start``, no lse, pages of up to 64 positions, every earlier
caller's form, whose code, output and time are the kernel's earlier
ones), ``paged_attention_wide`` (paged_wide_kernel with an output of q's
dtype: ``blk_start`` given, or a longer page whose length is a multiple
of 64, the serving mesh's block 256, cut into 64-position parts) and
``paged_attention_lse`` (paged_wide_kernel with the lse).

The kernel splits each sequence's pages over CTAs (64 positions a split)
and, where more than one split sees something, merges their partial
softmax results by their log-sum-exp in the same launch; the wrapper keeps
the partials' buffer (sized by the library's ``paged_attention_scratch``)
and the zeroed-once split counters per device and stream. A CUDA graph
that captured a call keeps the two buffers it captured alive
(``_build.keep_alive``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS

NEG_INF = -1e30
ARENA_INT8 = 2   # the C entry's arena dtype code of an int8 arena
# the launch counter of each call form (``paged_attention_form``'s codes)
FORM_COUNTERS = ("paged_attention", "paged_attention_wide",
                 "paged_attention_lse")
_scratch: dict = {}


def _scratch_for(device, stream: int, n_part: int, n_counters: int):
    """The kernel's scratch for one device and stream, kept across calls
    (a larger one replaces it): the splits' partials (rewritten by every
    launch that merges) and the per-(sequence, kv head) split counters,
    zeroed when allocated and never per call (every launch leaves them at
    zero: atomicInc wraps)."""
    key = (device.index, stream)
    part, counters = _scratch.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 256), dtype=torch.int32,
                               device=device)
    _scratch[key] = (part, counters)
    return part, counters


def _check(q, arena, pages, lengths, scales=None, kv_self=None,
           blk_start=None):
    if q.dim() != 3 or arena.dim() != 5 or arena.shape[1] != 2:
        raise TypeError("q must be [b, h, hd] and arena [cap, 2, block, kh, "
                        "hd]")
    b, h, hd = q.shape
    if arena.shape[4] != hd or h % arena.shape[3]:
        raise TypeError(f"shapes do not fit: q {tuple(q.shape)}, arena "
                        f"{tuple(arena.shape)}")
    if pages.dim() != 2 or pages.shape[0] != b or pages.dtype != torch.int32:
        raise TypeError("pages must be a [b, nblk] int32 tensor")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError("lengths must be a [b] int32 tensor")
    dev = {q.device, arena.device, pages.device, lengths.device}
    if blk_start is not None:
        if blk_start.shape != pages.shape or blk_start.dtype != torch.int32:
            raise TypeError("blk_start must be a [b, nblk] int32 tensor")
        dev.add(blk_start.device)
    if arena.dtype == torch.int8:
        if scales is None or scales.dtype != torch.float32 \
                or scales.shape != arena.shape[:4]:
            raise TypeError("an int8 arena needs fp32 scales [cap, 2, block, "
                            "kh]")
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("q must be fp32 or bf16 over an int8 arena")
        dev.add(scales.device)
    elif scales is not None:
        raise TypeError("scales belong to an int8 arena")
    elif q.dtype != arena.dtype:
        raise TypeError("q and the arena must share a dtype")
    if kv_self is not None:
        for t in kv_self:
            if t.shape != (b, arena.shape[3], hd) or t.dtype != q.dtype:
                raise TypeError("the self term's k and v must be [b, kh, hd] "
                                "in q's dtype")
            dev.add(t.device)
    if len(dev) != 1:
        raise ValueError("q, arena, pages, lengths (and scales, the self "
                         "term, blk_start) must share a device")


def paged_attention_ref(q, arena, pages, lengths, *, scale: float,
                        softcap: float = 0.0, window: int = 0, scales=None,
                        kv_self=None, blk_start=None,
                        return_lse: bool = False):
    """Plain version: gathers every page's K/V (dequantized by ``scales``
    over an int8 arena) and takes one masked softmax, the self term as one
    more key, at the positions ``blk_start`` gives. Returns [b, h, hd] in
    q's dtype (fp32 math), and with ``return_lse`` (out [b, h, hd] fp32,
    lse [b, h] fp32)."""
    _check(q, arena, pages, lengths, scales, kv_self, blk_start)
    b, h, hd = q.shape
    cap, _, block, kh, _ = arena.shape
    nblk = pages.shape[1]
    g = h // kh
    present = (pages >= 0) & (pages < cap)
    safe = pages.clamp(0, cap - 1).long()
    blk = arena[safe].float()                        # [b, nblk, 2, blk, kh, hd]
    if scales is not None:
        blk = blk * scales[safe][..., None]
    k = blk[:, :, 0].reshape(b, nblk * block, kh, hd)
    v = blk[:, :, 1].reshape(b, nblk * block, kh, hd)
    qg = q.reshape(b, kh, g, hd).float() * scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    pos = torch.arange(nblk * block, device=q.device)[None]
    if blk_start is not None:   # [b, nblk * block] global positions
        pos = (blk_start[:, :, None] + torch.arange(
            block, device=q.device)).reshape(b, nblk * block)
    ok = pos < lengths[:, None]
    ok &= present.repeat_interleave(block, dim=1)
    if window and window > 0:
        ok &= (lengths[:, None] - pos) < window
    if kv_self is not None:   # one more key: the new token, unquantized
        ks, vs = (t.float()[:, None] for t in kv_self)
        s = torch.cat([s, torch.einsum("bkgd,btkd->bkgt", qg, ks)], dim=-1)
        v = torch.cat([v, vs], dim=1)
        ok = torch.cat([ok, (lengths >= 0)[:, None]], dim=1)
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(ok[:, None, None], s, NEG_INF)
    seen = ok.any(dim=1)
    p = torch.softmax(s, dim=-1) * seen[:, None, None, None]
    o = torch.einsum("bkgt,btkd->bkgd", p, v).reshape(b, h, hd)
    if not return_lse:
        return o.to(q.dtype)
    lse = torch.where(seen[:, None], torch.logsumexp(s, dim=-1).reshape(
        b, h), NEG_INF)
    return o, lse


def paged_attention(q, arena, pages, lengths, *, scale: float,
                    softcap: float = 0.0, window: int = 0, scales=None,
                    kv_self=None, blk_start=None, return_lse: bool = False):
    """Contract of :func:`paged_attention_ref` (kernel on CUDA tensors:
    fp32 or bf16 q over an arena of q's dtype or an int8 one, head dim in
    ``HEAD_DIMS``). ``arena`` (and ``scales``) must be contiguous (a layer
    of a layer-major arena is): they are read in place."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, arena, pages, lengths, scale=scale,
                                   softcap=softcap, window=window,
                                   scales=scales, kv_self=kv_self,
                                   blk_start=blk_start,
                                   return_lse=return_lse)
    _build.require_cuda(q, "paged_attention")
    _check(q, arena, pages, lengths, scales, kv_self, blk_start)
    b, h, hd = q.shape
    cap, _, block, kh, _ = arena.shape
    if q.dtype not in DTYPE_CODES or hd not in HEAD_DIMS:
        raise TypeError(f"paged_attention takes fp32/bf16 and head dims "
                        f"{HEAD_DIMS}, not {q.dtype} / {hd}")
    if not arena.is_contiguous() or (scales is not None
                                     and not scales.is_contiguous()):
        raise ValueError("paged_attention reads the arena in place: pass a "
                         "contiguous arena (and scales)")
    align = min(16, hd * arena.element_size())
    if arena.data_ptr() % align:
        raise ValueError(f"paged_attention reads the arena with {align}-byte "
                         f"loads: its storage must start {align}-byte aligned")
    q, pages, lengths = q.contiguous(), pages.contiguous(), lengths.contiguous()
    ks_ptr = vs_ptr = None
    if kv_self is not None:
        kv_self = tuple(t.contiguous() for t in kv_self)
        ks_ptr, vs_ptr = kv_self[0].data_ptr(), kv_self[1].data_ptr()
    if blk_start is not None:
        blk_start = blk_start.contiguous()
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse
                      else q.dtype, device=q.device)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    nblk = pages.shape[1]
    lib = _build.lib("paged_attention")
    stream = _build.stream_ptr(q.device)
    part_ptr = counters_ptr = None
    n_part = lib.paged_attention_scratch(b, h, hd, block, nblk)
    if n_part:  # more than one split a sequence: partials and counters
        part, counters = _scratch_for(q.device, stream, n_part, b * kh)
        part_ptr, counters_ptr = part.data_ptr(), counters.data_ptr()
        # a graph that captures this call reads them on every replay, even
        # after a wider call has replaced them here
        _build.keep_alive(part)
        _build.keep_alive(counters)
    # an int8 arena's instantiations are a library of their own
    # (csrc/paged_attention_int8.cu), built beside the others
    entry = (_build.lib("paged_attention_int8").paged_attention_int8
             if scales is not None else lib.paged_attention)
    err = entry(
        q.data_ptr(), arena.data_ptr(),
        None if scales is None else scales.data_ptr(), ks_ptr, vs_ptr,
        pages.data_ptr(), lengths.data_ptr(),
        None if blk_start is None else blk_start.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), part_ptr, counters_ptr, b,
        h, kh, hd, cap, block, nblk, DTYPE_CODES[q.dtype],
        ARENA_INT8 if scales is not None else DTYPE_CODES[q.dtype],
        float(scale), float(softcap), int(window), stream)
    _build.check(err, "paged_attention")
    _build.count_launch(FORM_COUNTERS[lib.paged_attention_form(
        block, blk_start is not None, return_lse)])
    return (out, lse) if return_lse else out
