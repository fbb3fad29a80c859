"""Decode attention over the paged KV arena through a page table (port of
``repro.kernels.paged_attention``).

The kernel is ``csrc/paged_attention.cu``; :func:`paged_attention_ref`
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


def _check(q, arena, pages, lengths):
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
    if q.dtype != arena.dtype:
        raise TypeError("q and the arena must share a dtype")
    if not (q.device == arena.device == pages.device == lengths.device):
        raise ValueError("q, arena, pages and lengths must share a device")


def paged_attention_ref(q, arena, pages, lengths, *, scale: float,
                        softcap: float = 0.0, window: int = 0):
    """Plain version: gathers every page's K/V and takes one masked
    softmax. Returns [b, h, hd] in q's dtype (fp32 math)."""
    _check(q, arena, pages, lengths)
    b, h, hd = q.shape
    cap, _, block, kh, _ = arena.shape
    nblk = pages.shape[1]
    g = h // kh
    present = (pages >= 0) & (pages < cap)
    blk = arena[pages.clamp(0, cap - 1).long()]      # [b, nblk, 2, blk, kh, hd]
    k = blk[:, :, 0].reshape(b, nblk * block, kh, hd).float()
    v = blk[:, :, 1].reshape(b, nblk * block, kh, hd).float()
    qg = q.reshape(b, kh, g, hd).float() * scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(nblk * block, device=q.device)
    ok = pos[None] < lengths[:, None]
    ok &= present.repeat_interleave(block, dim=1)
    if window and window > 0:
        ok &= (lengths[:, None] - pos[None]) < window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * ok.any(dim=1)[:, None, None, None]
    o = torch.einsum("bkgt,btkd->bkgd", p, v)
    return o.reshape(b, h, hd).to(q.dtype)


def paged_attention(q, arena, pages, lengths, *, scale: float,
                    softcap: float = 0.0, window: int = 0):
    """Contract of :func:`paged_attention_ref` (kernel on CUDA tensors:
    fp32 or bf16, head dim in ``HEAD_DIMS``). ``arena`` must be
    contiguous (a layer of a layer-major arena is): it is read in place."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, arena, pages, lengths, scale=scale,
                                   softcap=softcap, window=window)
    _build.require_cuda(q, "paged_attention")
    _check(q, arena, pages, lengths)
    b, h, hd = q.shape
    cap, _, block, kh, _ = arena.shape
    if q.dtype not in DTYPE_CODES or hd not in HEAD_DIMS:
        raise TypeError(f"paged_attention takes fp32/bf16 and head dims "
                        f"{HEAD_DIMS}, not {q.dtype} / {hd}")
    if not arena.is_contiguous():
        raise ValueError("paged_attention reads the arena in place: pass a "
                         "contiguous arena")
    if arena.data_ptr() % 16:
        raise ValueError("paged_attention reads the arena with 16-byte "
                         "loads: its storage must start 16-byte aligned")
    q, pages, lengths = q.contiguous(), pages.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
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
    err = lib.paged_attention(
        q.data_ptr(), arena.data_ptr(), pages.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_ptr, counters_ptr, b, h, kh, hd, cap, block,
        nblk, DTYPE_CODES[q.dtype], float(scale), float(softcap),
        int(window), stream)
    _build.check(err, "paged_attention")
    _build.count_launch("paged_attention")
    return out
