"""Fused WHERE scan + compaction over int32 table columns (the FusedScan
route of every SELECT / DELETE / UPDATE / aggregate).

Two kernels, in ``csrc/relscan.cu``, each with its plain PyTorch version
beside it in this module:

``scan``     AND of 1..4 ``col OP value`` terms with the validity bitmap ->
             match mask ``[w, cap]``, per-block match counts
             ``[w, nblk]`` (``BLOCK`` rows a block) and each row's total
             ``count [w]``, in one launch. ``vals`` is a ``[w, nterms]``
             value matrix: ``w`` statements scan the same columns in one
             launch. With ``sid [w]`` (a sharded table) the columns and
             validity are ``[S, cap_s]`` stacks and statement row ``q``
             scans shard ``sid[q]``: a fan-out passes every (shard,
             statement) pair, a micro-batch of pruned statements one
             shard each, still in one launch.
``compact``  the first ``limit`` set bits of every mask row as row ids,
             in row order, 0-padded, and the unclamped count of each row
             (the JAX package's ``compact(mask, *, limit)`` helper, with
             the count beside the ids): one launch, nothing else. A
             sharded fan-out passes the scan's ``[S * w, cap_s]`` mask,
             one row a (shard, statement) pair, and gets each shard's
             candidates in its own row ids.

A wrapper serves a CPU tensor with the plain version and a CUDA tensor
with its kernel; there is no other route. :func:`relscan` chains the two
with the contract of ``repro.kernels.relscan.relscan``, batched over ``w``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_TERMS = 4
BLOCK = 256  # rows a block; csrc/common.cuh RS_BLOCK
SC_STMTS = 8  # statements a scan CTA takes at most; csrc/relscan.cu

OP_CODES = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

_CMP = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def n_blocks(cap: int) -> int:
    return -(-cap // BLOCK)


def block_counts(mask: torch.Tensor) -> torch.Tensor:
    """Per-block set-bit counts ``[w, nblk]`` int32 of a ``[w, cap]`` mask
    (what the scan kernel emits beside its mask)."""
    w, cap = mask.shape
    nblk = n_blocks(cap)
    padded = torch.zeros((w, nblk * BLOCK), dtype=torch.int32,
                         device=mask.device)
    padded[:, :cap] = mask.to(torch.int32)
    return padded.view(w, nblk, BLOCK).sum(dim=2, dtype=torch.int32)


def _check_scan(cols, valid, vals, ops, sid):
    if not 1 <= len(ops) <= MAX_TERMS or len(cols) != len(ops):
        raise ValueError(f"relscan supports 1..{MAX_TERMS} terms")
    for op in ops:
        if op not in OP_CODES:
            raise ValueError(f"unknown comparison {op!r}")
    if valid.dtype != torch.bool or valid.dim() != (1 if sid is None else 2):
        raise TypeError("valid must be a [cap] (with sid: [S, cap_s]) bool "
                        "tensor")
    if vals.dim() != 2 or vals.shape[1] != len(ops) or vals.dtype != torch.int32:
        raise TypeError("vals must be a [w, nterms] int32 tensor")
    if sid is not None and (sid.shape != (vals.shape[0],)
                            or sid.dtype != torch.int32
                            or sid.device != valid.device):
        raise TypeError("sid must be a [w] int32 tensor beside valid")
    for c in cols:
        if c.shape != valid.shape or c.dtype != torch.int32:
            raise TypeError("every column must be an int32 tensor shaped "
                            "like valid")
        if c.device != valid.device:
            raise ValueError("columns and validity must share a device")
    if vals.device != valid.device:
        raise ValueError("vals and validity must share a device")


def scan_ref(cols: Sequence[torch.Tensor], valid: torch.Tensor,
             vals: torch.Tensor, ops: tuple[str, ...], sid=None):
    """Plain version of the scan kernel: (mask [w, cap] bool,
    cnt [w, nblk] int32, count [w] int32 = cnt's row sums). With ``sid``
    ([w] int32) the columns and validity are ``[S, cap]`` stacks and row
    ``q`` reads shard ``sid[q]``."""
    _check_scan(cols, valid, vals, ops, sid)
    if sid is None:
        mask = valid[None, :].expand(vals.shape[0], -1)
        rows = [c[None, :] for c in cols]
    else:
        s = sid.long()
        mask, rows = valid[s], [c[s] for c in cols]
    for t, op in enumerate(ops):
        mask = mask & _CMP[op](rows[t], vals[:, t:t + 1])
    cnt = block_counts(mask)
    return mask, cnt, cnt.sum(dim=1, dtype=torch.int32)


def scan(cols: Sequence[torch.Tensor], valid: torch.Tensor,
         vals: torch.Tensor, ops: tuple[str, ...], sid=None, run: int = 1):
    """Fused conjunction scan; on CUDA tensors one kernel launch and no
    other device op, whatever the number of shards. Contract of
    :func:`scan_ref`. ``run`` tells the kernel that the rows of ``vals``
    come in runs of that many on one shard (a fan-out's statement count):
    a CTA then takes a run's rows (up to 8) from one load of the shard.
    It changes no result."""
    if valid.device.type == "cpu":
        return scan_ref(cols, valid, vals, ops, sid)
    _build.require_cuda(valid, "relscan_scan")
    _check_scan(cols, valid, vals, ops, sid)
    cols = [c.contiguous() for c in cols]
    vals = vals.contiguous()
    cap, w = valid.shape[-1], vals.shape[0]
    dev = valid.device
    mask = torch.empty((w, cap), dtype=torch.bool, device=dev)
    cnt = torch.empty((w, n_blocks(cap)), dtype=torch.int32, device=dev)
    count = torch.empty((w,), dtype=torch.int32, device=dev)
    if w == 0 or cap == 0:
        return mask, cnt, count.zero_()
    stream = _build.stream_ptr(dev)
    acc = _zeroed_scratch("scan", dev, stream, w)
    ptrs = [c.data_ptr() for c in cols] + [cols[0].data_ptr()] * (
        MAX_TERMS - len(cols))
    codes = [OP_CODES[o] for o in ops] + [0] * (MAX_TERMS - len(ops))
    err = _build.lib("relscan").relscan_scan(
        *ptrs, *codes, len(ops), valid.contiguous().data_ptr(),
        vals.data_ptr(), None if sid is None else sid.contiguous().data_ptr(),
        math.gcd(run, SC_STMTS), cap, w, mask.data_ptr(),
        cnt.data_ptr(), count.data_ptr(), acc.data_ptr(), stream)
    _build.check(err, "relscan_scan")
    _build.count_launch("relscan_scan")
    return mask, cnt, count


def _check_compact(mask, limit):
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise TypeError("mask must be a [w, cap] bool tensor")
    if limit < 1:
        raise ValueError("limit must be >= 1")


def compact_ref(mask: torch.Tensor, limit: int):
    """Plain version of the compaction kernel: (ids [w, limit] int32, the
    first ``limit`` set bits of every mask row as row ids in row order,
    0-padded; count [w] int32, the set bits of each row, unclamped)."""
    _check_compact(mask, limit)
    w, cap = mask.shape
    m32 = mask.to(torch.int32)
    pos = torch.cumsum(m32, dim=1, dtype=torch.int32) - 1
    tgt = torch.where(mask & (pos < limit), pos, limit).long()
    ids = torch.zeros((w, limit + 1), dtype=torch.int32, device=mask.device)
    rows = torch.arange(cap, dtype=torch.int32,
                        device=mask.device).expand(w, -1)
    ids.scatter_(1, tgt, rows)  # overflow rows land in the scratch column
    return ids[:, :limit].contiguous(), m32.sum(dim=1, dtype=torch.int32)


# rows of a mask one compaction CTA covers; csrc/relscan.cu CP_TILE
COMPACT_TILE = 16384
_scratch: dict = {}


def _zeroed_scratch(kind: str, device, stream: int, n: int) -> torch.Tensor:
    """A kernel's persistent int64 scratch of at least ``n`` words for one
    device and stream, zeroed once when it is allocated (a larger one
    replaces it), never per call. The scan's words (one a statement) are
    zero again after every launch, and so are the hash build's (its bucket
    counters, overflow word and arrival counts, as int32; its other
    buffer's contents do not matter). The compaction's hold two
    uint32 control words (the launch epoch, CTAs done) in word 0, then
    look-back flags: each flag carries the epoch of the launch that wrote
    it, and each launch moves the epoch on. A CUDA graph that captures a
    call keeps the buffer it used (``_build.keep_alive``): a replaced
    buffer lives on for the graphs that still read it."""
    key = (kind, device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int64, device=device)
        _scratch[key] = buf
    _build.keep_alive(buf)
    return buf


def compact(mask: torch.Tensor, limit: int):
    """Bitmap -> (first ``limit`` row ids, unclamped count) per row; on a
    CUDA tensor one kernel launch and no other device op. Contract of
    :func:`compact_ref`."""
    _check_compact(mask, limit)
    if mask.device.type == "cpu":
        return compact_ref(mask, limit)
    _build.require_cuda(mask, "relscan_compact")
    w, cap = mask.shape
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    ids = torch.empty((w, limit), dtype=torch.int32, device=mask.device)
    count = torch.empty((w,), dtype=torch.int32, device=mask.device)
    if w == 0:
        return ids, count
    stream = _build.stream_ptr(mask.device)
    scratch = _zeroed_scratch("compact", mask.device, stream,
                              w * -(-(cap + 15) // COMPACT_TILE) + 1)
    err = _build.lib("relscan").relscan_compact(
        mask.data_ptr(), mask.stride(0), cap, w, limit, ids.data_ptr(),
        count.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 8, stream)
    _build.check(err, "relscan_compact")
    _build.count_launch("relscan_compact")
    return ids, count


def relscan(cols: Sequence[torch.Tensor], valid: torch.Tensor,
            vals: torch.Tensor, *, ops: tuple[str, ...], limit: int,
            want_ids: bool = True):
    """Fused conjunction scan + compaction for ``w`` statements.

    cols: one [cap] int32 tensor per term (a column may repeat);
    vals: [w, nterms] int32 runtime values; valid: [cap] bool.

    Returns (ids [w, limit] int32 first matching row ids in row order,
    0-padded; present [w, limit] bool; mask [w, cap] bool; count [w]
    int32, unclamped). ``want_ids=False`` skips the compaction and returns
    None for ids and present."""
    mask, _, count = scan(cols, valid, vals, ops)
    if not want_ids:
        return None, None, mask, count
    ids, _ = compact(mask, limit)
    present = torch.arange(limit, dtype=torch.int32,
                           device=mask.device)[None, :] < count[:, None]
    return ids, present, mask, count
