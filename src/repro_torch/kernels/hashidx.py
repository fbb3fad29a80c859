"""Device-resident bucketed hash index over an int32 key column: bulk
build, batched probe and incremental insert maintenance.

Index layout (one per indexed column, inside the table state), as in
``repro.kernels.hashidx``:

    rid  [n_buckets, BUCKET_CAP] int32   row ids, ``EMPTY`` (-1) = free lane
    key  [n_buckets, BUCKET_CAP] int32   the key stored at insert time
    stale [] int32                       > 0: the index may miss rows and
                                         every probe takes the scan path

Two kernels, in ``csrc/hashidx.cu``, each with its plain PyTorch version
beside it: ``build`` (a counting sort by bucket in two launches: rows take
slots, then each bucket orders its rows) and the probe (one bucket row per
query key). The probe kernel serves two
wrappers: ``probe`` (the TPU kernel's contract: candidates and hit bits)
and ``probe_verify`` (the executors' whole IndexProbe route in the same
launch: candidate verification against the table, the match count and
the first ``limit`` matches in row order). A wrapper serves a CPU tensor
with the plain version and a CUDA tensor with its kernel.

Sharded tables (``core/shards.py``) keep one index per shard, stacked:
``rid`` / ``key`` ``[S, n_buckets, 128]`` and ``stale [S]``. The build
takes ``[S, cap_s]`` keys and validity and rebuilds every shard's index
in the same two launches; the verified probe takes ``sid [w]``, the shard
of each query, and probes every query on its own shard in one launch.
``insert_update_batched`` is plain PyTorch on every device (it was no
Pallas kernel in the reference either).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.relscan import _CMP, OP_CODES, _zeroed_scratch

LANES = 128
BUCKET_CAP = LANES
EMPTY = -1
_PRIME = 2654435761  # 2^32 / phi: Fibonacci hashing multiplier
_PRIME_HI, _PRIME_LO = _PRIME >> 16, _PRIME & 0xFFFF


def n_buckets_for(capacity: int) -> int:
    """Next power of two of capacity/32, floored at 8 (mean occupancy
    32/128 at full capacity)."""
    target = max(8, -(-capacity // 32))
    nb = 1
    while nb < target:
        nb *= 2
    return nb


def hash32(keys: torch.Tensor) -> torch.Tensor:
    """The 32-bit product ``uint32(key) * _PRIME`` (uint32 wraparound) as
    int64. Computed from two 16-bit halves of the multiplier, so no
    product leaves the int64 range and negative keys wrap exactly as the
    uint32 cast does."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    return (k * _PRIME_LO + (((k * _PRIME_HI) & 0xFFFF) << 16)) & 0xFFFFFFFF


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Multiplicative hash -> bucket id: the top ``lg`` bits of
    :func:`hash32`."""
    lg = n_buckets.bit_length() - 1
    return (hash32(keys) >> (32 - lg)).to(torch.int32)


def empty_index(n_buckets: int, device) -> dict:
    """A fresh (all lanes free) index for an empty table."""
    return {
        "rid": torch.full((n_buckets, BUCKET_CAP), EMPTY, dtype=torch.int32,
                          device=device),
        "key": torch.zeros((n_buckets, BUCKET_CAP), dtype=torch.int32,
                           device=device),
        "stale": torch.zeros((), dtype=torch.int32, device=device),
    }


# ------------------------------------------------------------------- build

def _build_sorted(keys: torch.Tensor, valid: torch.Tensor, n_buckets: int):
    """The plain build's prologue: one stable sort groups row ids by bucket
    (invalid rows last under sentinel ``n_buckets``). Returns (order, sb,
    start, overflow) as ``repro.kernels.hashidx._build_sorted``: the sort
    must be stable, or lane layouts differ from the reference."""
    cap = keys.shape[0]
    dev = keys.device
    b = torch.where(valid, bucket_of(keys, n_buckets), n_buckets)
    sb, order = torch.sort(b, stable=True)
    sb = sb.contiguous()
    start = torch.searchsorted(
        sb, torch.arange(n_buckets, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    rank = torch.arange(cap, dtype=torch.int64, device=dev) - \
        torch.searchsorted(sb, sb, side="left")
    overflow = ((sb < n_buckets) & (rank >= BUCKET_CAP)).sum(
        dtype=torch.int32)
    return order.to(torch.int32), sb, start, overflow


def _check_build(keys, valid, n_buckets):
    if keys.dim() not in (1, 2) or keys.dtype != torch.int32:
        raise TypeError("keys must be a [cap] or [S, cap_s] int32 tensor")
    if valid.shape != keys.shape or valid.dtype != torch.bool:
        raise TypeError("valid must be a [cap] bool tensor")
    if valid.device != keys.device:
        raise ValueError("keys and valid must share a device")
    if n_buckets < 2:
        raise ValueError("n_buckets must be >= 2 (the bucket id is the top "
                         "bit_length(n_buckets) - 1 bits of the hash)")


def build_ref(keys: torch.Tensor, valid: torch.Tensor, *, n_buckets: int):
    """Plain version: gather each bucket's sorted segment. Returns
    (rid [nb, 128]: each bucket's first 128 valid rows in row order,
    ``EMPTY`` after; key [nb, 128]: their keys, 0 after; overflow [] int32:
    the valid rows past 128 summed over the buckets). Only the top
    ``bit_length(nb) - 1`` bits of the hash pick a bucket, so when ``nb``
    is no power of two the buckets from the largest power of two below it
    stay empty. ``[S, cap_s]`` keys and validity build each shard's index
    alone: rid / key ``[S, nb, 128]`` in the shard's own row ids,
    overflow ``[S]``."""
    _check_build(keys, valid, n_buckets)
    if keys.dim() == 2:
        outs = [build_ref(k, v, n_buckets=n_buckets)
                for k, v in zip(keys, valid)]
        return tuple(torch.stack(x) for x in zip(*outs))
    cap = keys.shape[0]
    dev = keys.device
    order, sb, start, overflow = _build_sorted(keys, valid, n_buckets)
    orderp = torch.cat([order, torch.full((BUCKET_CAP,), cap,
                                          dtype=torch.int32, device=dev)])
    sbp = torch.cat([sb, torch.full((BUCKET_CAP,), n_buckets,
                                    dtype=torch.int32, device=dev)])
    pos = (start[:, None].long()
           + torch.arange(BUCKET_CAP, device=dev)[None, :])
    ok = sbp[pos] == torch.arange(n_buckets, dtype=torch.int32,
                                  device=dev)[:, None]
    rid = torch.where(ok, orderp[pos], EMPTY)
    keysp = torch.cat([keys, torch.zeros(1, dtype=torch.int32, device=dev)])
    key = torch.where(ok, keysp[rid.clamp(0, cap).long()], 0)
    return rid.to(torch.int32), key.to(torch.int32), overflow


def build(keys: torch.Tensor, valid: torch.Tensor, *, n_buckets: int):
    """Bulk (re)build, of one index or of every shard's. On CUDA tensors
    two kernel launches and no other device op, whatever the number of
    shards (the per-bucket counters are a persistent scratch the kernels
    leave zero). Contract of :func:`build_ref`."""
    if keys.device.type == "cpu":
        return build_ref(keys, valid, n_buckets=n_buckets)
    _build.require_cuda(keys, "hash_build")
    _check_build(keys, valid, n_buckets)
    dev = keys.device
    lead = tuple(keys.shape[:-1])
    nsh = keys.shape[0] if lead else 1
    keys, valid = keys.contiguous(), valid.contiguous()
    rid = torch.empty(lead + (n_buckets, BUCKET_CAP), dtype=torch.int32,
                      device=dev)
    key = torch.empty_like(rid)
    overflow = torch.empty(lead, dtype=torch.int32, device=dev)
    stream = _build.stream_ptr(dev)
    lib = _build.lib("hashidx")
    # the kernels' int32 scratch, in int64 words: "build" is zero when a
    # call starts and the call leaves it so; "build_free" holds nothing
    # from one call to the next
    zeroed, free = (_zeroed_scratch(
        kind, dev, stream,
        lib.hash_build_scratch(n_buckets, nsh, part) // 2 + 1)
        for kind, part in (("build", 1), ("build_free", 0)))
    err = lib.hash_build(
        keys.data_ptr(), valid.data_ptr(), nsh, keys.shape[-1], n_buckets,
        rid.data_ptr(), key.data_ptr(), overflow.data_ptr(),
        zeroed.data_ptr(), free.data_ptr(), stream)
    _build.check(err, "hash_build")
    _build.count_launch("hash_build")
    return rid, key, overflow


# ------------------------------------------------------------------- probe

def _check_probe(rid, key, qkeys, sharded=False):
    nb = rid.shape[-2] if rid.dim() >= 2 else 0
    if (rid.dim() != (3 if sharded else 2) or rid.shape[-1] != BUCKET_CAP
            or rid.dtype != torch.int32):
        raise TypeError("rid must be a [n_buckets, 128] (with sid: "
                        "[S, n_buckets, 128]) int32 tensor")
    if key.shape != rid.shape or key.dtype != torch.int32:
        raise TypeError("key must match rid")
    if nb & (nb - 1) or nb < 2:
        raise ValueError("n_buckets must be a power of two")
    if qkeys.dim() != 1 or qkeys.dtype != torch.int32:
        raise TypeError("qkeys must be a [w] int32 tensor")
    if not (rid.device == key.device == qkeys.device):
        raise ValueError("index and query keys must share a device")


def probe_ref(rid: torch.Tensor, key: torch.Tensor, qkeys: torch.Tensor):
    """Plain version: one bucket row per query key. Returns (cand [w, 128]
    row ids, hit [w, 128] bool: lane occupied AND stored key == query)."""
    _check_probe(rid, key, qkeys)
    b = bucket_of(qkeys, rid.shape[0]).long()
    cand = rid[b]
    hit = (cand != EMPTY) & (key[b] == qkeys[:, None])
    return cand, hit


def probe(rid: torch.Tensor, key: torch.Tensor, qkeys: torch.Tensor):
    """Batched probe (kernel on CUDA tensors): all ``w`` keys in one
    launch. Contract of :func:`probe_ref`."""
    if rid.device.type == "cpu":
        return probe_ref(rid, key, qkeys)
    _build.require_cuda(rid, "hash_probe")
    _check_probe(rid, key, qkeys)
    w = qkeys.shape[0]
    lg = rid.shape[0].bit_length() - 1
    cand = torch.empty((w, BUCKET_CAP), dtype=torch.int32, device=rid.device)
    hit = torch.empty((w, BUCKET_CAP), dtype=torch.bool, device=rid.device)
    if w == 0:
        return cand, hit
    err = _build.lib("hashidx").hash_probe(
        _lanes(rid).data_ptr(), _lanes(key).data_ptr(),
        qkeys.contiguous().data_ptr(), w, lg, cand.data_ptr(), hit.data_ptr(),
        _build.stream_ptr(rid.device))
    _build.check(err, "hash_probe")
    _build.count_launch("hash_probe")
    return cand, hit


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """An index array as the probe kernel reads it: contiguous, starting on
    16 bytes (a bucket row is one 16-byte load a lane)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# residual terms the verified probe takes (core/planner.py MAX_RESIDUAL;
# csrc/hashidx.cu PV_TERMS)
MAX_RESIDUAL = 8


def _check_verify(rid, key, qkeys, valid, keycol, residual, extra_mask,
                  active, limit, sid=None):
    _check_probe(rid, key, qkeys, sid is not None)
    rows = tuple(valid.shape)
    cap = rows[-1] if rows else 0
    w = qkeys.shape[0]
    if sid is None:
        if valid.dim() != 1 or valid.dtype != torch.bool:
            raise TypeError("valid must be a [cap] bool tensor")
    else:
        if (valid.dim() != 2 or valid.shape[0] != rid.shape[0]
                or valid.dtype != torch.bool):
            raise TypeError("valid must be a [S, cap_s] bool tensor")
        if sid.shape != (w,) or sid.dtype != torch.int32:
            raise TypeError("sid must be a [w] int32 tensor")
    if keycol.shape != rows or keycol.dtype != torch.int32:
        raise TypeError("keycol must be an int32 tensor shaped like valid")
    if len(residual) > MAX_RESIDUAL:
        raise ValueError(f"at most {MAX_RESIDUAL} residual terms")
    for col, op, vals in residual:
        if op not in OP_CODES:
            raise ValueError(f"unknown comparison {op!r}")
        if col.shape != rows or col.dtype != torch.int32:
            raise TypeError("a residual column must be an int32 tensor "
                            "shaped like valid")
        if vals.shape != (w,) or vals.dtype != torch.int32:
            raise TypeError("a residual term's values must be [w] int32")
    if extra_mask is not None and (extra_mask.shape != rows
                                   or extra_mask.dtype != torch.bool):
        raise TypeError("extra_mask must be a bool tensor shaped like valid")
    if active is not None and (active.shape != (w,)
                               or active.dtype != torch.bool):
        raise TypeError("active must be a [w] bool tensor")
    if cap < 1 or limit < 0:
        raise ValueError("need cap >= 1 and limit >= 0")
    tensors = [valid, keycol, *(t for c, _, v in residual for t in (c, v))]
    tensors += [t for t in (extra_mask, active, sid) if t is not None]
    if any(t.device != rid.device for t in tensors):
        raise ValueError("the index, the table and the terms must share a "
                         "device")


def probe_verify_ref(rid: torch.Tensor, key: torch.Tensor,
                     qkeys: torch.Tensor, *, valid: torch.Tensor,
                     keycol: torch.Tensor,
                     residual: Sequence[tuple] = (),
                     extra_mask: torch.Tensor | None = None,
                     active: torch.Tensor | None = None, limit: int = 0,
                     sid: torch.Tensor | None = None):
    """Plain version of the verified probe (the reference executors'
    ``_probe_candidates`` + ``_probe_ids`` arithmetic, over ``w`` keys).

    valid [cap] bool and keycol [cap] int32 are the table's validity and
    indexed column; residual holds (column [cap] int32, op, values [w]
    int32) terms; extra_mask [cap] bool and active [w] bool gate the
    matches. Returns (safe [w, 128] int32: the candidates clamped to
    [0, cap); ok [w, 128] bool: hit AND valid AND key equal AND every
    term AND the masks; count [w] int32; ids [w, limit] int32: the first
    ``limit`` matching row ids in row order, 0-padded, or None when limit
    is 0).

    With ``sid`` ([w] int32) the index is ``[S, nb, 128]`` and valid,
    keycol, the residual columns and extra_mask are ``[S, cap]``: query
    ``q`` probes shard ``sid[q]``, and its row ids are the shard's own."""
    _check_verify(rid, key, qkeys, valid, keycol, residual, extra_mask,
                  active, limit, sid)
    cap = valid.shape[-1]
    w = qkeys.shape[0]
    if sid is None:
        cand, hit = probe_ref(rid, key, qkeys)

        def at(t, ix):
            return t[ix]
    else:
        s = sid.long()
        b = bucket_of(qkeys, rid.shape[1]).long()
        cand = rid[s, b]
        hit = (cand != EMPTY) & (key[s, b] == qkeys[:, None])

        def at(t, ix):
            return t[s[:, None], ix]
    safe = cand.clamp(0, cap - 1)
    si = safe.long()
    ok = hit & at(valid, si) & (at(keycol, si) == qkeys[:, None])
    for col, op, vals in residual:
        ok = ok & _CMP[op](at(col, si), vals[:, None])
    if extra_mask is not None:
        ok = ok & at(extra_mask, si)
    if active is not None:
        ok = ok & active[:, None]
    count = ok.sum(dim=1, dtype=torch.int32)
    if limit == 0:
        return safe, ok, count, None
    ordered = torch.sort(torch.where(ok, safe, cap), dim=1).values
    if limit <= BUCKET_CAP:
        ordered = ordered[:, :limit]
    else:
        ordered = torch.cat([ordered, torch.full(
            (w, limit - BUCKET_CAP), cap, dtype=ordered.dtype,
            device=ordered.device)], dim=1)
    present = torch.arange(limit, device=rid.device)[None, :] < count[:, None]
    return safe, ok, count, torch.where(present, ordered, 0).to(torch.int32)


_PTRS = ctypes.c_void_p * MAX_RESIDUAL
_OPS = ctypes.c_int * MAX_RESIDUAL


def probe_verify(rid: torch.Tensor, key: torch.Tensor, qkeys: torch.Tensor,
                 *, valid: torch.Tensor, keycol: torch.Tensor,
                 residual: Sequence[tuple] = (),
                 extra_mask: torch.Tensor | None = None,
                 active: torch.Tensor | None = None, limit: int = 0,
                 sid: torch.Tensor | None = None):
    """The IndexProbe route of ``w`` statements (each on its own shard
    with ``sid``): on CUDA tensors one launch of the probe kernel and no
    other device op. Contract of :func:`probe_verify_ref`."""
    if rid.device.type == "cpu":
        return probe_verify_ref(rid, key, qkeys, valid=valid, keycol=keycol,
                                residual=residual, extra_mask=extra_mask,
                                active=active, limit=limit, sid=sid)
    _build.require_cuda(rid, "hash_probe")
    _check_verify(rid, key, qkeys, valid, keycol, residual, extra_mask,
                  active, limit, sid)
    cap = valid.shape[-1]
    w = qkeys.shape[0]
    dev = rid.device
    safe = torch.empty((w, BUCKET_CAP), dtype=torch.int32, device=dev)
    ok = torch.empty((w, BUCKET_CAP), dtype=torch.bool, device=dev)
    count = torch.empty((w,), dtype=torch.int32, device=dev)
    ids = (torch.empty((w, limit), dtype=torch.int32, device=dev)
           if limit else None)
    if w == 0:
        return safe, ok, count, ids
    residual = [(c.contiguous(), op, v.contiguous()) for c, op, v in residual]
    cols = _PTRS(*(c.data_ptr() for c, _, _ in residual))
    vals = _PTRS(*(v.data_ptr() for _, _, v in residual))
    ops = _OPS(*(OP_CODES[op] for _, op, _ in residual))
    opt = [None if t is None else t.contiguous() for t in (extra_mask, active)]
    err = _build.lib("hashidx").hash_probe_verify(
        _lanes(rid).data_ptr(), _lanes(key).data_ptr(),
        qkeys.contiguous().data_ptr(),
        None if sid is None else sid.contiguous().data_ptr(), w,
        rid.shape[-2].bit_length() - 1,
        valid.contiguous().data_ptr(), keycol.contiguous().data_ptr(), cols,
        vals, ops, len(residual), *(None if t is None else t.data_ptr()
                                    for t in opt),
        cap, limit, safe.data_ptr(), ok.data_ptr(), count.data_ptr(),
        None if ids is None else ids.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "hash_probe")
    _build.count_launch("hash_probe")
    return safe, ok, count, ids


# ------------------------------------------------- incremental maintenance

def insert_update_batched(idx: dict, slots: torch.Tensor,
                          old_keys: torch.Tensor, new_keys: torch.Tensor,
                          row_mask: torch.Tensor, valid: torch.Tensor) -> dict:
    """Re-home a batch of inserted slots in a fixed number of parallel
    passes (``repro.kernels.hashidx.insert_update_batched``): clear every
    entry holding an inserted slot, then give the member of arrival rank
    ``r`` within its bucket the (r+1)-th free lane. A member that finds no
    free lane marks the index stale. Returns a new index dict."""
    rid0, key0 = idx["rid"], idx["key"]
    nb, cap_b = rid0.shape
    n = slots.shape[0]
    cap = valid.shape[0]
    dev = rid0.device
    del old_keys  # the clear sweep finds entries by row id, not bucket
    act = row_mask.to(torch.bool)
    slots = slots.to(torch.int64)
    nbk = bucket_of(new_keys.to(torch.int32), nb).long()
    validp = torch.cat([valid, torch.zeros(1, dtype=torch.bool, device=dev)])

    # 1. clear: masked members mark the scratch entry cap + 1
    inserted = torch.zeros(cap + 2, dtype=torch.bool, device=dev)
    inserted[torch.where(act, slots, cap + 1)] = torch.ones(
        (n,), dtype=torch.bool, device=dev)  # a device value: no sync
    inserted = inserted[: cap + 1]
    rid0 = torch.where((rid0 != EMPTY) & inserted[rid0.clamp(0, cap).long()],
                       EMPTY, rid0)

    # 2. place: within-bucket arrival rank -> the (rank+1)-th free lane
    b = torch.where(act, nbk, nb)
    sb, order = torch.sort(b, stable=True)
    rank_sorted = torch.arange(n, device=dev) - torch.searchsorted(
        sb, sb, side="left")
    rank = torch.zeros(n, dtype=torch.int64, device=dev).scatter(
        0, order, rank_sorted)
    rows = rid0[nbk]                                        # [n, cap_b]
    free = (rows == EMPTY) | ~validp[rows.clamp(0, cap).long()]
    cumfree = torch.cumsum(free.to(torch.int32), dim=1)
    want = rank + 1
    found = cumfree[:, -1] >= want
    lane = torch.argmax((cumfree == want[:, None]).to(torch.uint8), dim=1)
    place = act & found
    bi = torch.where(place, nbk, nb)          # bucket nb is a scratch row
    rid = torch.cat([rid0, torch.empty((1, cap_b), dtype=torch.int32,
                                       device=dev)])
    key = torch.cat([key0, torch.empty((1, cap_b), dtype=torch.int32,
                                       device=dev)])
    rid[bi, lane] = slots.to(torch.int32)
    key[bi, lane] = new_keys.to(torch.int32)
    stale = idx["stale"] + (act & ~found).sum(dtype=torch.int32)
    return {"rid": rid[:nb].contiguous(), "key": key[:nb].contiguous(),
            "stale": stale}
