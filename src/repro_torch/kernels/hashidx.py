"""Device-resident bucketed hash index over an int32 key column: bulk
build, batched probe and incremental insert maintenance.

Index layout (one per indexed column, inside the table state), as in
``repro.kernels.hashidx``:

    rid  [n_buckets, BUCKET_CAP] int32   row ids, ``EMPTY`` (-1) = free lane
    key  [n_buckets, BUCKET_CAP] int32   the key stored at insert time
    stale [] int32                       > 0: the index may miss rows and
                                         every probe takes the scan path

Two kernels, in ``csrc/hashidx.cu``, each with its plain PyTorch version
beside it: ``build`` (after a stable sort that groups rows by bucket) and
``probe`` (one bucket row per query key). A wrapper serves a CPU tensor
with the plain version and a CUDA tensor with its kernel.
``insert_update_batched`` is plain PyTorch on every device (it was no
Pallas kernel in the reference either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

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


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Multiplicative hash -> bucket id: the top ``lg`` bits of the 32-bit
    product ``uint32(key) * _PRIME``. Computed in int64 from two 16-bit
    halves of the multiplier, so no product leaves the int64 range and
    negative keys wrap exactly as the uint32 cast does."""
    lg = n_buckets.bit_length() - 1
    k = keys.to(torch.int64) & 0xFFFFFFFF
    prod = (k * _PRIME_LO + (((k * _PRIME_HI) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (prod >> (32 - lg)).to(torch.int32)


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
    """Build prologue: one stable sort groups row ids by bucket (invalid
    rows last under sentinel ``n_buckets``). Returns (order, sb, start,
    overflow) as ``repro.kernels.hashidx._build_sorted``: the sort must be
    stable, or lane layouts differ from the reference."""
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


def _check_build(keys, valid):
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise TypeError("keys must be a [cap] int32 tensor")
    if valid.shape != keys.shape or valid.dtype != torch.bool:
        raise TypeError("valid must be a [cap] bool tensor")
    if valid.device != keys.device:
        raise ValueError("keys and valid must share a device")


def build_ref(keys: torch.Tensor, valid: torch.Tensor, *, n_buckets: int):
    """Plain version: gather each bucket's sorted segment. Returns
    (rid [nb, 128], key [nb, 128], overflow [] int32)."""
    _check_build(keys, valid)
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
    """Bulk (re)build (kernel on CUDA tensors). Contract of
    :func:`build_ref`."""
    if keys.device.type == "cpu":
        return build_ref(keys, valid, n_buckets=n_buckets)
    _build.require_cuda(keys, "hash_build")
    _check_build(keys, valid)
    cap = keys.shape[0]
    order, sb, start, overflow = _build_sorted(keys, valid, n_buckets)
    keys = keys.contiguous()
    rid = torch.empty((n_buckets, BUCKET_CAP), dtype=torch.int32,
                      device=keys.device)
    key = torch.empty_like(rid)
    err = _build.lib("hashidx").hash_build(
        order.contiguous().data_ptr(), sb.data_ptr(),
        start.contiguous().data_ptr(), keys.data_ptr(), cap, n_buckets,
        rid.data_ptr(), key.data_ptr(), _build.stream_ptr(keys.device))
    _build.check(err, "hash_build")
    _build.launches["hash_build"] += 1
    return rid, key, overflow


# ------------------------------------------------------------------- probe

def _check_probe(rid, key, qkeys):
    nb = rid.shape[0]
    if rid.dim() != 2 or rid.shape[1] != BUCKET_CAP or rid.dtype != torch.int32:
        raise TypeError("rid must be a [n_buckets, 128] int32 tensor")
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
    err = _build.lib("hashidx").hash_probe(
        rid.contiguous().data_ptr(), key.contiguous().data_ptr(),
        qkeys.contiguous().data_ptr(), w, lg, cand.data_ptr(), hit.data_ptr(),
        _build.stream_ptr(rid.device))
    _build.check(err, "hash_probe")
    _build.launches["hash_probe"] += 1
    return cand, hit


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
