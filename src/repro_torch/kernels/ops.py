"""The fused-scan entry point the table executors call (counterpart of
``repro.kernels.ops.predicate_scan``) and the partition split of sharded
tables (``shard_split``). There is no mode switch: the relscan wrappers
take their plain version for a CPU tensor and launch their CUDA kernel
for a CUDA tensor (``kernels/_build.py``). The hash index kernels are
called straight from ``kernels/hashidx.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import relscan as _relscan


def predicate_scan(cols, valid, vals, *, ops, limit, want_ids=True):
    """Fused WHERE scan + compaction for a conjunction of up to 4
    equality/range terms over int32 columns.

    ``vals`` is [nterms] (one statement: outputs carry no batch axis, the
    reference contract) or [w, nterms] (w statements in one launch:
    outputs lead with w). Returns (ids, present, mask, count); see
    :func:`repro_torch.kernels.relscan.relscan`."""
    single = vals.dim() == 1
    ids, present, mask, count = _relscan.relscan(
        cols, valid, vals[None] if single else vals, ops=tuple(ops),
        limit=limit, want_ids=want_ids)
    if not single:
        return ids, present, mask, count
    return (None if ids is None else ids[0],
            None if present is None else present[0], mask[0], count[0])


def shard_split(shard_ids: torch.Tensor, n_shards: int, row_mask=None):
    """Device-side partition split (``repro.kernels.ops.shard_split``,
    plain tensor code there too): one stable sort routes a [b]-row batch
    to its shards. The sharded INSERT splits a statement batch by the
    partition hash with it, and RESHARD re-splits every live row.

    shard_ids: [b] int32 target shard per row; row_mask: [b] bool (None =
    all rows live). Returns (rows [n_shards, b] int32, mask [n_shards, b]
    bool): ``rows[s]`` are batch indices (clamped), ``mask[s]`` marks
    which of them belong to shard ``s``, in batch order."""
    b = shard_ids.shape[0]
    dev = shard_ids.device
    sid = shard_ids.to(torch.int32)
    if row_mask is not None:
        sid = torch.where(row_mask, sid, n_shards)  # masked rows -> sentinel
    ssid, order = torch.sort(sid, stable=True)
    shards = torch.arange(n_shards, dtype=torch.int32, device=dev)
    start = torch.searchsorted(ssid, shards).to(torch.int64)
    pos = start[:, None] + torch.arange(b, device=dev)[None, :]
    posc = pos.clamp(0, max(b - 1, 0))
    rows = order[posc].to(torch.int32)
    mask = (ssid[posc] == shards[:, None]) & (pos < b)
    return rows, mask
