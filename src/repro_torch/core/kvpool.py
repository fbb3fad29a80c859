"""KV-block pool metadata: the paper's cache table specialized for
transformer KV (port of ``repro.core.kvpool``, the parts the serving
engine uses).

One row of the ``kv`` table is one block of ``block_size`` token
positions of one sequence; its columns (slot, seq_id, user_id, pos_block,
prefix_hash) are the queryable metadata, and the fine-grained expiry of
the paper's Table 2 is plain SQL against them::

    DELETE FROM kv WHERE seq_id = ?     -- finish one request   (~"one page")
    DELETE FROM kv WHERE user_id = ?    -- end one user session (~"one user")
    FLUSH kv                            -- the memcached way

The page table maps (slot, pos_block) to the row id holding that block
(``capacity`` = missing). It is maintained incrementally from the row ids
an INSERT reports, and rebuilt from the columns after a DELETE whose row
ids were not reported. Where the reference branches on device with
``lax.cond`` (an insert that evicted live rows forces a rebuild), both
results are computed and one is selected with ``torch.where``: no host
sync. The reference's dropped scatters (``mode="drop"``) land in a
scratch row past the end that is sliced off.

Not in this port yet: ``init_pool`` / ``append_blocks`` / ``gather_blocks``,
the per-slot length vector, ``delete_seq`` / ``delete_user`` (the engine
issues the SQL itself) and ``find_prefix``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.schema import ExpiryPolicy, TableSchema, make_schema

KV_COLUMNS = (
    ("slot", "INT"),
    ("seq_id", "INT"),
    ("user_id", "INT"),
    ("pos_block", "INT"),
    ("prefix_hash", "INT"),
)

_HASH_SEED = 2166136261
_HASH_MUL = 1000003
_U32 = 0xFFFFFFFF


def kv_schema(
    *,
    layers: int,
    block_size: int,
    kv_heads: int,
    head_dim: int,
    capacity: int,
    dtype: Any = torch.bfloat16,
    name: str = "kv",
    expiry: ExpiryPolicy = ExpiryPolicy(),
    max_select: int = 256,
    indexes: tuple[str, ...] = (),
) -> TableSchema:
    """The pool table with its KV payload
    ``[layers, 2, block, kv_heads, head_dim]`` a row; ``indexes`` puts a
    hash index on the named columns."""
    payload = ("kv", (layers, 2, block_size, kv_heads, head_dim), dtype)
    return make_schema(
        name, list(KV_COLUMNS), [payload],
        capacity=capacity, max_select=max_select, expiry=expiry,
        indexes=indexes,
    )


def _scatter_pt(pt: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                vals, max_slots: int) -> torch.Tensor:
    """``pt`` with ``pt[s, b] = vals``; entries with ``s == max_slots``
    go to a scratch row that is sliced off (the reference drops them)."""
    ext = torch.cat([pt, pt.new_zeros((1, pt.shape[1]))])
    if not isinstance(vals, torch.Tensor):
        # a fill kernel: a host scalar copied over would sync
        vals = torch.full(s.shape, vals, dtype=pt.dtype, device=pt.device)
    ext[s.long(), b.long()] = vals.to(pt.dtype)
    return ext[:max_slots]


def page_table(schema: TableSchema, state: dict, *, max_slots: int,
               max_blocks: int) -> torch.Tensor:
    """Materialize the [max_slots, max_blocks] int32 page table of pool
    row ids from the columns: entry (s, b) = row of the valid block with
    slot == s, pos_block == b; missing entries hold ``capacity``. One
    O(capacity) scatter."""
    cap = schema.capacity
    slot = state["cols"]["slot"]
    pos = state["cols"]["pos_block"]
    valid = state["valid"]
    in_range = (valid & (slot >= 0) & (slot < max_slots) & (pos >= 0)
                & (pos < max_blocks))
    s = torch.where(in_range, slot, max_slots)
    b = torch.where(in_range, pos, 0)
    pt = torch.full((max_slots, max_blocks), cap, dtype=torch.int32,
                    device=valid.device)
    rows = torch.arange(cap, dtype=torch.int32, device=valid.device)
    return _scatter_pt(pt, s, b, rows, max_slots)


def _pt_coords(state: dict, row_ids, ok, *, max_slots: int, max_blocks: int):
    row_ids = row_ids.long()
    slot = state["cols"]["slot"][row_ids]
    pos = state["cols"]["pos_block"][row_ids]
    ok = (ok & (slot >= 0) & (slot < max_slots) & (pos >= 0)
          & (pos < max_blocks))
    return torch.where(ok, slot, max_slots), torch.where(ok, pos, 0)


def page_table_insert(
    schema: TableSchema, state: dict, pt: torch.Tensor,
    row_ids: torch.Tensor, evicted: torch.Tensor, *, max_slots: int,
    max_blocks: int,
) -> torch.Tensor:
    """Page table after inserting ``row_ids`` (the slots the INSERT
    returned): an O(k) scatter of the new (slot, pos_block) entries.

    ``evicted`` is the insert's eviction count (a device scalar). When the
    allocator evicted live rows their old coordinates are gone from the
    state, so the full rebuild is the answer; both are computed and
    ``torch.where`` picks one on the device (the reference's ``lax.cond``)."""
    ok = torch.ones(row_ids.shape, dtype=torch.bool, device=pt.device)
    s, b = _pt_coords(state, row_ids, ok, max_slots=max_slots,
                      max_blocks=max_blocks)
    inc = _scatter_pt(pt, s, b, row_ids.to(torch.int32), max_slots)
    rebuild = page_table(schema, state, max_slots=max_slots,
                         max_blocks=max_blocks)
    return torch.where(evicted > 0, rebuild, inc)


def page_table_delete(
    schema: TableSchema, state: dict, pt: torch.Tensor,
    row_ids: torch.Tensor, present: torch.Tensor, *, max_slots: int,
    max_blocks: int,
) -> torch.Tensor:
    """Page table after a DELETE that reported its row ids: clear their
    entries (``present`` masks the padded tail). DELETE only flips
    validity bits, so the rows' coordinates are still readable."""
    s, b = _pt_coords(state, row_ids, present, max_slots=max_slots,
                      max_blocks=max_blocks)
    return _scatter_pt(pt, s, b, schema.capacity, max_slots)


def rolling_prefix_hashes(tokens: torch.Tensor,
                          block_size: int) -> torch.Tensor:
    """Deterministic rolling hash at every block boundary.

    tokens: [seq] int -> [seq // block_size] int32. The reference folds
    ``h = h * 1000003 + t + 1`` in uint32 from 2166136261 and keeps the low
    31 bits of ``h`` at each block end; here the fold runs in int64, masked
    to 32 bits at every step (tokens as their uint32 bit patterns)."""
    nblk = tokens.shape[0] // block_size
    tok = tokens[: nblk * block_size].long() & _U32
    h = torch.full((), _HASH_SEED, dtype=torch.int64, device=tokens.device)
    out = []
    for i in range(nblk * block_size):
        h = (h * _HASH_MUL + tok[i] + 1) & _U32
        if (i + 1) % block_size == 0:
            out.append(h)
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=tokens.device)
    return (torch.stack(out) & 0x7FFFFFFF).to(torch.int32)
