"""KV-block pool: the paper's cache table specialized for transformer KV
(port of ``repro.core.kvpool``).

One row of the ``kv`` table is one block of ``block_size`` token
positions of one sequence across every layer; its columns (slot, seq_id,
user_id, pos_block, prefix_hash) are the queryable metadata, its payload
the block's K/V, and the fine-grained expiry of the paper's Table 2 is
plain SQL against them (``delete_seq`` / ``delete_user`` here run the
same WHERE through the table executors)::

    DELETE FROM kv WHERE seq_id = ?     -- finish one request   (~"one page")
    DELETE FROM kv WHERE user_id = ?    -- end one user session (~"one user")
    FLUSH kv                            -- the memcached way

The page table maps (slot, pos_block) to the row id holding that block
(``capacity`` = missing), and the length vector counts each slot's cached
tokens. Both are maintained incrementally from the row ids an INSERT or a
DELETE reports, and rebuilt from the columns otherwise. Where the
reference branches on device with ``lax.cond`` (an insert that evicted
live rows forces a rebuild), both results are computed and one is
selected with ``torch.where``: no host sync. The reference's dropped
scatters (``mode="drop"``) land in a scratch entry past the end that is
sliced off.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import predicate as P
from repro_torch.core import table as T
from repro_torch.core.daemon import resolve_device
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


def init_pool(schema: TableSchema, device=None) -> dict:
    """An empty pool on ``device`` (None: the card)."""
    return T.init_state(schema, resolve_device(device))


def append_blocks(schema: TableSchema, state: dict, *, slot, seq_id,
                  user_id, pos_block, prefix_hash, kv, row_mask=None,
                  ttl=0):
    """Insert ``n`` KV blocks (each column [n], ``kv`` [n, layers, 2,
    block, kv_heads, head_dim]); returns (state, rows, evicted)."""
    values = {"slot": slot, "seq_id": seq_id, "user_id": user_id,
              "pos_block": pos_block, "prefix_hash": prefix_hash}
    return T.insert(schema, state, values, {"kv": kv}, row_mask, ttl)


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


def _add_per_slot(lengths: torch.Tensor, slot: torch.Tensor, ok, delta,
                  max_slots: int) -> torch.Tensor:
    """``lengths`` plus ``delta`` for each ``ok`` entry of ``slot`` (the
    others go to a scratch entry that is sliced off)."""
    s = torch.where(ok, slot, max_slots).long()
    padded = torch.cat([lengths, lengths.new_zeros((1,))])
    return padded.index_add(0, s, ok.to(lengths.dtype) * delta)[:max_slots]


def seq_lengths(schema: TableSchema, state: dict, *, max_slots: int,
                block_size: int) -> torch.Tensor:
    """Per-slot cached length in tokens = (#blocks) * block_size."""
    slot = state["cols"]["slot"]
    ok = state["valid"] & (slot >= 0) & (slot < max_slots)
    zeros = torch.zeros((max_slots,), dtype=torch.int32, device=slot.device)
    return _add_per_slot(zeros, slot, ok, block_size, max_slots)


def _on_state_device(state: dict, *arrs):
    """``arrs`` on the device of ``state``'s tensors (a pruned statement's
    row-id handles live on its lane's device, a flattened sharded state on
    the home device); tensors already there pass through. The copies are
    device to device and do not wait for the card). Nothing places a kv
    table yet, so it passes everything through until the mesh serve step
    does (ROADMAP Queue 1 item 5)."""
    dev = state["valid"].device
    return tuple(a.to(dev, non_blocking=True)
                 if isinstance(a, torch.Tensor) and a.device != dev else a
                 for a in arrs)


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
    pt, row_ids, evicted = _on_state_device(state, pt, row_ids, evicted)
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
    pt, row_ids, present = _on_state_device(state, pt, row_ids, present)
    s, b = _pt_coords(state, row_ids, present, max_slots=max_slots,
                      max_blocks=max_blocks)
    return _scatter_pt(pt, s, b, schema.capacity, max_slots)


def seq_lengths_insert(
    schema: TableSchema, state: dict, lengths: torch.Tensor,
    row_ids: torch.Tensor, evicted: torch.Tensor, *, block_size: int,
    max_slots: int,
) -> torch.Tensor:
    """Length vector after inserting ``row_ids``: O(k) adds, or the full
    recount when the insert evicted live rows (both computed, one picked
    on the device, as :func:`page_table_insert` does)."""
    lengths, row_ids, evicted = _on_state_device(state, lengths, row_ids,
                                                 evicted)
    slot = state["cols"]["slot"][row_ids.long()]
    ok = (slot >= 0) & (slot < max_slots)
    inc = _add_per_slot(lengths, slot, ok, block_size, max_slots)
    rebuild = seq_lengths(schema, state, max_slots=max_slots,
                          block_size=block_size)
    return torch.where(evicted > 0, rebuild, inc)


def seq_lengths_delete(
    schema: TableSchema, state: dict, lengths: torch.Tensor,
    row_ids: torch.Tensor, present: torch.Tensor, *, block_size: int,
    max_slots: int,
) -> torch.Tensor:
    """Length vector after a DELETE that reported its row ids (``present``
    masks the padded tail)."""
    lengths, row_ids, present = _on_state_device(state, lengths, row_ids,
                                                 present)
    slot = state["cols"]["slot"][row_ids.long()]
    ok = present & (slot >= 0) & (slot < max_slots)
    return _add_per_slot(lengths, slot, ok, -block_size, max_slots)


def gather_blocks(state: dict, pages: torch.Tensor) -> torch.Tensor:
    """KV payloads through a page table. pages: [slots, blocks] row ids
    (the sentinel ``capacity`` gives zeros). Returns [slots, blocks,
    layers, 2, block, kv_heads, head_dim]."""
    pool = state["payloads"]["kv"]
    cap = pool.shape[0]
    out = pool[torch.clamp(pages, max=cap - 1).long()]
    keep = (pages < cap).reshape(pages.shape + (1,) * (pool.dim() - 1))
    return torch.where(keep, out, torch.zeros((), dtype=pool.dtype,
                                              device=pool.device))


def _eq(column: str) -> P.Node:
    return P.BinOp("=", P.Col(column), P.Param(0))


def delete_seq(schema: TableSchema, state: dict, seq_id):
    """Fine-grained expiry: one request's blocks (the paper's 'single
    page'). Returns (state, n)."""
    return T.delete(schema, state, _eq("seq_id"), (seq_id,))


def delete_user(schema: TableSchema, state: dict, user_id):
    """Fine-grained expiry: one user's sessions (the paper's 'single
    user'). Returns (state, n)."""
    return T.delete(schema, state, _eq("user_id"), (user_id,))


def find_prefix(schema: TableSchema, state: dict, prefix_hash, *,
                limit: int = 64):
    """Prefix-cache lookup: every block whose prefix hash matches. Returns
    (state, result) with the row ids and the pos_block and seq_id
    columns."""
    return T.select(schema, state, _eq("prefix_hash"), (prefix_hash,),
                    columns=("pos_block", "seq_id"), limit=limit)


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
