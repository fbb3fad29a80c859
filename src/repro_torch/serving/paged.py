"""Paged attention over the KV arena: the SQLcached technique on the
decode hot path (port of ``repro.serving.paged``, single device).

The arena is the KV pool's payload in layer-major layout
``[L_attn, cap + 1, 2, block, kv_heads, head_dim]``; its rows are tracked
by the relational metadata table (``core/kvpool.py``). Row ``cap`` is a
scratch row that no page table names: the writes of slots without a
request land there (the reference drops them with ``mode="drop"``).

The island is one decode attention for every slot: write the new token's
K/V into its block row, then attend to the pool through the page table
with the paged-attention kernel (``kernels/paged_attention.py``). The
reference adds the new token as a separate self term of its online
softmax; here the token is written first and the kernel sees one more
position (``lengths + 1``) and, with a window, one more window position
(``window + 1``), which is the same set: the ``window - 1`` pool tokens
before the new one plus itself. The arena is updated in place (the
reference's jitted step donates it).

The int8 arena (``quant=True``) keeps the reference's order instead: the
kernel reads the int8 pool (dequantized with its per-token-slot scales)
and takes the new token as a separate, unquantized self term, so the
token's own quantization error never enters its step; then the token is
quantized with its own scale (:func:`quantize_kv`) and written.

Not in this port yet: a device mesh (sharded slots, heads or striped
blocks) raises :class:`~repro_torch.models.config.NotPorted`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.config import NotPorted


@dataclasses.dataclass(frozen=True)
class PagedGeom:
    """Geometry of one paged-KV deployment on one device (the reference's
    sharding plan has no counterpart here)."""

    block: int                    # tokens per block
    nblk: int                     # max blocks per sequence
    batch: int                    # slots
    kv_heads: int
    head_dim: int
    q_heads: int

    @property
    def cap(self) -> int:
        """Row capacity = slots x blocks (the live engine over-provisions
        by its expiry slack)."""
        return self.batch * self.nblk


def plan_geometry(*, batch: int, seq_len: int, kv_heads: int, head_dim: int,
                  q_heads: int, mesh=None, block: int = 256) -> PagedGeom:
    if mesh is not None:
        raise NotPorted("a device mesh for the paged island")
    return PagedGeom(block, -(-seq_len // block), batch, kv_heads, head_dim,
                     q_heads)


def build_blk_start(geom: PagedGeom) -> np.ndarray:
    """Start position of pt[b, 0, j] = j * block ([batch, 1, nblk])."""
    per = np.arange(geom.nblk)[None, None, :] * geom.block
    return np.broadcast_to(per, (geom.batch, 1, geom.nblk)).astype(np.int32)


def quantize_kv(kv: torch.Tensor):
    """Per-token int8 quantization over the last axis (the reference's
    write-time rule): ``scale = max(amax, 1e-8) / 127`` in fp32, values
    rounded half to even and clipped to +-127. Returns (int8 values,
    fp32 scales without the last axis)."""
    kv = kv.float()
    sc = torch.clamp(kv.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.round(kv / sc[..., None]).clamp(-127, 127).to(torch.int8)
    return q, sc


def make_paged_island(geom: PagedGeom, mesh=None, *, scale: float,
                      softcap: float = 0.0, window: int = 0,
                      quant: bool = False):
    """Returns island(q, k_new, v_new, arena_l, pt, blk_start, lengths,
    write_rows, write_off[, scale_l]) -> (attn_out, arena_l[, scale_l]).

    q [b, h, hd]; k_new/v_new [b, kh, hd]; arena_l [cap + 1, 2, block, kh,
    hd] (row ``cap`` scratch, written in place); pt [b, 1, nblk] pool rows
    (-1 missing); blk_start [b, 1, nblk] (``build_blk_start``: block j
    starts at j * block, the only layout without a mesh); lengths [b]
    tokens in the pool; write_rows [b, 1] the new token's block row (-1:
    the slot has no request, attends to nothing and gives 0);
    write_off [b] its offset in the block. ``quant=True``: the arena is
    int8 and ``scale_l`` [cap + 1, 2, block, kh] fp32 its scales, both
    written in place."""
    if mesh is not None:
        raise NotPorted("a device mesh for the paged island")
    if quant:
        def island_q(q, k_new, v_new, arena_l, pt, blk_start, lengths,
                     write_rows, write_off, scale_l):
            del blk_start  # positions are j * block without a mesh
            b = q.shape[0]
            cap = arena_l.shape[0] - 1
            own = write_rows.reshape(b) >= 0
            out = paged_attention(
                q, arena_l[:cap], pt.reshape(b, -1).to(torch.int32),
                torch.where(own, lengths, -1).to(torch.int32), scale=scale,
                softcap=softcap, window=window, scales=scale_l[:cap],
                kv_self=(k_new, v_new))
            tgt = torch.where(own, write_rows.reshape(b), cap).long()
            qv, sc = quantize_kv(torch.stack([k_new, v_new], dim=1))
            off = write_off.long()
            arena_l[tgt, :, off] = qv
            scale_l[tgt, :, off] = sc
            return out, arena_l, scale_l

        return island_q
    kwin = window + 1 if window and window > 0 else 0

    def island(q, k_new, v_new, arena_l, pt, blk_start, lengths,
               write_rows, write_off):
        del blk_start  # positions are j * block without a mesh
        b = q.shape[0]
        cap = arena_l.shape[0] - 1
        own = write_rows.reshape(b) >= 0
        tgt = torch.where(own, write_rows.reshape(b), cap).long()
        kv = torch.stack([k_new, v_new], dim=1).to(arena_l.dtype)
        arena_l[tgt, :, write_off.long()] = kv
        visible = torch.where(own, lengths + 1, 0).to(torch.int32)
        out = paged_attention(q, arena_l[:cap], pt.reshape(b, -1).to(
            torch.int32), visible, scale=scale, softcap=softcap,
            window=kwin)
        return out, arena_l

    return island
