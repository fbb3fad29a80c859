"""Paged attention over the KV arena: the SQLcached technique on the
decode hot path, distributed (port of ``repro.serving.paged``).

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

**Over a device mesh** (``launch/mesh.Mesh``, the reference's placement,
paper §3: "deployed on more than one server to create a load-balancing
setup"), :func:`plan_geometry` places

- slots on the batch axes ('pod', 'data') where the batch divides them;
- KV heads on 'model' where both head counts divide it (case A), else the
  sequence's blocks STRIPED over 'model' (case B, flash-decoding style:
  block ``j`` lives on stripe ``j % stripe_total`` at local index ``j //
  stripe_total``);
- and, where the batch cannot cover the data axes, blocks striped over
  those too: the cache itself is the parallel resource.

Each mesh coordinate holds its slots', heads' and stripe's share of every
arena as one tensor on its own device (``[L, cap_local + 1, 2, block,
kh_local, hd]``, a scratch row last: a :class:`Shards`, built from a
global arena by :func:`split_arena`, joined back by :func:`join_arena`).
The island takes each coordinate's own q / k_new / v_new (:class:`Shards`
of its slots and of the heads :func:`coordinates` gives it; the serve
step over placed weights, ``serving/engine.make_serve_step``, cuts or
gathers them from the heads its weights made, and :func:`scatter_heads`
cuts them from global tensors) and runs the kernel once a coordinate on
that coordinate's device, over its stripe's pages at their global start
positions (the kernel's ``blk_start``). Without stripes each
coordinate's output is its slots' and heads' final output, and no
collective runs. With stripes the kernel also returns each row's
log-sum-exp, and the partials are combined with the reference's
collectives over the stripe axes (``parallel/collectives.py``): a
``pmax`` of the lse values, each partial rescaled by ``exp(lse - max)``,
and two ``psum`` calls (the weighted partials and the weights), whose
quotient every coordinate gets. A stripe that sees nothing gives 0 and
lse -1e30, which weighs 0 (no ``inf - inf``). :func:`gather_heads` joins
the output back to a global tensor.

Only the owner stripe writes the new token: the one whose
``write_rows[b, stripe] >= 0`` (the reference's ``own``). With the bf16
arena every stripe of a slot with a request (any stripe's ``write_rows``
>= 0) then attends over ``lengths + 1`` positions (and ``window + 1``):
the token lies in the owner's pages only, and each coordinate writes
before it attends, so the trick above holds stripe by stripe. With the
int8 arena the unquantized self term must enter once: stripe 0's kernel
adds it (``kv_self``) for every slot with a request, and the other
stripes' kernels do not. The combine is a weighted sum over the stripes,
so which stripe carries the term does not matter (the reference adds it
on the owner). Where stripe 0 sees no pool position, its kernel returns
the new token's value with the self score as its lse. The quantized
token is written after the kernels have read the pool. A slot without a
request (``write_rows`` -1 on every stripe) attends to nothing and gives
0, as without a mesh.

One process drives every coordinate; on one card the mesh repeats
``cuda:0`` and the placement code runs in full.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.launch.mesh import check_mesh
from repro_torch.parallel.collectives import Shards, pmax, psum
from repro_torch.parallel.sharding import spec_entry


@dataclasses.dataclass(frozen=True)
class PagedGeom:
    """Geometry and sharding plan of one paged-KV deployment (without a
    mesh every axis group is empty: one device)."""

    block: int                    # tokens per block
    nblk: int                     # max blocks per sequence
    batch: int                    # global slots
    kv_heads: int
    head_dim: int
    q_heads: int
    batch_axes: tuple = ()        # mesh axes sharding the slot dim
    head_axes: tuple = ()         # mesh axes sharding kv heads (case A)
    stripe_axes: tuple = ()       # mesh axes striping pos_blocks (case B)
    mesh_shape: dict = dataclasses.field(default_factory=dict)

    def _size(self, axes) -> int:
        return math.prod(self.mesh_shape[a] for a in axes)

    @property
    def stripe_total(self) -> int:
        return self._size(self.stripe_axes)

    @property
    def batch_shards(self) -> int:
        return self._size(self.batch_axes)

    @property
    def head_shards(self) -> int:
        return self._size(self.head_axes)

    @property
    def batch_local(self) -> int:
        return self.batch // self.batch_shards

    @property
    def nblk_local(self) -> int:
        return self.nblk // self.stripe_total

    @property
    def cap(self) -> int:
        """Global row capacity = slots x blocks (the live engine
        over-provisions by its expiry slack)."""
        return self.batch * self.nblk

    @property
    def cap_local(self) -> int:
        """Rows of one coordinate's arena shard (its scratch row aside)."""
        return self.cap // (self.batch_shards * self.stripe_total)

    @property
    def kv_heads_local(self) -> int:
        return self.kv_heads // self.head_shards

    @property
    def manual_axes(self) -> frozenset:
        return frozenset(self.batch_axes + self.head_axes + self.stripe_axes)

    # ------------------------------------ global specs (the reference's,
    # as tuples: parallel/sharding.py)
    def arena_spec(self) -> tuple:
        cap_ax = spec_entry(self.batch_axes + self.stripe_axes)
        return (None, cap_ax, None, None, spec_entry(self.head_axes), None)

    def arena_slice_spec(self) -> tuple:
        """One layer's slice [cap, 2, block, kh, hd]."""
        return self.arena_spec()[1:]

    def pt_spec(self) -> tuple:
        return (spec_entry(self.batch_axes), spec_entry(self.stripe_axes),
                None)

    def vec_spec(self) -> tuple:  # lengths / tokens [batch]
        return (spec_entry(self.batch_axes),)

    def wrows_spec(self) -> tuple:  # write_rows [batch, stripe_total]
        return (spec_entry(self.batch_axes), spec_entry(self.stripe_axes))

    def q_spec(self) -> tuple:  # q/k_new/v_new [batch, heads, hd]
        return (spec_entry(self.batch_axes), spec_entry(self.head_axes),
                None)


def plan_geometry(*, batch: int, seq_len: int, kv_heads: int, head_dim: int,
                  q_heads: int, mesh=None, block: int = 256) -> PagedGeom:
    """The reference's plan: slots over the batch axes where they divide,
    KV heads over 'model' where both head counts divide it, else blocks
    striped over 'model' (and over the batch axes too where the batch
    does not cover them)."""
    check_mesh(mesh)
    nblk = -(-seq_len // block)
    if mesh is None:
        return PagedGeom(block, nblk, batch, kv_heads, head_dim, q_heads)
    names = tuple(mesh.axis_names)
    shape = {a: int(n) for a, n in mesh.shape.items()}
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_size = math.prod(shape[a] for a in dp)
    batch_axes = dp if dp and batch % dp_size == 0 else ()
    stripe_axes: tuple = ()
    head_axes: tuple = ()
    if "model" in names:
        m = shape["model"]
        if kv_heads % m == 0 and q_heads % m == 0:
            head_axes = ("model",)
        else:
            stripe_axes = ("model",)
    if not batch_axes and dp:
        stripe_axes = dp + stripe_axes  # batch too small: stripe the cache
    geom = PagedGeom(block, nblk, batch, kv_heads, head_dim, q_heads,
                     batch_axes, head_axes, stripe_axes, shape)
    assert geom.nblk % geom.stripe_total == 0, (geom.nblk, geom.stripe_total)
    return geom


def build_blk_start(geom: PagedGeom) -> np.ndarray:
    """Global start position of pt[b, stripe, j] = (j * stripe_total +
    stripe) * block ([batch, stripe_total, nblk_local]: the engine's
    static striping order; without a mesh j * block)."""
    st = geom.stripe_total
    j = np.arange(geom.nblk_local)[None, :]
    s = np.arange(st)[:, None]
    per = (j * st + s) * geom.block
    return np.broadcast_to(per[None], (geom.batch, st, geom.nblk_local)
                           ).astype(np.int32)


def stripe_of_block(geom: PagedGeom, pos_block: int) -> int:
    return pos_block % geom.stripe_total


def local_index_of_block(geom: PagedGeom, pos_block: int) -> int:
    return pos_block // geom.stripe_total


def quantize_kv(kv: torch.Tensor):
    """Per-token int8 quantization over the last axis (the reference's
    write-time rule): ``scale = max(amax, 1e-8) / 127`` in fp32, values
    rounded half to even and clipped to +-127. Returns (int8 values,
    fp32 scales without the last axis)."""
    kv = kv.float()
    sc = torch.clamp(kv.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.round(kv / sc[..., None]).clamp(-127, 127).to(torch.int8)
    return q, sc


# ------------------------------------------------------ mesh coordinates
@dataclasses.dataclass
class Coord:
    """Where one mesh coordinate's work lies: its index, device, stripe,
    and its slice of the slots, q heads and kv heads."""

    index: tuple
    device: torch.device
    shard: int            # batch shard * stripe_total + stripe: its rows
    stripe: int
    b0: int
    b1: int
    h0: int
    h1: int
    k0: int
    k1: int


def _linear(coord: dict, axes: tuple, shape: dict) -> int:
    """Row-major index of ``coord`` over ``axes`` (the first the major)."""
    i = 0
    for a in axes:
        i = i * shape[a] + coord[a]
    return i


def coordinates(geom: PagedGeom, mesh) -> list[Coord]:
    """The coordinates that hold work, one for each (batch shard, stripe,
    head shard); an axis outside the plan would repeat them and is taken
    at index 0."""
    out = []
    bl = geom.batch_local
    hl = geom.q_heads // geom.head_shards
    kl = geom.kv_heads_local
    for coord in mesh.coords():
        if any(i for a, i in coord.items() if a not in geom.manual_axes):
            continue
        ib = _linear(coord, geom.batch_axes, geom.mesh_shape)
        ih = _linear(coord, geom.head_axes, geom.mesh_shape)
        s = _linear(coord, geom.stripe_axes, geom.mesh_shape)
        out.append(Coord(tuple(coord[a] for a in mesh.axis_names),
                         mesh.device_at(coord), ib * geom.stripe_total + s,
                         s, ib * bl, (ib + 1) * bl, ih * hl, (ih + 1) * hl,
                         ih * kl, (ih + 1) * kl))
    return out


def split_arena(arena: torch.Tensor, geom: PagedGeom, mesh) -> Shards:
    """A global arena ``[L, cap, 2, block, kh(, hd)]`` (the reference's
    layout: no scratch row; an int8 arena's scales have no ``hd``) -> its
    shards: each coordinate's rows (shard ``batch shard * stripe_total +
    stripe`` of the row axis) and kv heads, with a zeroed scratch row
    last, on the coordinate's device."""
    cl = geom.cap_local
    out = Shards()
    for c in coordinates(geom, mesh):
        part = arena[:, c.shard * cl:(c.shard + 1) * cl, :, :, c.k0:c.k1]
        t = torch.zeros((part.shape[0], cl + 1) + tuple(part.shape[2:]),
                        dtype=arena.dtype, device=c.device)
        t[:, :cl] = part
        out[c.index] = t
    return out


def scatter_heads(geom: PagedGeom, mesh, q: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor):
    """Global q [b, h, hd] and k_new / v_new [b, kh, hd] -> the mesh
    island's inputs: :class:`Shards` of each coordinate's slots and heads
    (:func:`coordinates`) on its device."""
    cs = coordinates(geom, mesh)
    return (Shards({c.index: q[c.b0:c.b1, c.h0:c.h1].to(c.device)
                    for c in cs}),
            *(Shards({c.index: t[c.b0:c.b1, c.k0:c.k1].to(c.device)
                      for c in cs}) for t in (k_new, v_new)))


def gather_heads(geom: PagedGeom, mesh, out: Shards) -> torch.Tensor:
    """The inverse of :func:`scatter_heads` for the island's output: [b, h,
    hd] on the mesh's home entry."""
    cs = coordinates(geom, mesh)
    first = out[cs[0].index]
    whole = torch.empty((geom.batch, geom.q_heads) + tuple(first.shape[2:]),
                        dtype=first.dtype, device=mesh.home)
    for c in cs:
        whole[c.b0:c.b1, c.h0:c.h1] = out[c.index].to(mesh.home)
    return whole


def zero_shards(shape, dtype, geom: PagedGeom, mesh) -> Shards:
    """Zeroed shards of a global arena of ``shape`` ``[L, cap, 2, block,
    kh(, hd)]``: :func:`split_arena` of zeros, built on each coordinate's
    device directly."""
    out = Shards()
    for c in coordinates(geom, mesh):
        local = list(shape)
        local[1] = geom.cap_local + 1
        local[4] = geom.kv_heads_local
        out[c.index] = torch.zeros(local, dtype=dtype, device=c.device)
    return out


def join_arena(shards: Shards, geom: PagedGeom, mesh) -> torch.Tensor:
    """The inverse of :func:`split_arena`: the global arena ``[L, cap,
    ...]`` on the mesh's home entry (scratch rows dropped)."""
    cl = geom.cap_local
    coords = coordinates(geom, mesh)
    first = shards[coords[0].index]
    shape = list(first.shape)
    shape[1] = geom.cap
    shape[4] = geom.kv_heads
    out = torch.empty(shape, dtype=first.dtype, device=mesh.home)
    for c in coords:
        out[:, c.shard * cl:(c.shard + 1) * cl, :, :, c.k0:c.k1] = \
            shards[c.index][:, :cl].to(mesh.home)
    return out


def mesh_page_table(geom: PagedGeom, pt: torch.Tensor) -> torch.Tensor:
    """A page table of global arena rows ``[batch, nblk]`` (-1 missing) ->
    the mesh's ``[batch, stripe_total, nblk_local]`` of local rows: block
    ``j`` of slot ``b`` must lie in the shard of ``b``'s batch shard and
    stripe ``j % stripe_total`` (raises otherwise)."""
    st, cl = geom.stripe_total, geom.cap_local
    b = pt.shape[0]
    j = torch.arange(geom.nblk, device=pt.device)
    want = (torch.arange(b, device=pt.device)[:, None] // geom.batch_local
            * st + j[None] % st)
    ok = (pt < 0) | (pt // cl == want)
    if not bool(ok.all()):
        raise ValueError("a page lies outside its slot's and stripe's shard")
    local = torch.where(pt < 0, -1, pt % cl).to(torch.int32)
    return local.reshape(b, geom.nblk_local, st).transpose(1, 2).contiguous()


def global_page_table(geom: PagedGeom, pt: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`mesh_page_table`: ``[batch, stripe_total,
    nblk_local]`` local rows -> ``[batch, nblk]`` global rows."""
    st, cl = geom.stripe_total, geom.cap_local
    b = pt.shape[0]
    shard = (torch.arange(b, device=pt.device)[:, None, None]
             // geom.batch_local * st
             + torch.arange(st, device=pt.device)[None, :, None])
    rows = torch.where(pt < 0, -1, shard * cl + pt)
    return rows.transpose(1, 2).reshape(b, geom.nblk).to(torch.int32)


def global_write_rows(geom: PagedGeom, write_rows: torch.Tensor
                      ) -> torch.Tensor:
    """The mesh's ``write_rows`` [batch, stripe_total] of local rows -> the
    mesh-free ``[batch, 1]`` of global rows (the owner's; -1 where no
    stripe writes)."""
    st, cl = geom.stripe_total, geom.cap_local
    b = write_rows.shape[0]
    shard = (torch.arange(b, device=write_rows.device)[:, None]
             // geom.batch_local * st
             + torch.arange(st, device=write_rows.device)[None])
    rows = torch.where(write_rows < 0, -1, shard * cl + write_rows)
    return rows.max(dim=1, keepdim=True).values.to(torch.int32)


def mesh_write_rows(geom: PagedGeom, pt: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """``write_rows`` [batch, stripe_total] of the mesh page table ``pt``
    for a round at ``lengths``: the local row of each active slot's tail
    block (block ``lengths // block``) on its owner stripe, -1 elsewhere
    (on the device, no sync)."""
    st = geom.stripe_total
    b = pt.shape[0]
    j = (lengths // geom.block).long()
    bi = torch.arange(b, device=pt.device)
    row = pt[bi, j % st, j // st]
    wr = torch.full((b, st), -1, dtype=torch.int32, device=pt.device)
    wr[bi, j % st] = torch.where(active, row, -1).to(torch.int32)
    return wr


@dataclasses.dataclass
class MeshInputs:
    """One round's inputs cut per coordinate (:func:`localize`): the
    step computes them once and every island of the round reads them."""

    coords: list
    local: dict            # coordinate index -> dict of its tensors
    active: torch.Tensor   # [batch] bool on home: the slot has a request


def localize(geom: PagedGeom, mesh, pt, blk_start, lengths, write_rows,
             write_off) -> MeshInputs:
    """Cut a round's global inputs (``pt`` / ``blk_start`` [b, stripe_total,
    nblk_local], ``lengths`` / ``write_off`` [b], ``write_rows`` [b,
    stripe_total]) per coordinate, on its device: its page table and
    block starts (None without stripes: block j starts at j * block),
    the rows it writes (its scratch row where it does not own the new
    token) and their offsets, the positions its bf16 kernel sees
    (``lengths + 1`` where the slot has a request) and its int8 kernel's
    lengths (-1: the slot attends nothing there)."""
    active = (write_rows >= 0).any(dim=1)
    st, cl = geom.stripe_total, geom.cap_local
    coords = coordinates(geom, mesh)
    local = {}
    for c in coords:
        dev, sl = c.device, slice(c.b0, c.b1)
        wr = write_rows[sl, c.stripe].to(dev)
        own = wr >= 0
        act = active[sl].to(dev)
        lens = lengths[sl].to(dev)
        local[c.index] = {
            "pt": pt[sl, c.stripe].to(dev, torch.int32).contiguous(),
            "blk_start": (blk_start[sl, c.stripe].to(dev, torch.int32)
                          .contiguous() if st > 1 else None),
            "tgt": torch.where(own, wr, cl).long(),
            "off": write_off[sl].to(dev).long(),
            "visible": torch.where(act, lens + 1, 0).to(torch.int32),
            "lens_q": torch.where(own if st == 1 else act, lens,
                                  -1).to(torch.int32),
        }
    return MeshInputs(coords, local, active)


def _combine(geom: PagedGeom, mesh, outs: Shards, lses: Shards,
              dtype) -> Shards:
    """The reference's cross-stripe combine of each coordinate's partial
    [b_local, h, hd] (normalised, fp32) and its log-sum-exps [b_local, h],
    with collectives over the stripe axes: every coordinate gets its
    slots' combined output in ``dtype``."""
    ax = geom.stripe_axes
    mg = pmax(lses, mesh, ax, "paged.lse_max")
    w = Shards({k: torch.exp(t - mg[k]) for k, t in lses.items()})
    num = psum(Shards({k: w[k][..., None] * outs[k] for k in outs}), mesh,
               ax, "paged.combine")
    den = psum(w, mesh, ax, "paged.weights")
    return Shards({k: (num[k] / den[k][..., None]).to(dtype) for k in outs})


def make_paged_island(geom: PagedGeom, mesh=None, *, scale: float,
                      softcap: float = 0.0, window: int = 0,
                      quant: bool = False):
    """Returns island(q, k_new, v_new, arena_l, pt, blk_start, lengths,
    write_rows, write_off[, scale_l]) -> (attn_out, arena_l[, scale_l]).

    q [b, h, hd]; k_new/v_new [b, kh, hd]; lengths [b] tokens in the pool;
    write_off [b] the new token's offset in its block. Without a mesh:
    arena_l [cap + 1, 2, block, kh, hd] (row ``cap`` scratch, written in
    place); pt [b, 1, nblk] pool rows (-1 missing); blk_start [b, 1,
    nblk] (``build_blk_start``: block j starts at j * block); write_rows
    [b, 1] the new token's block row (-1: the slot has no request, attends
    to nothing and gives 0). ``quant=True``: the arena is int8 and
    ``scale_l`` [cap + 1, 2, block, kh] fp32 its scales, both written in
    place.

    Over a mesh (module docstring): q, k_new and v_new are :class:`Shards`
    (each coordinate's slots and heads, :func:`scatter_heads`), lengths
    and the page inputs global tensors on the mesh's home entry (pt /
    blk_start [b, stripe_total, nblk_local] of local rows, write_rows [b,
    stripe_total]); arena_l (and scale_l) are :class:`Shards` of one
    layer, written in place; the output is :class:`Shards` like q
    (:func:`gather_heads`). The mesh island also takes ``local=``, the
    round's :func:`localize` result, so that a step cuts its inputs once
    for every layer."""
    check_mesh(mesh)
    if mesh is None or not geom.manual_axes:
        return _local_island(scale=scale, softcap=softcap, window=window,
                             quant=quant)
    mesh.require_runnable("the paged island")
    return _mesh_island(geom, mesh, scale=scale, softcap=softcap,
                        window=window, quant=quant)


def _local_island(*, scale, softcap, window, quant):
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


def _mesh_island(geom, mesh, *, scale, softcap, window, quant):
    st = geom.stripe_total
    kwin = window + 1 if window and window > 0 else 0

    def island(q, k_new, v_new, arena_l, pt, blk_start, lengths, write_rows,
               write_off, scale_l=None, *, local=None):
        if quant == (scale_l is None):
            raise TypeError("scale_l goes with the int8 arena, and only there")
        if local is None:
            local = localize(geom, mesh, pt, blk_start, lengths, write_rows,
                             write_off)
        outs, lses = Shards(), Shards()
        for c in local.coords:
            loc = local.local[c.index]
            ql, kl, vl = q[c.index], k_new[c.index], v_new[c.index]
            a = arena_l[c.index]
            cl = a.shape[0] - 1
            kw = dict(scale=scale, softcap=softcap,
                      blk_start=loc["blk_start"], return_lse=st > 1)
            if quant:   # the unquantized new token enters once: from
                # the owner without stripes, else from stripe 0 (the
                # combine is a sum, so which stripe adds it is free)
                sc = scale_l[c.index]
                res = paged_attention(
                    ql, a[:cl], loc["pt"], loc["lens_q"], window=window,
                    scales=sc[:cl], kv_self=(kl, vl) if c.stripe == 0
                    else None, **kw)
                qv, scv = quantize_kv(torch.stack([kl, vl], dim=1))
                a[loc["tgt"], :, loc["off"]] = qv
                sc[loc["tgt"], :, loc["off"]] = scv
            else:
                a[loc["tgt"], :, loc["off"]] = torch.stack(
                    [kl, vl], dim=1).to(a.dtype)
                res = paged_attention(ql, a[:cl], loc["pt"], loc["visible"],
                                      window=kwin, **kw)
            if st == 1:
                outs[c.index] = res
            else:
                outs[c.index], lses[c.index] = res
        out = outs if st == 1 else _combine(
            geom, mesh, outs, lses, next(iter(q.values())).dtype)
        return (out, arena_l, scale_l) if quant else (out, arena_l)

    return island
