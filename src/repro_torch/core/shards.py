"""Sharded tables: hash-partitioned storage over N shard tables (port of
``repro.core.shards``).

A table created with ``SHARDS n [PARTITION BY col]`` splits its rows across
``n`` shards of ``shard_capacity`` rows; each shard has its own validity,
clock and hash indexes. Storage is STACKED: every leaf of the state is one
tensor ``[n, ...]`` (``init_state``), so shard ``i`` is the view
``leaf[i]`` (:func:`lane_view`): the daemon's execution lanes are views of
the stack, and a lane runs the monolithic executors of ``core/table.py``
unchanged while a fan-out reads the stack in place.

The executors below take the whole stack (the reference's vmapped
executors) and keep its result contract:

*   **pruned**: an equality on the partition column (``planner.
    plan_shards``) with an integer value anchors each statement to the
    shard ``shard_of(value)``, computed on the device;
*   **fan-out**: everything else runs on every shard and merges: SELECT
    takes each shard's first candidates and then the first ``limit``
    through one compaction (ORDER BY re-ranks the shards' top rows), COUNT
    and SUM add, MIN / MAX fold, AVG is (sum of sums) / (sum of counts),
    DML counts add.

Either way the work is a list of (shard, statement) PAIRS, and the
kernels take it in one launch: the relscan scan and the verified probe
take ``sid`` (the shard of each pair) and read the stacked columns at
``base + sid * shard_capacity``, the compaction takes the ``[pairs,
shard_capacity]`` mask as rows, and the hash build rebuilds every shard's
index in its two launches. A fan-out lists its pairs shard by shard. That
is the counterpart of the reference's ``vmap`` of a Pallas kernel, which
adds a grid axis; no shard is gathered for the kernels.

Row ids are globalized as ``shard * shard_capacity + slot``, which is the
row's index in the flattened stack. Row order inside a fan-out SELECT
follows (shard, slot). Every statement advances EVERY shard's clock by
what the unsharded table would add. As in the reference, LRU eviction
and ``MAX_ROWS`` act per shard, and the partition column cannot be
UPDATEd (DELETE + INSERT moves a row).

Mesh placement (the reference's ``shard_map`` placement): a
table whose shard count admits it gets a lane mesh
(``launch/mesh.lane_mesh_for``), and its stack is split into contiguous
BLOCKS of ``n // d`` shards, block ``k`` on mesh device ``k``
(:func:`place_lanes`). A lane is then a view of its block. A fan-out runs
the stacked executors above once per block, on the block marked with
its first global shard (:func:`as_block`): their pairs are the block's
shards, a pruned pair whose shard lies in another
block is inactive, and row ids stay global. The blocks' results move to
the home device (the mesh's first entry), where the ``merge_*`` functions
below combine them: counts add, each block's first ``limit`` candidates
(rows and sort keys with them) merge through one compaction or one sort,
and the aggregates merge their per-shard partials as one stack would.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Sequence

import torch

from repro_torch.core import planner as PL
from repro_torch.core import predicate as P
from repro_torch.core import table as T
from repro_torch.core.schema import TableSchema
from repro_torch.kernels import hashidx as HX
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import relscan as RS

_PRIME = HX._PRIME   # 2^32 / phi: the hash index's multiplier
_SHIFT = 17          # well-mixed upper bits before the modulo


def shard_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Partition hash: int32 keys -> shard ids in [0, n_shards), the
    reference's ``(uint32(key) * _PRIME >> 17) % n`` in int64."""
    return ((HX.hash32(keys) >> _SHIFT) % n_shards).to(torch.int32)


def shard_of_host(key: int, n_shards: int) -> int:
    """Host twin of :func:`shard_of` (the same bits for any int32 value):
    the scheduler and EXPLAIN route statements without a device trip."""
    ku = (int(key) * _PRIME) & 0xFFFFFFFF
    return (ku >> _SHIFT) % n_shards


def is_sharded(schema: TableSchema) -> bool:
    return schema.shards > 1


@functools.lru_cache(maxsize=1024)
def shard_schema(schema: TableSchema) -> TableSchema:
    """The per-shard schema: capacity and ``MAX_ROWS`` split ceil-wise,
    shards=1, so the within-shard planner and executors see an ordinary
    table."""
    cap = -(-schema.capacity // schema.shards)
    exp = schema.expiry
    if exp.max_rows > 0:
        exp = dataclasses.replace(
            exp, max_rows=max(1, -(-exp.max_rows // schema.shards)))
    return dataclasses.replace(
        schema, capacity=cap, max_select=min(schema.max_select, cap),
        expiry=exp, shards=1, partition_by=None)


def shard_capacity(schema: TableSchema) -> int:
    return shard_schema(schema).capacity


def _tree(fn, x):
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    return fn(x)


def init_state(schema: TableSchema, device, n: int | None = None) -> dict:
    """The stacked state: every leaf of a shard's state, ``[shards, ...]``
    (``n``: that many shards of the layout, one block of a placed
    table)."""
    one = T.init_state(shard_schema(schema), device)
    n = schema.shards if n is None else n
    return _tree(lambda x: x[None].repeat((n,) + (1,) * x.dim()).contiguous(),
                 one)


def lane_view(state: dict, sid: int) -> dict:
    """Shard ``sid`` of a stacked state as views (writes land in the stack)."""
    return _tree(lambda x: x[sid], state)


def flat_cols(state: dict) -> dict:
    """The stacked columns flattened along (shard, slot): a global row id
    indexes them directly."""
    return {c: v.reshape((-1,) + tuple(v.shape[2:]))
            for c, v in state["cols"].items()}


# ----------------------------------------------------------- mesh placement

BASE = "shard_base"   # the key that marks one block of a placed table


def as_block(state: dict, base: int) -> dict:
    """Block ``state`` of a table placed over a mesh (the stack's shards
    ``[base, base + n)``), marked for the executors below: their pairs are
    the block's shards, a pruned pair whose shard lies in another block is
    inactive, and their row ids stay GLOBAL. The daemon marks each block
    it runs and strips what comes back (:func:`unblock`)."""
    return dict(state, **{BASE: int(base)})


def unblock(state: dict) -> dict:
    """``state`` without the mark :func:`as_block` gave it."""
    return {k: v for k, v in state.items() if k != BASE}


def _base(state: dict) -> int:
    """The first GLOBAL shard of the state an executor runs on: 0 for a
    whole stack, the block's first for a marked block."""
    return state.get(BASE, 0)


def lane_devices(mesh, n_shards: int):
    """Device of each lane under ``mesh`` placement (contiguous blocks of
    ``n_shards // len(mesh)`` lanes a device), or None when unplaced."""
    if mesh is None:
        return None
    per = n_shards // len(mesh)
    return [mesh[i // per] for i in range(n_shards)]


def place_lanes(mesh, state: dict) -> list:
    """A stacked state (on any device) -> its blocks, block ``k`` the
    contiguous shards ``[k * per, (k + 1) * per)`` as new tensors on
    ``mesh[k]`` (a copy even where the device is the same: each block owns
    its storage, as on distinct cards)."""
    d = len(mesh)
    per = state["valid"].shape[0] // d
    return [_tree(lambda x, k=k: x[k * per:(k + 1) * per].to(
        mesh[k], copy=True).contiguous(), state) for k in range(d)]


def assemble_lanes(mesh, blocks: list) -> list:
    """The inputs of a mesh fan-out: ``(device, block)`` of every mesh
    entry, in mesh order (a listing, no copy); each block must lie on its
    entry's device (:func:`constrain_lanes`)."""
    constrain_lanes(mesh, blocks)
    return list(zip(mesh, blocks))


def disassemble_lanes(mesh, n_shards: int, blocks: list) -> list:
    """Lane ``i`` of a placed table: views of shard ``i % per`` of block
    ``i // per`` (writes land in the block)."""
    per = n_shards // len(mesh)
    return [lane_view(blocks[i // per], i % per) for i in range(n_shards)]


def constrain_lanes(mesh, blocks: list) -> None:
    """Raise unless block ``k`` lies on ``mesh[k]`` (the counterpart of
    the reference's sharding constraint on the mesh executor's output)."""
    if len(blocks) != len(mesh):
        raise ValueError(f"{len(blocks)} blocks for a mesh of {len(mesh)}")
    for k, (dev, blk) in enumerate(zip(mesh, blocks)):
        if blk["valid"].device != dev:
            raise ValueError(f"block {k} lies on {blk['valid'].device}, its "
                             f"mesh entry is {dev}")


def gather_lanes(blocks: list, device) -> dict:
    """The blocks stacked into one state on ``device`` (RESHARD's and
    CHECKPOINT's input; one copy a block)."""
    def cat(*xs):
        return torch.cat([x.to(device) for x in xs])

    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        return cat(*trees)

    return walk(blocks)


def flat_schema(schema: TableSchema) -> TableSchema:
    """Monolithic-layout schema whose capacity covers the flattened shard
    stack (``shards * shard_capacity``: global row ids index it
    directly), for row-id readers of :func:`flat_state`. Only tests call
    it until a sharded kv table serves (ROADMAP Queue 1 item 5)."""
    cap = shard_capacity(schema) * schema.shards
    return dataclasses.replace(schema, capacity=cap, shards=1,
                               partition_by=None)


def flat_state(state: dict) -> dict:
    """Monolithic-layout view of a stacked state: columns, validity and
    payloads flattened along (shard, slot), so GLOBAL row ids index them
    like an unsharded table's (the serving page table's bridge to a
    sharded metadata table; only tests call it until a sharded kv table
    serves, ROADMAP Queue 1 item 5)."""
    return dict(
        state,
        cols=flat_cols(state),
        payloads={p: v.reshape((-1,) + tuple(v.shape[2:]))
                  for p, v in state["payloads"].items()},
        valid=state["valid"].reshape(-1),
        clock=state["clock"][0],
        ops=state["ops"][0],
    )


def _tick_all(state: dict, n=1) -> dict:
    """Advance every shard's clock in lockstep."""
    return dict(state, clock=state["clock"] + n, ops=state["ops"] + n)


def live_count(state: dict) -> torch.Tensor:
    return state["valid"].sum(dtype=torch.int32)


def plan_for(schema: TableSchema, where, ranked: bool = False) -> PL.Plan:
    """The WITHIN-SHARD plan (shard routing itself is value-directed)."""
    return PL.plan_where(shard_schema(schema), where, ranked)


def _fused_plan(schema: TableSchema, where) -> P.FusedScan | None:
    return PL.as_fused(plan_for(schema, where))


def index_fresh(state: dict, column: str) -> torch.Tensor:
    """0-d bool: no shard's index on ``column`` has overflowed (one stale
    shard sends a whole fan-out to the scan)."""
    return (state["indexes"][column]["stale"] == 0).all()


# ------------------------------------------------------- mesh merges (home)
#
# A mesh fan-out's block results, moved to the home device, merge into the
# one result the whole stack gives. Pruned statements are owned by one
# block: the others report nothing for them (count 0, no row present).


def _cat_rows(outs: list, key: str) -> torch.Tensor:
    return torch.cat([o[key] for o in outs], dim=1)


def _take(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``x[i, sel[i, j]]`` for a [w, m, ...] candidate tensor."""
    idx = sel.reshape(tuple(sel.shape) + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(tuple(sel.shape) + tuple(x.shape[2:])))


def _pick(present: torch.Tensor, limit: int, keys=None):
    """The first ``limit`` candidates of every statement: present ones in
    block order (a compaction), or with ``keys`` the largest keys first
    (present before absent on a tie, then block order: a stable sort as
    the stack's own re-rank). Returns (sel [w, limit], present)."""
    m = present.shape[1]
    if keys is None:
        sel, pres, _ = T._compact(present, limit, m)
        return sel.long(), pres
    fill = (-torch.inf if keys.dtype.is_floating_point
            else torch.iinfo(keys.dtype).min)
    k = torch.where(present, keys, fill)
    first = torch.sort(present.to(torch.int8), dim=1, descending=True,
                       stable=True).indices
    order = torch.sort(k.gather(1, first), dim=1, descending=True,
                       stable=True).indices
    sel = first.gather(1, order)[:, :limit]
    return sel, present.gather(1, sel)


def merge_select(outs: list, limit: int, ordered: bool,
                 batched: bool = True) -> dict:
    """Block results of ``select_many`` (``select`` when not ``batched``)
    -> the table's: counts add, and each statement's first ``limit``
    candidates (ORDER BY: re-ranked by the blocks' sort keys) carry their
    rows, row ids and payloads along."""
    if not batched:
        outs = [_tree(lambda x: x[None], o) for o in outs]
    present = _cat_rows(outs, "present")
    sel, pres = _pick(present, limit,
                      _cat_rows(outs, "keys") if ordered else None)
    res = {"count": merge_sum([o["count"] for o in outs]),
           "present": pres,
           "row_ids": torch.where(pres, _cat_rows(outs, "row_ids").gather(
               1, sel), 0),
           "rows": {c: _take(torch.cat([o["rows"][c] for o in outs], 1), sel)
                    for c in outs[0]["rows"]},
           "payloads": {p: _take(torch.cat([o["payloads"][p] for o in outs],
                                           1), sel)
                        for p in outs[0]["payloads"]}}
    return res if batched else _tree(lambda x: x[0], res)


def merge_delete_returning(outs: list, limit: int) -> tuple:
    """Block results ``(n, ids [limit], present [limit])`` of
    ``delete_returning`` -> the table's: counts add, the first ``limit``
    deleted row ids in (shard, slot) order."""
    present = torch.cat([o[2] for o in outs])[None]
    sel, pres = _pick(present, limit)
    ids = torch.cat([o[1] for o in outs])[None].gather(1, sel)
    return (merge_sum([o[0] for o in outs]), torch.where(pres, ids, 0)[0],
            pres[0])


def merge_aggregate(outs: list, agg: str, count_only: bool,
                    batched: bool = True) -> torch.Tensor:
    """Partials of :func:`aggregate_parts` (one for a whole stack, one a
    block, in mesh order, for a placed table) -> the table's values: a
    fan-out's per-shard partials stacked in shard order and merged; a
    pruned statement's value from the block that owns it."""
    if "parts" in outs[0]:
        per = [torch.cat(p) if len(p) > 1 else p[0]
               for p in zip(*(o["parts"] for o in outs))]
        val = _merge_agg(agg.upper(), count_only, per)
    else:
        val = outs[0]["value"]
        for o in outs[1:]:
            val = torch.where(o["live"], o["value"], val)
    return val if batched else val[0]


def merge_sum(outs: list):
    """Block results that add (row counts, slots of rows that one block
    wrote and the others left 0, evictions): element-wise sums."""
    if isinstance(outs[0], (tuple, list)):
        return tuple(merge_sum([o[i] for o in outs])
                     for i in range(len(outs[0])))
    if isinstance(outs[0], dict):
        return {k: merge_sum([o[k] for o in outs]) for k in outs[0]}
    return sum(outs[1:], outs[0])


# ------------------------------------------------------------------ pairs

@dataclasses.dataclass(frozen=True)
class _Pairs:
    """The (shard, statement) pairs of ``w`` statements: a fan-out lists
    every shard for every statement, shard by shard (pair ``s * w + j``);
    a pruned dispatch has one pair per statement, on its own shard."""

    fanout: bool
    n_shards: int        # shards of the state (a block's inside a mesh)
    w: int
    sid: torch.Tensor    # [n] int32: the pair's shard (local)
    stmt: torch.Tensor   # [n] int64: the pair's statement
    base: int = 0        # the state's first global shard (_base)
    # [n] bool: the pair's shard lies in this block (pruned pairs of a
    # block only; None: every pair)
    live: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.sid.shape[0]


def _route_key(schema: TableSchema, where, params_w):
    """The pruning key term when this statement prunes AND its value is an
    integer (a float keeps exact-compare semantics: fan-out), else None."""
    route = PL.plan_shards(schema, where)
    if route.key is None or not T._int_values((route.key,), params_w):
        return None
    return route.key


def _pairs(schema: TableSchema, state: dict, where, params_w,
           w: int) -> _Pairs:
    n_sh = state["valid"].shape[0]
    base = _base(state)
    dev = state["valid"].device
    key = _route_key(schema, where, params_w)
    if key is not None:
        sid = shard_of(T._term_vals(key, params_w, w, dev), schema.shards)
        stmt = torch.arange(w, device=dev)
        if n_sh == schema.shards:   # the whole stack
            return _Pairs(False, n_sh, w, sid, stmt)
        live = (sid >= base) & (sid < base + n_sh)
        return _Pairs(False, n_sh, w, torch.where(live, sid - base, 0), stmt,
                      base, live)
    sid = torch.arange(n_sh, dtype=torch.int32,
                       device=dev)[:, None].expand(n_sh, w).reshape(-1)
    return _Pairs(True, n_sh, w, sid, torch.arange(w, device=dev).repeat(n_sh),
                  base)


def _gate_live(mask: torch.Tensor, pairs: _Pairs) -> torch.Tensor:
    """A [n, ...] pair mask with the pairs of other blocks cleared."""
    if pairs.live is None:
        return mask
    return mask & pairs.live.reshape((-1,) + (1,) * (mask.dim() - 1))


def _pair_rows(x: torch.Tensor, pairs: _Pairs) -> torch.Tensor:
    """[n, cap_s, ...] rows of each pair's shard of a stacked leaf (a view
    for a one-statement fan-out, else a gather)."""
    if pairs.fanout and pairs.w == 1:
        return x
    return x[pairs.sid.long()]


def _pair_mask(state: dict, where, params_w, pairs: _Pairs) -> torch.Tensor:
    """GenericScan over pairs: [n, cap_s] match mask (validity included).
    A fan-out evaluates the predicate on the stack in place. A name the
    table lacks is left out of the columns, so the evaluator raises on it
    as it does on a monolithic table (``KeyError("unknown column ...")``,
    the reference's text) before any column is read."""
    cap_s = state["valid"].shape[1]
    names = [c for c in PL.columns_of(where) if c in state["cols"]]
    names = names or ["_created"]
    if pairs.fanout:
        cols = {c: state["cols"][c][:, None, :] for c in names}
        pr = tuple(p.reshape(1, pairs.w, 1) for p in params_w)
        m = P.eval_predicate(where, cols, pr, cap_s,
                             lead=(pairs.n_shards, pairs.w))
        m = m & state["valid"][:, None, :]
        return m.reshape(pairs.n, cap_s)
    s = pairs.sid.long()
    cols = {c: state["cols"][c][s] for c in names}
    pr = tuple(p.reshape(pairs.w, 1) for p in params_w)
    return P.eval_predicate(where, cols, pr, cap_s,
                            lead=(pairs.w,)) & state["valid"][s]


def _fused_pairs(state: dict, scan: P.FusedScan, params_w, pairs: _Pairs):
    """FusedScan over pairs through the relscan scan's shard axis: (mask
    [n, cap_s], count [n]) in one launch, or None when a bound value is no
    integer (exact-compare semantics: the generic scan)."""
    if not T._int_values(scan.terms, params_w):
        return None
    dev = state["valid"].device
    vals = torch.stack([T._term_vals(t, params_w, pairs.w, dev)
                        for t in scan.terms], dim=1)[pairs.stmt]
    cols = [state["cols"][c] for c in scan.columns]
    mask, _, count = RS.scan(cols, state["valid"], vals, scan.ops,
                             sid=pairs.sid, run=pairs.w if pairs.fanout else 1)
    return mask, count


def _scan_pairs(state: dict, where, route, params_w, pairs: _Pairs):
    """The scan route of every pair: (mask [n, cap_s], count [n])."""
    fused = None
    if isinstance(route, PL.FusedScan):
        fused = _fused_pairs(state, route.scan, params_w, pairs)
    if fused is not None:
        return fused
    mask = _pair_mask(state, where, params_w, pairs)
    return mask, mask.sum(dim=1, dtype=torch.int32)


def _probe_pairs(state: dict, plan: PL.IndexProbe, params_w, pairs: _Pairs,
                 *, extra_mask=None, active_p=None, limit: int = 0):
    """The IndexProbe route of every pair in one launch of the verified
    probe (``HX.probe_verify`` on its shard axis): (safe [n, 128] shard
    row ids, ok [n, 128], count [n], ids [n, limit] or None).
    ``active_p`` [n] gates pairs (with the pairs of other blocks)."""
    if pairs.live is not None:
        active_p = pairs.live if active_p is None else active_p & pairs.live
    dev = state["valid"].device
    idx = state["indexes"][plan.column]
    st = pairs.stmt
    residual = [(state["cols"][t.col], t.op,
                 T._term_vals(t, params_w, pairs.w, dev)[st])
                for t in plan.residual]
    return HX.probe_verify(
        idx["rid"], idx["key"], T._term_vals(plan.key, params_w, pairs.w,
                                             dev)[st],
        valid=state["valid"], keycol=state["cols"][plan.column],
        residual=residual, extra_mask=extra_mask, active=active_p,
        limit=limit, sid=pairs.sid)


def _fresh(state: dict, column: str, pairs: _Pairs) -> torch.Tensor:
    """0-d bool: every shard a pair probes has a fresh index. A fresh index
    holds every live row, so its probe and the scan agree; a stale one
    sends the dispatch to the scan, which is always exact."""
    stale = state["indexes"][column]["stale"]
    if pairs.fanout:
        return (stale == 0).all()
    return (stale[pairs.sid.long()] == 0).all()


def _global_ids(ids: torch.Tensor, pairs: _Pairs, cap_s: int):
    return ids + ((pairs.sid + pairs.base) * cap_s)[:, None]


def _flat_scatter(x: torch.Tensor, sid, rows, ok, src) -> torch.Tensor:
    """New stacked ``x`` with ``x[sid, rows] = src`` where ``ok`` (the
    reference's drop-mode scatter, through the flattened stack)."""
    n_sh, cap_s = x.shape[0], x.shape[1]
    tgt = torch.where(ok, sid.reshape(-1, 1) * cap_s + rows, n_sh * cap_s)
    if isinstance(src, torch.Tensor):
        src = src.reshape(-1)
    flat = T._drop_scatter(x.reshape((-1,) + tuple(x.shape[2:])), tgt, src)
    return flat.reshape(x.shape)


def _pair_hits(mask: torch.Tensor, pairs: _Pairs) -> torch.Tensor:
    """[n, cap_s] pair mask -> [S, cap_s]: rows matched by any pair."""
    if pairs.fanout:
        return mask.reshape(pairs.n_shards, pairs.w, -1).any(dim=1)
    hit = torch.zeros((pairs.n_shards, mask.shape[1]), dtype=torch.int32,
                      device=mask.device)
    hit.index_add_(0, pairs.sid, mask.to(torch.int32))
    return hit > 0


def _route(schema: TableSchema, where, params_w, plan, ranked=False):
    """A caller-forced within-shard plan wins; otherwise the planner's,
    demoted to its fallback when a probe term binds a non-integer."""
    if plan is not None:
        return plan, True
    route = plan_for(schema, where, ranked)
    if isinstance(route, PL.IndexProbe) and not T._int_values(
            (route.key,) + route.residual, params_w):
        route = route.fallback
    return route, False


# ------------------------------------------------------------------ insert

def _alloc_stacked(state: dict, n: int) -> torch.Tensor:
    """[S, n] slots a shard: the free list when EVERY shard holds ``n``
    free slots, else LRU eviction (the reference hoists one condition over
    the shards)."""
    valid = state["valid"]
    n_sh, cap_s = valid.shape
    free = (~valid).to(torch.int32)
    cum = torch.cumsum(free, dim=1, dtype=torch.int32)
    want = torch.arange(1, n + 1, dtype=torch.int32,
                        device=valid.device).expand(n_sh, n).contiguous()
    free_slots = torch.searchsorted(cum, want).clamp(max=cap_s - 1)
    key = torch.where(valid, state["cols"]["_accessed"], -1)
    lru = torch.sort(key, dim=1, stable=True).indices[:, :n]
    ok = free.sum(dim=1).min() >= n
    return torch.where(ok, free_slots, lru)


def _write_rows(x: torch.Tensor, slots: torch.Tensor, vals, m: torch.Tensor):
    """New stacked ``x`` with ``x[s, slots[s, k]] = vals[s, k]`` where
    ``m[s, k]`` (slots of a shard are distinct)."""
    n_sh = x.shape[0]
    si = torch.arange(n_sh, device=x.device)[:, None]
    old = x[si, slots]
    keep = m.reshape(tuple(m.shape) + (1,) * (old.dim() - 2))
    out = x.clone()
    out[si, slots] = torch.where(keep, T.to_device(vals, x.device, x.dtype),
                                 old)
    return out


def insert(schema: TableSchema, state: dict, values: Mapping[str, Any],
           payloads: Mapping[str, Any] | None = None, row_mask=None, ttl=0):
    """Hash-routed batch insert: one device split (``OPS.shard_split``)
    and one insert into every shard. Returns (state, slots [b] GLOBAL row
    ids, evicted). Rows that omit the partition column hash its default
    (0). A batch wider than a shard goes in chunks of the shard's width,
    as the reference's does; the clock still moves once."""
    s_sch = shard_schema(schema)
    n_sh, cap_s = state["valid"].shape[0], s_sch.capacity
    base = _base(state)
    payloads = payloads or {}
    dev = state["valid"].device
    b = None
    for v in list(values.values()) + list(payloads.values()):
        b = v.shape[0] if isinstance(v, torch.Tensor) else len(v)
        break
    if b is None:
        raise ValueError("insert needs at least one column or payload")
    row_mask = (torch.ones((b,), dtype=torch.bool, device=dev)
                if row_mask is None else T.to_device(row_mask, dev,
                                                     torch.bool))
    pkeys = values.get(schema.partition_by)
    pkeys = (torch.zeros((b,), dtype=torch.int32, device=dev) if pkeys is None
             else torch.broadcast_to(T.to_device(pkeys, dev, torch.int32),
                                     (b,)))
    # on a placed table the whole batch reaches every block, which takes
    # the rows of its own shards (the reference broadcasts it the same way)
    sid = shard_of(pkeys, schema.shards) - base
    rows, mask = OPS.shard_split(sid, n_sh,
                                 row_mask & (sid >= 0) & (sid < n_sh))
    vals_b = {c.name: torch.broadcast_to(
        T.to_device(values[c.name], dev, c.dtype), (b,))
        for c in schema.columns if c.name in values}
    pls_b = {p.name: T.to_device(payloads[p.name], dev, p.dtype)
             for p in schema.payloads if p.name in payloads}
    ttl_b = torch.broadcast_to(T.to_device(ttl, dev, torch.int32), (b,))
    offs = ((torch.arange(n_sh, dtype=torch.int32, device=dev) + base)
            * cap_s)[:, None]
    w = min(b, cap_s)
    n_chunks = -(-b // w)
    slots_out = torch.zeros((b,), dtype=torch.int32, device=dev)
    evicted = torch.zeros((), dtype=torch.int32, device=dev)
    for ci in range(n_chunks):
        r = rows[:, ci * w:(ci + 1) * w].long()
        m = mask[:, ci * w:(ci + 1) * w]
        if r.shape[1] < w:   # the last chunk keeps the shard width
            pad = w - r.shape[1]
            r = torch.cat([r, r.new_zeros((n_sh, pad))], dim=1)
            m = torch.cat([m, m.new_zeros((n_sh, pad))], dim=1)
        state, slots, ev = _insert_chunk(schema, s_sch, state, r, m, vals_b,
                                         pls_b, ttl_b, w)
        tgt = torch.where(m, r, b)
        slots_out = T._drop_scatter(slots_out, tgt, (slots + offs).reshape(-1))
        evicted = evicted + ev
    if n_chunks > 1:
        state = _tick_all(state, 1 - n_chunks)
    return state, slots_out, evicted


def _insert_chunk(schema, s_sch, state, r, m, vals_b, pls_b, ttl_b, w):
    """One chunk of :func:`insert`: every shard takes its ``w``-wide slice
    of rows ``r`` (masked by ``m``), as the monolithic insert does."""
    slots = _alloc_stacked(state, w)
    now = state["clock"][:, None]
    cols = dict(state["cols"])
    for c in schema.columns:
        v = vals_b.get(c.name)
        v = (torch.zeros_like(r, dtype=c.dtype) if v is None else v[r])
        cols[c.name] = _write_rows(cols[c.name], slots, v, m)
    now_w = now.expand(-1, w)
    cols["_created"] = _write_rows(cols["_created"], slots, now_w, m)
    cols["_accessed"] = _write_rows(cols["_accessed"], slots, now_w, m)
    cols["_ttl"] = _write_rows(cols["_ttl"], slots, ttl_b[r], m)
    pls = dict(state["payloads"])
    for name, v in pls_b.items():
        pls[name] = _write_rows(pls[name], slots, v[r], m)
    si = torch.arange(r.shape[0], device=r.device)[:, None]
    evicted = (state["valid"][si, slots] & m).sum(dtype=torch.int32)
    valid = _write_rows(state["valid"], slots, True, m)
    indexes = dict(state["indexes"])
    if s_sch.indexes:
        if w >= T.BULK_INDEX_THRESHOLD:
            nb = HX.n_buckets_for(s_sch.capacity)
            for ixc in s_sch.indexes:
                rid, key, overflow = HX.build(cols[ixc], valid, n_buckets=nb)
                indexes[ixc] = {"rid": rid, "key": key, "stale": overflow}
        else:
            # narrow batches re-home their slots shard by shard (plain
            # tensor upkeep, as in the monolithic insert)
            for ixc in s_sch.indexes:
                ix = state["indexes"][ixc]
                parts = [HX.insert_update_batched(
                    {"rid": ix["rid"][s], "key": ix["key"][s],
                     "stale": ix["stale"][s]}, slots[s],
                    state["cols"][ixc][s][slots[s]], cols[ixc][s][slots[s]],
                    m[s], valid[s]) for s in range(r.shape[0])]
                indexes[ixc] = {k: torch.stack([p[k] for p in parts])
                                for k in ("rid", "key", "stale")}
    new = dict(state, cols=cols, payloads=pls, valid=valid, indexes=indexes)
    return _tick_all(new), slots.to(torch.int32), evicted


# ------------------------------------------------------------------ select

def _gather_rows(state: dict, gid: torch.Tensor, columns, with_payloads):
    """Columns / payloads of GLOBAL row ids of this state (clamped; absent
    rows read row 0 and are never shown)."""
    flat = flat_cols(state)
    n_rows = state["valid"].numel()
    gi = (gid.long() - _base(state) * state["valid"].shape[1]).clamp(
        0, n_rows - 1)
    rows = {c: flat[c][gi] for c in columns}
    pls = {p: state["payloads"][p].reshape(
        (-1,) + tuple(state["payloads"][p].shape[2:]))[gi]
        for p in with_payloads}
    return rows, pls


def _merge_candidates(pairs: _Pairs, ids: torch.Tensor, count: torch.Tensor,
                      limit: int, cap_s: int):
    """Fan-out merge of per-pair candidates ids [n, s_limit] (shard row
    ids, first matches in row order) -> per statement the first ``limit``
    in (shard, slot) order through one compaction. Returns (gid [w, lim],
    present [w, lim], count [w])."""
    n_sh, w, s_limit = pairs.n_shards, pairs.w, ids.shape[1]
    pres = T._present(count, s_limit)                       # [n, s_limit]
    gid = _global_ids(ids, pairs, cap_s)
    m = n_sh * s_limit
    pres = pres.reshape(n_sh, w, s_limit).transpose(0, 1).reshape(w, m)
    gid = gid.reshape(n_sh, w, s_limit).transpose(0, 1).reshape(w, m)
    idx, present, _ = T._compact(pres, limit, m)
    out = gid.gather(1, idx.long())
    total = count.reshape(n_sh, w).sum(dim=0, dtype=torch.int32)
    return torch.where(present, out, 0), present, total


def _pad(x: torch.Tensor, limit: int):
    """Pad the row axis (1) of a per-statement result to ``limit``."""
    if x.shape[1] >= limit:
        return x
    pad = torch.zeros((x.shape[0], limit - x.shape[1]) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def select_many(schema: TableSchema, state: dict, where, params_w, w: int,
                *, columns: Sequence[str] | None = None,
                order_by: str | None = None, descending: bool = False,
                limit: int | None = None, with_payloads: Sequence[str] = (),
                touch: bool = True, active: torch.Tensor | None = None,
                plan: PL.Plan | None = None):
    """``w`` SELECTs of one shape with shard routing (``table.select_many``
    contract, GLOBAL row ids). ``plan`` forces the within-shard plan."""
    s_sch = shard_schema(schema)
    cap_s = s_sch.capacity
    limit = schema.max_select if limit is None else min(limit,
                                                        schema.max_select)
    s_limit = min(limit, s_sch.max_select)
    columns = tuple(columns) if columns is not None else schema.column_names
    pairs = _pairs(schema, state, where, params_w, w)
    act_p = None if active is None else active[pairs.stmt]
    if pairs.live is not None:
        act_p = pairs.live if act_p is None else act_p & pairs.live
    now = state["clock"][:, None]
    accessed = state["cols"]["_accessed"]

    def gate(mask, count):
        if act_p is not None:
            count = torch.where(act_p, count, 0)
            mask = mask & act_p[:, None]
        return mask, count

    if order_by is not None:
        mask = _pair_mask(state, where, params_w, pairs)
        mask, count = gate(mask, mask.sum(dim=1, dtype=torch.int32))
        key = _pair_rows(state["cols"][order_by], pairs)
        if key.dtype.is_floating_point:
            key = key if descending else -key
            key = torch.where(mask, key, -torch.inf)
        else:
            key = key if descending else ~key
            key = torch.where(mask, key, torch.iinfo(key.dtype).min)
        top = torch.sort(key, dim=1, descending=True, stable=True)
        idx = top.indices[:, :s_limit]
        pres = mask.gather(1, idx)
        if pairs.fanout:
            # global top-k over the shards' top rows; ties keep (shard,
            # rank) order, as the reference's top_k does
            n_sh, m = pairs.n_shards, pairs.n_shards * idx.shape[1]

            def per_stmt(x):
                return x.reshape(n_sh, w, -1).transpose(0, 1).reshape(w, m)
            ck = per_stmt(top.values[:, :s_limit])
            gid = per_stmt(_global_ids(idx, pairs, cap_s))
            cp = per_stmt(pres)
            sel = torch.sort(ck, dim=1, descending=True,
                             stable=True).indices[:, :limit]
            count = count.reshape(n_sh, w).sum(dim=0, dtype=torch.int32)
            present = cp.gather(1, sel) & (
                torch.arange(sel.shape[1], device=sel.device)[None, :]
                < count[:, None])
            gid = torch.where(present, gid.gather(1, sel), 0)
            keys = ck.gather(1, sel)
        else:
            gid = torch.where(pres, _global_ids(idx, pairs, cap_s), 0)
            present = pres
            keys = top.values[:, :s_limit]
        hits = _pair_hits(mask, pairs)
        acc = torch.where(hits, now, accessed) if touch else accessed
    else:
        route, forced = _route(s_sch, where, params_w, plan)

        def scan_route(r):
            mask, count = _scan_pairs(state, where, r, params_w, pairs)
            mask, count = gate(mask, count)
            ids, _ = RS.compact(mask, s_limit)
            hits = _pair_hits(mask, pairs)
            acc = torch.where(hits, now, accessed) if touch else accessed
            return acc, ids, count

        def probe_route(r):
            safe, ok, count, ids = _probe_pairs(state, r, params_w, pairs,
                                                active_p=act_p,
                                                limit=s_limit)
            acc = (_flat_scatter(accessed, pairs.sid, safe, ok,
                                 now[pairs.sid.long()].expand(
                                     -1, safe.shape[1]))
                   if touch else accessed)
            return acc, ids, count

        if isinstance(route, PL.IndexProbe):
            if forced:
                acc, ids, count = probe_route(route)
            else:
                acc, ids, count = T._select_fresh(
                    _fresh(state, route.column, pairs), probe_route(route),
                    scan_route(route.fallback))
        else:
            acc, ids, count = scan_route(route)
        if pairs.fanout:
            gid, present, count = _merge_candidates(pairs, ids, count, limit,
                                                    cap_s)
        else:
            present = T._present(count, ids.shape[1])
            gid = torch.where(present, _global_ids(ids, pairs, cap_s), 0)
    gid, present = _pad(gid, limit), _pad(present, limit)
    rows, pls = _gather_rows(state, gid, columns, with_payloads)
    if touch:
        state = dict(state, cols=dict(state["cols"], _accessed=acc))
    state = _tick_all(state)
    res = {"count": count, "rows": rows, "present": present,
           "row_ids": gid.to(torch.int32), "payloads": pls}
    if order_by is not None:   # a placed table's merge re-ranks by them
        res["keys"] = _pad(keys, limit)
    return state, res


def select(schema: TableSchema, state: dict, where, params: Sequence[Any] = (),
           *, active=None, **kw):
    """One SELECT (the reference's signature): :func:`select_many` at
    width 1, without the batch axis."""
    dev = state["valid"].device
    act = (None if active is None
           else T.to_device(active, dev, torch.bool).reshape(1))
    state, res = select_many(schema, state, where, T._one(params, dev), 1,
                             active=act, **kw)
    out = {"count": res["count"][0],
           "rows": {c: v[0] for c, v in res["rows"].items()},
           "present": res["present"][0],
           "row_ids": res["row_ids"][0],
           "payloads": {k: v[0] for k, v in res["payloads"].items()}}
    if "keys" in res:
        out["keys"] = res["keys"][0]
    return state, out


def batch_touch(schema: TableSchema, state: dict, res: dict,
                active: torch.Tensor) -> dict:
    """The batched SELECT's epilogue: touch the RETURNED rows (global ids
    index the flattened stack) and advance every clock by the active
    statement count."""
    n_sh, cap_s = state["valid"].shape
    acc = state["cols"]["_accessed"]
    rid = res["row_ids"] - _base(state) * cap_s   # this block's rows
    ours = res["present"] & (rid >= 0) & (rid < n_sh * cap_s)
    tgt = torch.where(ours, rid, n_sh * cap_s)
    flat = T._drop_scatter(acc.reshape(-1), tgt, state["clock"][0])
    nact = active.to(torch.bool).sum(dtype=torch.int32)
    state = dict(state, cols=dict(state["cols"], _accessed=flat.reshape(
        acc.shape)))
    return _tick_all(state, nact)


# --------------------------------------------------------------------- DML

def _check_partition_update(schema: TableSchema, set_cols) -> None:
    if schema.partition_by in set_cols:
        raise ValueError(
            f"cannot UPDATE partition column {schema.partition_by!r} of "
            f"sharded table {schema.name!r} (DELETE + INSERT instead)")


def update(schema: TableSchema, state: dict, where, set_exprs, params=(), *,
           extra_mask=None, plan: PL.Plan | None = None,
           maintain_indexes: bool = True):
    """UPDATE with shard routing. Returns (state, n). Rewriting the
    partition column is refused."""
    set_items = [("_ttl" if c.upper() == "TTL" else c, e)
                 for c, e in set_exprs.items()]
    _check_partition_update(schema, {c for c, _ in set_items})
    s_sch = shard_schema(schema)
    dev = state["valid"].device
    pw = T._one(params, dev)
    p0 = tuple(p.reshape(()) for p in pw)
    pairs = _pairs(schema, state, where, pw, 1)
    em = (None if extra_mask is None
          else T.to_device(extra_mask, dev, torch.bool))

    def scan_route(r):
        mask, _ = _scan_pairs(state, where, r, pw, pairs)
        hit = _pair_hits(_gate_live(mask, pairs), pairs)
        if em is not None:
            hit = hit & em
        cols = dict(state["cols"])
        for tgt, expr in set_items:
            v = P.eval_expr(expr, state["cols"], p0)
            v = torch.broadcast_to(T.to_device(v, dev, cols[tgt].dtype),
                                   hit.shape)
            cols[tgt] = torch.where(hit, v, cols[tgt])
        return cols, hit.sum(dtype=torch.int32)

    def probe_route(r):
        xm = None if em is None else torch.broadcast_to(em,
                                                        state["valid"].shape)
        safe, ok, n, _ = _probe_pairs(state, r, pw, pairs, extra_mask=xm)
        s = pairs.sid.long()[:, None]
        gathered = {c: v[s, safe.long()] for c, v in state["cols"].items()}
        cols = dict(state["cols"])
        for tgt, expr in set_items:
            v = P.eval_expr(expr, gathered, p0)
            v = torch.broadcast_to(T.to_device(v, dev, cols[tgt].dtype),
                                   safe.shape)
            cols[tgt] = _flat_scatter(cols[tgt], pairs.sid, safe, ok, v)
        return cols, n.sum(dtype=torch.int32)

    route, forced = _route(s_sch, where, pw, plan)
    if isinstance(route, PL.IndexProbe):
        if forced:
            cols, n = probe_route(route)
        else:
            cols, n = T._select_fresh(_fresh(state, route.column, pairs),
                                      probe_route(route),
                                      scan_route(route.fallback))
    else:
        cols, n = scan_route(route)
    state = dict(state, cols=cols)
    if maintain_indexes:
        written = {c for c, _ in set_items}
        for ixc in s_sch.indexes:
            if ixc in written:
                state = (build_index(schema, state, ixc) if pairs.fanout
                         else _rebuild_shards(s_sch, state, ixc, pairs.sid,
                                              pairs.live))
    return _tick_all(state), n


def _rebuild_shards(s_sch: TableSchema, state: dict, column: str,
                    sid: torch.Tensor, live=None) -> dict:
    """Rebuild ``column``'s index on the shards ``sid`` names only (a
    pruned UPDATE's): one build over their ``[len(sid), cap_s]`` slice,
    scattered back; every other shard keeps its index as it was (as does
    a pair of another block: ``live`` False)."""
    s = sid.long()
    rid, key, overflow = HX.build(state["cols"][column][s], state["valid"][s],
                                  n_buckets=HX.n_buckets_for(s_sch.capacity))
    old = state["indexes"][column]
    if live is not None:
        rid = torch.where(live[:, None, None], rid, old["rid"][s])
        key = torch.where(live[:, None, None], key, old["key"][s])
        overflow = torch.where(live, overflow, old["stale"][s])
    new = {"rid": old["rid"].index_copy(0, s, rid),
           "key": old["key"].index_copy(0, s, key),
           "stale": old["stale"].index_copy(0, s, overflow)}
    return dict(state, indexes=dict(state["indexes"], **{column: new}))


def _delete_core(schema, state, where, params, *, want_ids, limit,
                 extra_mask=None, plan=None):
    """Shared DELETE executor over pairs: (valid', n, ids [limit] global,
    present [limit]); ids are zeros when ``want_ids`` is False."""
    s_sch = shard_schema(schema)
    cap_s = s_sch.capacity
    dev = state["valid"].device
    pw = T._one(params, dev)
    pairs = _pairs(schema, state, where, pw, 1)
    s_limit = min(limit, cap_s)
    em = (None if extra_mask is None
          else T.to_device(extra_mask, dev, torch.bool))

    def finish(valid, n, ids, count):
        if not want_ids:
            return (valid, n, torch.zeros((limit,), dtype=torch.int32,
                                          device=dev),
                    torch.zeros((limit,), dtype=torch.bool, device=dev))
        if pairs.fanout:
            gid, present, _ = _merge_candidates(pairs, ids, count, limit,
                                                cap_s)
        else:
            present = T._present(count, ids.shape[1])
            gid = torch.where(present, _global_ids(ids, pairs, cap_s), 0)
        return valid, n, _pad(gid, limit)[0], _pad(present, limit)[0]

    def scan_route(r):
        mask, count = _scan_pairs(state, where, r, pw, pairs)
        if em is not None:
            mask = mask & _pair_rows(torch.broadcast_to(
                em, state["valid"].shape), pairs)
        if em is not None or pairs.live is not None:
            mask = _gate_live(mask, pairs)
            count = mask.sum(dim=1, dtype=torch.int32)
        hit = _pair_hits(mask, pairs)
        ids = RS.compact(mask, s_limit)[0] if want_ids else None
        return finish(state["valid"] & ~hit, count.sum(dtype=torch.int32),
                      ids, count)

    def probe_route(r):
        xm = None if em is None else torch.broadcast_to(em,
                                                        state["valid"].shape)
        safe, ok, count, ids = _probe_pairs(
            state, r, pw, pairs, extra_mask=xm,
            limit=s_limit if want_ids else 0)
        valid = _flat_scatter(state["valid"], pairs.sid, safe, ok, False)
        return finish(valid, count.sum(dtype=torch.int32), ids, count)

    route, forced = _route(s_sch, where, pw, plan)
    if isinstance(route, PL.IndexProbe):
        if forced:
            return probe_route(route)
        return T._select_fresh(_fresh(state, route.column, pairs),
                               probe_route(route), scan_route(route.fallback))
    return scan_route(route)


def delete(schema: TableSchema, state: dict, where, params=(), *,
           extra_mask=None, plan: PL.Plan | None = None):
    """DELETE with shard routing (validity flips only). Returns (state,
    n)."""
    valid, n, _, _ = _delete_core(schema, state, where, params,
                                  want_ids=False, limit=1,
                                  extra_mask=extra_mask, plan=plan)
    return _tick_all(dict(state, valid=valid)), n


def delete_returning(schema: TableSchema, state: dict, where, params=(), *,
                     limit: int | None = None, plan: PL.Plan | None = None):
    """DELETE that also reports WHICH rows went: (state, n, ids [limit]
    global, present [limit]); a fan-out reports the first ``limit`` in
    (shard, slot) order."""
    limit = schema.max_select if limit is None else limit
    valid, n, ids, present = _delete_core(schema, state, where, params,
                                          want_ids=True, limit=limit,
                                          plan=plan)
    return _tick_all(dict(state, valid=valid)), n, ids, present


def delete_many_eq(schema: TableSchema, state: dict, column: str,
                   vals: torch.Tensor, active: torch.Tensor, *,
                   per_statement: bool = False):
    """Multi-value eq DELETE over every shard in one pass: the monolithic
    executor on the flattened stack (each row is matched on its own, so
    the per-shard sums are its sums). Returns (state, n) or (state, n,
    counts [w])."""
    shape = state["valid"].shape
    flat = dict(state, cols={column: state["cols"][column].reshape(-1)},
                valid=state["valid"].reshape(-1))
    out = T.delete_many_eq(shard_schema(schema), flat, column, vals, active,
                           per_statement=per_statement)
    new = dict(state, valid=out[0]["valid"].reshape(shape),
               clock=out[0]["clock"], ops=out[0]["ops"])
    return (new,) + tuple(out[1:])


# --------------------------------------------------------------- aggregate

def aggregate_parts(schema: TableSchema, state: dict, agg: str,
                    column: str | None, where, params_w, w: int, *,
                    plan: PL.Plan | None = None):
    """``w`` aggregates with shard routing, before the merge: pruned
    statements aggregate their shard (``{"value": [w], "live": [w] bool
    or None}``, live: the shard lies in this block), a fan-out gives its
    per-shard partials (``{"parts": ([shards, w], ...)}``: the value, or
    SUM and COUNT for AVG). :func:`merge_aggregate` folds a list of them:
    one for a whole stack, one a block for a placed table. Returns
    (state, partials)."""
    agg = agg.upper()
    s_sch = shard_schema(schema)
    pairs = _pairs(schema, state, where, params_w, w)
    col = None if column is None else state["cols"][column]
    count_only = agg == "COUNT" or col is None
    parts = (("SUM", "COUNT") if pairs.fanout and agg == "AVG"
             and not count_only else (agg,))

    def reduce(vals, mask, count):
        return tuple(count if a == "COUNT" or vals is None
                     else T._reduce(a, vals, mask) for a in parts)

    def scan_route(r):
        mask, count = _scan_pairs(state, where, r, params_w, pairs)
        if pairs.live is not None:
            mask = _gate_live(mask, pairs)
            count = mask.sum(dim=1, dtype=torch.int32)
        vals = None if count_only else _pair_rows(col, pairs)
        return reduce(vals, mask, count)

    def probe_route(r):
        safe, ok, count, _ = _probe_pairs(state, r, params_w, pairs)
        vals = (None if count_only
                else col[pairs.sid.long()[:, None], safe.long()])
        return reduce(vals, ok, count)

    route, forced = _route(s_sch, where, params_w, plan)
    if isinstance(route, PL.IndexProbe):
        if forced:
            out = probe_route(route)
        else:
            out = T._select_fresh(_fresh(state, route.column, pairs),
                                  probe_route(route),
                                  scan_route(route.fallback))
    else:
        out = scan_route(route)
    if not pairs.fanout:
        return _tick_all(state), {"value": out[0], "live": pairs.live}
    return _tick_all(state), {"parts": tuple(o.reshape(pairs.n_shards, w)
                                             for o in out)}


def aggregate_many(schema: TableSchema, state: dict, agg: str,
                   column: str | None, where, params_w, w: int, *,
                   plan: PL.Plan | None = None):
    """``w`` aggregates with shard routing: pruned statements aggregate
    their shard; a fan-out merges per-shard partials (COUNT / SUM add,
    MIN / MAX fold, AVG = sum of sums / max(sum of counts, 1), as the
    reference merges). Returns (state, values [w])."""
    state, part = aggregate_parts(schema, state, agg, column, where,
                                  params_w, w, plan=plan)
    return state, merge_aggregate(
        [part], agg, agg.upper() == "COUNT" or column is None)




def _merge_agg(agg: str, count_only: bool, per) -> torch.Tensor:
    """The fan-out merge of per-shard aggregate partials (``per``: one
    [shards, w] tensor a part: the value, or SUM and COUNT for AVG)."""
    if count_only or agg == "COUNT":
        val = per[0].sum(dim=0, dtype=torch.int32)
    elif agg == "AVG":
        val = (per[0].to(torch.float32).sum(dim=0)
               / per[1].sum(dim=0, dtype=torch.int32).clamp(min=1))
    elif agg == "SUM":
        val = (per[0].sum(dim=0) if per[0].dtype.is_floating_point
               else per[0].sum(dim=0, dtype=per[0].dtype))
    elif agg == "MIN":
        val = per[0].amin(dim=0)
    elif agg == "MAX":
        val = per[0].amax(dim=0)
    else:
        raise ValueError(f"unknown aggregate {agg!r}")
    return val


def aggregate(schema: TableSchema, state: dict, agg: str, column, where,
              params=(), *, plan: PL.Plan | None = None):
    """One aggregate (the reference's signature). Returns (state, value)."""
    state, out = aggregate_many(schema, state, agg, column, where,
                                T._one(params, state["valid"].device), 1,
                                plan=plan)
    return state, out[0]


# -------------------------------------------------------------- lifecycle

def expire(schema: TableSchema, state: dict):
    """The paper's §4.3 expiry on every shard at once: the age condition
    matches the unsharded table's (clocks are in lockstep), the MAX_ROWS
    cap is per shard. Returns (state, n)."""
    pol = shard_schema(schema).expiry
    valid = state["valid"]
    cols = state["cols"]
    cap_s = valid.shape[1]
    now = state["clock"][:, None]
    ttl_eff = torch.where(cols["_ttl"] > 0, cols["_ttl"], pol.ttl)
    expired = valid & (ttl_eff > 0) & ((now - cols["_created"]) > ttl_eff)
    if 0 < pol.max_rows < cap_s:
        live = valid & ~expired
        order = torch.sort(cols["_created"], dim=1, stable=True).indices
        live_in_rank = live.to(torch.int32).gather(1, order)
        cum = torch.cumsum(live_in_rank, dim=1, dtype=torch.int32) \
            - live_in_rank
        older_live = torch.zeros_like(cum).scatter(1, order, cum)
        n_live = live.sum(dim=1, dtype=torch.int32, keepdim=True)
        expired = expired | (live & (n_live - older_live - 1 >= pol.max_rows))
    n = expired.sum(dtype=torch.int32)
    return _tick_all(dict(state, valid=valid & ~expired)), n


def flush(schema: TableSchema, state: dict):
    """Drop every row of every shard; indexes reset to empty."""
    n = state["valid"].sum(dtype=torch.int32)
    state = dict(state, valid=torch.zeros_like(state["valid"]))
    if schema.indexes:
        state["indexes"] = {c: _tree(torch.zeros_like, ix) for c, ix in
                            state["indexes"].items()}
        for ix in state["indexes"].values():
            ix["rid"] = torch.full_like(ix["rid"], HX.EMPTY)
    return _tick_all(state), n


def build_index(schema: TableSchema, state: dict,
                column: str | None = None) -> dict:
    """(Re)build the hash index(es) of every shard: one call of the build
    kernel (two launches) an index, whatever the shard count."""
    s_sch = shard_schema(schema)
    cols = [column] if column is not None else list(s_sch.indexes)
    indexes = dict(state["indexes"])
    nb = HX.n_buckets_for(s_sch.capacity)
    for c in cols:
        rid, key, overflow = HX.build(state["cols"][c], state["valid"],
                                      n_buckets=nb)
        indexes[c] = {"rid": rid, "key": key, "stale": overflow}
    return dict(state, indexes=indexes)


def reshard(old_schema: TableSchema, new_schema: TableSchema, state: dict):
    """The bulk re-split behind ``ALTER TABLE t RESHARD n``: every live row
    of ``state`` (stacked, or monolithic for an unsharded table), in
    (shard, slot) order, through ONE device split into the new layout,
    plus one stacked index build. Row metadata and the clock ride along,
    so contents round-trip exactly. Returns (new state, counts [new_n]):
    live rows per NEW shard from the full split, so the caller can refuse
    a skew that overflows a new shard before installing anything. The old
    state is not touched."""
    new_n = new_schema.shards
    s_new = shard_schema(new_schema) if new_n > 1 else new_schema
    cap_new = s_new.capacity
    pcol = new_schema.partition_by if new_n > 1 else old_schema.partition_by
    stacked = state["valid"].dim() == 2
    dev = state["valid"].device
    valid = state["valid"].reshape(-1)
    cols = flat_cols(state) if stacked else state["cols"]
    pls = ({p: v.reshape((-1,) + tuple(v.shape[2:]))
            for p, v in state["payloads"].items()} if stacked
           else state["payloads"])
    pkeys = (cols[pcol].to(torch.int32) if pcol is not None
             else torch.zeros(valid.shape, dtype=torch.int32, device=dev))
    rows, mask = OPS.shard_split(shard_of(pkeys, new_n), new_n, valid)
    counts = mask.sum(dim=1, dtype=torch.int32)
    r, m = rows[:, :cap_new].long(), mask[:, :cap_new]
    if r.shape[1] < cap_new:   # growing capacity: pad the gather frame
        pad = cap_new - r.shape[1]
        r = torch.cat([r, r.new_zeros((new_n, pad))], dim=1)
        m = torch.cat([m, m.new_zeros((new_n, pad))], dim=1)

    def gather(a):
        g = a[r]
        keep = m.reshape(tuple(m.shape) + (1,) * (g.dim() - 2))
        return torch.where(keep, g, torch.zeros((), dtype=a.dtype,
                                                device=dev))

    clock = state["clock"].reshape(-1)[0]
    ops = state["ops"].reshape(-1)[0]
    out = {"cols": {c: gather(v) for c, v in cols.items()},
           "payloads": {p: gather(v) for p, v in pls.items()},
           "valid": m,
           "clock": clock.expand(new_n).clone(),
           "ops": ops.expand(new_n).clone(),
           "indexes": {}}
    nb = HX.n_buckets_for(cap_new)
    for c in new_schema.indexes:
        rid, key, ov = HX.build(out["cols"][c], m, n_buckets=nb)
        out["indexes"][c] = {"rid": rid, "key": key, "stale": ov}
    if new_n == 1:
        out = lane_view(out, 0)
    return _tree(lambda x: x.contiguous(), out), counts
