"""RelTable: a fixed-capacity, device-resident relational cache table,
executed as plans (port of ``repro.core.table``).

Storage is struct-of-arrays with a validity bitmap; table state is a plain
dict of tensors with the reference's layout (``cols`` / ``payloads`` /
``valid`` / ``clock`` / ``ops`` / ``indexes``). Every executor is a
function ``(schema, state, ...) -> (state, result)`` that returns NEW
tensors for whatever it changes and never writes into the tensors of the
state it was given, so a result never aliases live state and a caller may
keep the old state. Slot allocation unifies the free list with LRU
eviction; a logical clock stamps ``_created`` / ``_accessed`` and drives
the paper's expiry conditions (:func:`expire`).

Query execution follows ``core/planner.plan_where``: IndexProbe (one hash
bucket, kernels/hashidx), FusedScan (the relscan kernels) or GenericScan
(the masked scan over ``predicate.eval_predicate``, compacted by the
relscan compaction kernel). Where the reference branches on device with
``lax.cond`` (the allocator's free-list vs LRU path, a stale index's scan
fallback), these executors compute both paths and select with
``torch.where`` on the device-side condition: no host sync, at the price
that an IndexProbe also pays its fallback scan.

No executor syncs with the host: there is no ``.item()``, no boolean-mask
indexing and no ``nonzero``. Out-of-range scatters of the reference
(``mode="drop"``) write into a scratch slot past the end that is sliced
off; gathers index with clamped ids.

SELECT and aggregate run ``w`` statements at once (``select_many`` /
``aggregate_many``, parameters as ``[w]`` tensors): the relscan kernels
take a ``[w, nterms]`` value matrix and the probe kernel ``w`` keys, so
one launch serves the whole batch. ``select`` / ``aggregate`` are the
one-statement forms with the reference's signatures. Callers may pass
``plan=`` to force a route (a forced IndexProbe skips the staleness
select and trusts the caller).
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import planner as PL
from repro_torch.core import predicate as P
from repro_torch.core.schema import RESERVED_COLUMNS, TableSchema
from repro_torch.kernels import hashidx as HX
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import relscan as RS

CLOCK_DTYPE = torch.int32

# multi-value eq DELETE batches up to this wide use direct per-value
# compares; wider ones sort the values and binary-search each row once
_EQ_DIRECT_MAX = 16

# INSERT batches at least this wide maintain hash indexes by ONE bulk
# rebuild (the build kernel) instead of the batched re-home pass; the
# rebuild is complete by construction, so it also resets a stale flag
# whenever the live rows fit their buckets again.
BULK_INDEX_THRESHOLD = 64


def init_state(schema: TableSchema, device) -> dict:
    cap = schema.capacity
    dev = torch.device(device)
    cols = {c.name: torch.zeros((cap,), dtype=c.dtype, device=dev)
            for c in schema.columns}
    for r in RESERVED_COLUMNS:
        cols[r] = torch.zeros((cap,), dtype=torch.int32, device=dev)
    payloads = {p.name: torch.zeros((cap,) + tuple(p.shape), dtype=p.dtype,
                                    device=dev) for p in schema.payloads}
    nb = HX.n_buckets_for(cap)
    indexes = {c: HX.empty_index(nb, dev) for c in schema.indexes}
    return {
        "cols": cols,
        "payloads": payloads,
        "valid": torch.zeros((cap,), dtype=torch.bool, device=dev),
        "clock": torch.zeros((), dtype=CLOCK_DTYPE, device=dev),
        "ops": torch.zeros((), dtype=CLOCK_DTYPE, device=dev),
        "indexes": indexes,
    }


def _tick(state: dict, n=1) -> dict:
    return dict(state, clock=state["clock"] + n, ops=state["ops"] + n)


# ------------------------------------------------------------- parameters

def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor -> ``device``. To a card it travels through pinned
    memory with a non-blocking copy: a pageable copy would wait for the
    stream to drain (a host sync)."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _scalar_dtype(v) -> torch.dtype:
    if isinstance(v, (bool, np.bool_)):
        return torch.bool
    if isinstance(v, (int, np.integer)):
        return torch.int64
    return torch.float32


def to_device(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (tensor, numpy array or Python scalar) as a tensor on
    ``device`` without a host sync: a scalar becomes a fill kernel
    (``torch.full``), a host array a pinned non-blocking upload."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        t = _upload(x, device)
    elif isinstance(x, np.ndarray) and x.ndim > 0:
        t = _upload(torch.from_numpy(np.ascontiguousarray(x)), device)
    else:
        v = x.item() if isinstance(x, (np.generic, np.ndarray)) else x
        return torch.full((), v, dtype=dtype or _scalar_dtype(v),
                          device=device)
    return t if dtype is None else t.to(dtype)


def param_tensor(v: Any, device) -> torch.Tensor:
    """One bound value as a 0-d tensor with the reference's 32-bit widths:
    ints -> int32, floats -> float32, bools -> bool (TEXT arrives
    interned, as an int)."""
    if isinstance(v, torch.Tensor):
        return to_device(v, device)
    if isinstance(v, (bool, np.bool_)):
        return to_device(bool(v), device, torch.bool)
    if isinstance(v, (int, np.integer)):
        return to_device(int(v), device, torch.int32)
    if isinstance(v, (float, np.floating)):
        return to_device(float(v), device, torch.float32)
    raise TypeError(f"unsupported parameter {v!r}")


def host_column(arr) -> np.ndarray:
    """Bound values (a scalar or a [b] column) as a numpy array with the
    reference's 32-bit widths (int64 wraps to int32, float64 rounds to
    float32, as the reference's 64-bit-off conversion does; TEXT arrives
    interned, as an int). The daemon stages these; executors see them as
    device tensors."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        return arr
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.int32)
    if np.issubdtype(arr.dtype, np.floating):
        return arr.astype(np.float32)
    raise TypeError(f"unsupported parameter dtype {arr.dtype}")


def _one(params: Sequence[Any], device) -> tuple:
    """One statement's params as [1] tensors (the batch form of width 1)."""
    return tuple(param_tensor(p, device).reshape(1) for p in params)


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def _term_vals(term: P.FusedTerm, params_w, w: int, device) -> torch.Tensor:
    """[w] int32 values of one fused term (consts broadcast)."""
    kind, v = term.value
    if kind == "param":
        return params_w[v].to(torch.int32).reshape(w)
    return torch.full((w,), v, dtype=torch.int32, device=device)


def _int_values(terms, params_w) -> bool:
    """Every term's bound value is an integer (a float bound to an int
    column keeps exact-compare semantics and demotes to the scan)."""
    return all(t.value[0] == "const" or _is_int(params_w[t.value[1]])
               for t in terms)


def _drop_scatter(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``dst`` with ``dst[idx] = src`` where index ``len(dst)`` is dropped
    (the reference's ``mode="drop"`` scatter): writes land in a scratch
    slot past the end, which is sliced off. Returns a new tensor."""
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    idx = idx.reshape(-1).long()
    # the value goes in as a device tensor of the index's length: a host
    # scalar would be copied over with a sync
    src = torch.broadcast_to(to_device(src, dst.device, dst.dtype),
                             (idx.shape[0],) + tuple(dst.shape[1:]))
    ext[idx] = src
    return ext[:-1]


def _masked_write(dst: torch.Tensor, slots: torch.Tensor, vals,
                  row_mask: torch.Tensor) -> torch.Tensor:
    """New ``dst`` with ``dst[slots] = vals`` for the rows of ``row_mask``
    (``slots`` are distinct, so masked rows simply write back what they
    hold)."""
    old = dst[slots]
    m = row_mask.reshape((-1,) + (1,) * (dst.dim() - 1))
    out = dst.clone()
    out[slots] = torch.where(m, to_device(vals, dst.device, dst.dtype), old)
    return out


# -------------------------------------------------------------- allocation

def _free_slots(state: dict, n: int) -> torch.Tensor:
    """The first ``n`` invalid row ids, via one cumsum + ``n`` binary
    searches. Only exact when at least ``n`` slots are free (the caller
    selects the LRU path otherwise); clamped so it never indexes out of
    range."""
    valid = state["valid"]
    cum = torch.cumsum((~valid).to(torch.int32), dim=0, dtype=torch.int32)
    want = torch.arange(1, n + 1, dtype=torch.int32, device=valid.device)
    return torch.searchsorted(cum, want).clamp(max=valid.shape[0] - 1)


def _lru_slots(state: dict, n: int) -> torch.Tensor:
    """Invalid rows first (key -1 < any clock stamp), then LRU-evict valid
    rows. A stable sort keeps ties in row order, which is what the
    reference's ``top_k`` does (lower row ids first)."""
    valid = state["valid"]
    key = torch.where(valid, state["cols"]["_accessed"], -1)
    return torch.sort(key, stable=True).indices[:n]


def _alloc_slots(state: dict, n: int) -> torch.Tensor:
    """Pick ``n`` slots: the free list when it holds enough, else LRU
    eviction. Both are computed and selected on device."""
    nfree = (~state["valid"]).sum(dtype=torch.int32)
    return torch.where(nfree >= n, _free_slots(state, n), _lru_slots(state, n))


def insert(
    schema: TableSchema,
    state: dict,
    values: Mapping[str, Any],
    payloads: Mapping[str, Any] | None = None,
    row_mask=None,
    ttl=0,
):
    """Insert a batch of rows. ``values[col]`` has shape [n]; columns not
    supplied default to 0. ``row_mask`` ([n] bool) lets a fixed-width
    executor insert fewer than n rows. Hash indexes are maintained in the
    same call: batches narrower than ``BULK_INDEX_THRESHOLD`` re-home their
    slots (``HX.insert_update_batched``), wider ones rebuild each index
    with the build kernel.

    Returns (state, slots [n] int32, evicted_count)."""
    payloads = payloads or {}
    dev = state["valid"].device
    n = None
    for v in values.values():
        n = np.shape(v)[0]
        break
    for v in payloads.values():
        n = np.shape(v)[0] if n is None else n
        break
    if n is None:
        raise ValueError("insert needs at least one column or payload")
    slots = _alloc_slots(state, n)
    row_mask = (torch.ones((n,), dtype=torch.bool, device=dev)
                if row_mask is None
                else to_device(row_mask, dev, torch.bool))

    cols = dict(state["cols"])
    for c in schema.columns:
        vals = values.get(c.name)
        if vals is None:
            vals = torch.zeros((n,), dtype=c.dtype, device=dev)
        else:
            vals = torch.broadcast_to(
                to_device(vals, dev, c.dtype), (n,))
        cols[c.name] = _masked_write(cols[c.name], slots, vals, row_mask)
    now = state["clock"]
    cols["_created"] = _masked_write(cols["_created"], slots, now, row_mask)
    cols["_accessed"] = _masked_write(cols["_accessed"], slots, now, row_mask)
    ttl_b = torch.broadcast_to(
        to_device(ttl, dev, torch.int32), (n,))
    cols["_ttl"] = _masked_write(cols["_ttl"], slots, ttl_b, row_mask)

    pls = dict(state["payloads"])
    for p in schema.payloads:
        if p.name in payloads:
            pls[p.name] = _masked_write(pls[p.name], slots,
                                        to_device(payloads[p.name], dev,
                                                  p.dtype), row_mask)

    valid = _masked_write(state["valid"], slots, True, row_mask)
    indexes = state.get("indexes", {})
    if schema.indexes and indexes:
        upd = {}
        if n >= BULK_INDEX_THRESHOLD:
            nb = HX.n_buckets_for(schema.capacity)
            for ixc in schema.indexes:
                rid, key, overflow = HX.build(cols[ixc], valid, n_buckets=nb)
                upd[ixc] = {"rid": rid, "key": key, "stale": overflow}
        else:
            for ixc in schema.indexes:
                # old keys from the PRE-insert column (they name the
                # bucket holding the overwritten slot's entry)
                upd[ixc] = HX.insert_update_batched(
                    indexes[ixc], slots, state["cols"][ixc][slots],
                    cols[ixc][slots], row_mask, valid)
        indexes = dict(indexes, **upd)
    new_state = dict(state, cols=cols, payloads=pls, valid=valid,
                     indexes=indexes)
    new_state = _tick(new_state)
    evicted = (state["valid"][slots] & row_mask).sum(dtype=torch.int32)
    return new_state, slots.to(torch.int32), evicted


# ----------------------------------------------------------- match helpers

def plan_for(schema: TableSchema, where, ranked: bool = False) -> PL.Plan:
    """The memoized plan for one WHERE against this schema."""
    return PL.plan_where(schema, where, ranked)


def _fused_plan(schema: TableSchema, where) -> P.FusedScan | None:
    """The <=4-term fused-conjunction view of the plan (batched-DML
    eq-shape detection)."""
    return PL.as_fused(PL.plan_where(schema, where))


def _match_mask(schema: TableSchema, state: dict, where, params_w,
                w: int) -> torch.Tensor:
    """GenericScan: [w, cap] match mask of w statements (params [w])."""
    pr = tuple(p.reshape(w, 1) for p in params_w)
    mask = P.eval_predicate(where, state["cols"], pr, schema.capacity,
                            lead=(w,))
    return mask & state["valid"]


def _fused_scan(schema, state, plan: P.FusedScan, params_w, w: int, *,
                limit, want_ids=True):
    """FusedScan through the relscan kernels for w statements: (ids,
    present, mask, count) with a leading w axis, or None when a bound
    value is not an integer (exact-compare semantics -> generic scan)."""
    dev = state["valid"].device
    if not _int_values(plan.terms, params_w):
        return None
    vals = torch.stack([_term_vals(t, params_w, w, dev) for t in plan.terms],
                       dim=1)
    cols_t = [state["cols"][c] for c in plan.columns]
    return OPS.predicate_scan(cols_t, state["valid"], vals, ops=plan.ops,
                              limit=limit, want_ids=want_ids)


def _present(count: torch.Tensor, limit: int) -> torch.Tensor:
    """[w, limit] presence of the first ``limit`` matches of each row."""
    return torch.arange(limit, dtype=torch.int32,
                        device=count.device)[None, :] < count[:, None]


def _compact(mask: torch.Tensor, limit: int, capacity: int):
    """[w, cap] mask -> the first ``limit`` set bits of each row (row
    order, 0-padded), presence and the unclamped count, through the relscan
    compaction kernel."""
    limit = min(limit, capacity)
    ids, count = RS.compact(mask, limit)
    return ids, _present(count, limit), count


def index_fresh(state: dict, column: str) -> torch.Tensor:
    """0-d bool tensor: the index on ``column`` never overflowed."""
    return state["indexes"][column]["stale"] == 0


def _probe_candidates(schema, state, plan: PL.IndexProbe, params_w, w: int,
                      *, extra_mask=None, active=None, limit: int = 0):
    """One hash-bucket probe per statement with candidate verification, in
    one launch of the probe kernel (``HX.probe_verify``). Returns (safe
    [w, 128] clamped row ids, ok [w, 128] match bits, count [w], ids
    [w, limit] matching row ids in row order, 0-padded, or None when
    ``limit`` is 0)."""
    dev = state["valid"].device
    idx = state["indexes"][plan.column]
    residual = [(state["cols"][t.col], t.op, _term_vals(t, params_w, w, dev))
                for t in plan.residual]
    em = None
    if extra_mask is not None:
        em = torch.broadcast_to(to_device(extra_mask, dev, torch.bool),
                                (schema.capacity,))
    return HX.probe_verify(
        idx["rid"], idx["key"], _term_vals(plan.key, params_w, w, dev),
        valid=state["valid"], keycol=state["cols"][plan.column],
        residual=residual, extra_mask=em, active=active, limit=limit)


def _route(schema, where, params_w, plan):
    """Caller-forced plan wins verbatim; otherwise the planner's choice,
    demoted to its fallback when a probe term is bound to a non-integer."""
    if plan is not None:
        return plan, True
    route = plan_for(schema, where)
    if isinstance(route, PL.IndexProbe) and not _int_values(
            (route.key,) + route.residual, params_w):
        route = route.fallback
    return route, False


def _select_fresh(fresh: torch.Tensor, probe_out, scan_out):
    """Elementwise pick between the probe route's and the scan route's
    outputs on the device-side freshness flag (the reference's lax.cond)."""
    if isinstance(probe_out, dict):
        return {k: _select_fresh(fresh, probe_out[k], scan_out[k])
                for k in probe_out}
    if isinstance(probe_out, (tuple, list)):
        return type(probe_out)(_select_fresh(fresh, a, b)
                               for a, b in zip(probe_out, scan_out))
    if probe_out is scan_out:
        return probe_out
    return torch.where(fresh, probe_out, scan_out)


def build_index(schema: TableSchema, state: dict,
                column: str | None = None) -> dict:
    """(Re)build the hash index(es) from the current column/validity state
    with the build kernel: REINDEX, UPDATEs of an indexed column."""
    cols = [column] if column is not None else list(schema.indexes)
    indexes = dict(state["indexes"])
    nb = HX.n_buckets_for(schema.capacity)
    for c in cols:
        rid, key, overflow = HX.build(state["cols"][c], state["valid"],
                                      n_buckets=nb)
        indexes[c] = {"rid": rid, "key": key, "stale": overflow}
    return dict(state, indexes=indexes)


# ------------------------------------------------------------------ select

def select_many(
    schema: TableSchema,
    state: dict,
    where: P.Node | None,
    params_w: Sequence[torch.Tensor],
    w: int,
    *,
    columns: Sequence[str] | None = None,
    order_by: str | None = None,
    descending: bool = False,
    limit: int | None = None,
    with_payloads: Sequence[str] = (),
    touch: bool = True,
    active: torch.Tensor | None = None,
    plan: PL.Plan | None = None,
):
    """``w`` SELECTs of one shape, params as [w] tensors, in one pass of
    each kernel. Returns (state, result) with a leading w axis:

    result = {"count": [w], "rows": {col: [w, limit]}, "present":
              [w, limit], "row_ids": [w, limit], "payloads": {name:
              [w, limit, *shape]}}

    ``active`` ([w] bool) no-ops statements (count 0, nothing present, no
    touch). ``touch`` stamps ``_accessed`` on every matched row of every
    active statement (the batched daemon path passes False and touches
    the returned rows with :func:`batch_touch` instead)."""
    limit = schema.max_select if limit is None else min(limit,
                                                        schema.max_select)
    cap = schema.capacity
    now = state["clock"]
    accessed = state["cols"]["_accessed"]

    def finish_mask(mask, idx, present, count):
        if active is not None:
            count = torch.where(active, count, 0)
            present = present & active[:, None]
            mask = mask & active[:, None]
        acc = torch.where(mask.any(dim=0), now, accessed) if touch \
            else accessed
        return acc, idx.to(torch.int32), present, count

    def scan_route(r):
        fused = None
        if isinstance(r, PL.FusedScan):
            fused = _fused_scan(schema, state, r.scan, params_w, w,
                                limit=limit)
        if fused is not None:
            idx, present, mask, count = fused
        else:
            mask = _match_mask(schema, state, where, params_w, w)
            idx, present, count = _compact(mask, limit, cap)
        return finish_mask(mask, idx, present, count)

    def probe_route(r):
        safe, ok, count, ids = _probe_candidates(
            schema, state, r, params_w, w, active=active, limit=limit)
        acc = (_drop_scatter(accessed, torch.where(ok, safe, cap), now)
               if touch else accessed)
        return acc, ids, _present(count, limit), count

    if order_by is not None:
        # ranked reads stay on the scan path: the ranking needs the mask
        mask = _match_mask(schema, state, where, params_w, w)
        count = mask.sum(dim=1, dtype=torch.int32)
        key = state["cols"][order_by]
        if key.dtype.is_floating_point:
            key = key if descending else -key
            key = torch.where(mask, key, -torch.inf)
        else:
            # ~k = -k-1 flips an integer order without overflow at the min
            key = key if descending else ~key
            key = torch.where(mask, key, torch.iinfo(key.dtype).min)
        # the reference's top_k breaks ties toward lower row ids; a stable
        # descending sort does the same
        idx = torch.sort(key, dim=1, descending=True,
                         stable=True).indices[:, :limit]
        present = mask.gather(1, idx)
        acc, idx, present, count = finish_mask(mask, idx, present, count)
    else:
        route, forced = _route(schema, where, params_w, plan)
        if isinstance(route, PL.IndexProbe):
            if forced:
                acc, idx, present, count = probe_route(route)
            else:
                acc, idx, present, count = _select_fresh(
                    index_fresh(state, route.column), probe_route(route),
                    scan_route(route.fallback))
        else:
            acc, idx, present, count = scan_route(route)

    columns = tuple(columns) if columns is not None else schema.column_names
    gi = idx.long()
    rows = {c: state["cols"][c][gi] for c in columns}
    pls = {p: state["payloads"][p][gi] for p in with_payloads}
    if touch:
        state = dict(state, cols=dict(state["cols"], _accessed=acc))
    state = _tick(state)
    return state, {"count": count, "rows": rows, "present": present,
                   "row_ids": idx, "payloads": pls}


def select(
    schema: TableSchema,
    state: dict,
    where: P.Node | None,
    params: Sequence[Any] = (),
    *,
    columns: Sequence[str] | None = None,
    order_by: str | None = None,
    descending: bool = False,
    limit: int | None = None,
    with_payloads: Sequence[str] = (),
    touch: bool = True,
    active=None,
    plan: PL.Plan | None = None,
):
    """One SELECT (the reference's signature): :func:`select_many` at
    width 1. Returns (state, result) without the batch axis."""
    dev = state["valid"].device
    act = (None if active is None
           else to_device(active, dev, torch.bool).reshape(1))
    state, res = select_many(
        schema, state, where, _one(params, dev), 1, columns=columns,
        order_by=order_by, descending=descending, limit=limit,
        with_payloads=with_payloads, touch=touch, active=act, plan=plan)
    return state, {"count": res["count"][0],
                   "rows": {c: v[0] for c, v in res["rows"].items()},
                   "present": res["present"][0],
                   "row_ids": res["row_ids"][0],
                   "payloads": {k: v[0] for k, v in res["payloads"].items()}}


# ------------------------------------------------------------------ update

def update(
    schema: TableSchema,
    state: dict,
    where: P.Node | None,
    set_exprs: Mapping[str, P.Node],
    params: Sequence[Any] = (),
    *,
    extra_mask=None,
    plan: PL.Plan | None = None,
    maintain_indexes: bool = True,
):
    """UPDATE t SET col = expr ... WHERE pred. Returns (state, n_updated).
    The probe route evaluates SET expressions on the bucket's candidates
    only. An UPDATE that writes an indexed column rebuilds that index in
    the same call (``maintain_indexes=False`` defers it to the caller)."""
    cap = schema.capacity
    dev = state["valid"].device
    pw = _one(params, dev)
    p0 = tuple(p.reshape(()) for p in pw)
    set_items = [("_ttl" if name.upper() == "TTL" else name, expr)
                 for name, expr in set_exprs.items()]

    def new_values(expr, cols, dtype, n):
        v = P.eval_expr(expr, cols, p0)
        return torch.broadcast_to(to_device(v, dev, dtype), (n,))

    def scan_route(r):
        fused = None
        if isinstance(r, PL.FusedScan):
            fused = _fused_scan(schema, state, r.scan, pw, 1, limit=1,
                                want_ids=False)
        if fused is not None:
            mask, n = fused[2][0], fused[3][0]   # the scan's own count
        else:
            mask = _match_mask(schema, state, where, pw, 1)[0]
            n = None
        if extra_mask is not None:
            mask = mask & to_device(extra_mask, dev, torch.bool)
            n = None
        cols = dict(state["cols"])
        for tgt, expr in set_items:
            newv = new_values(expr, state["cols"], cols[tgt].dtype, cap)
            cols[tgt] = torch.where(mask, newv, cols[tgt])
        return cols, mask.sum(dtype=torch.int32) if n is None else n

    def probe_route(r):
        safe, ok, n, _ = _probe_candidates(schema, state, r, pw, 1,
                                           extra_mask=extra_mask)
        safe, ok = safe[0], ok[0]
        gathered = {c: v[safe] for c, v in state["cols"].items()}
        tgt_rows = torch.where(ok, safe, cap)
        cols = dict(state["cols"])
        for tgt, expr in set_items:
            newv = new_values(expr, gathered, cols[tgt].dtype,
                              safe.shape[0])
            cols[tgt] = _drop_scatter(cols[tgt], tgt_rows, newv)
        return cols, n[0]

    route, forced = _route(schema, where, pw, plan)
    if isinstance(route, PL.IndexProbe):
        if forced:
            cols, n = probe_route(route)
        else:
            cols, n = _select_fresh(index_fresh(state, route.column),
                                    probe_route(route),
                                    scan_route(route.fallback))
    else:
        cols, n = scan_route(route)
    state = dict(state, cols=cols)
    if maintain_indexes and schema.indexes:
        written = {tgt for tgt, _ in set_items}
        for ixc in schema.indexes:
            if ixc in written:
                state = build_index(schema, state, ixc)
    state = _tick(state)
    return state, n


# ------------------------------------------------------------------ delete

def _delete_core(schema, state, where, params, *, want_ids, limit,
                 extra_mask=None, plan=None):
    """Shared DELETE executor: (valid', n, ids, present); ids and present
    are zeros when ``want_ids`` is False. The probe route flips only the
    candidate rows' validity bits."""
    cap = schema.capacity
    dev = state["valid"].device
    pw = _one(params, dev)
    no_ids = (torch.zeros((limit,), dtype=torch.int32, device=dev),
              torch.zeros((limit,), dtype=torch.bool, device=dev))

    def scan_route(r):
        # ids must reflect the FINAL (extra_mask-gated) match, so the
        # kernel's compaction serves them only without an extra_mask
        kernel_ids = want_ids and extra_mask is None
        fused = None
        if isinstance(r, PL.FusedScan):
            fused = _fused_scan(schema, state, r.scan, pw, 1, limit=limit,
                                want_ids=kernel_ids)
        if fused is not None:
            ids, present, mask, n = fused
            mask, n = mask[0], n[0]   # the scan's own count
            if ids is not None:
                ids, present = ids[0], present[0]
        else:
            mask = _match_mask(schema, state, where, pw, 1)[0]
            ids = present = n = None
        if extra_mask is not None:
            mask = mask & to_device(extra_mask, dev, torch.bool)
            n = None
        if want_ids and ids is None:
            ids, present, n = _compact(mask[None], limit, cap)
            ids, present, n = ids[0], present[0], n[0]
        elif n is None:
            n = mask.sum(dtype=torch.int32)
        if not want_ids:
            ids, present = no_ids
        return state["valid"] & ~mask, n, ids, present

    def probe_route(r):
        safe, ok, n, ids = _probe_candidates(
            schema, state, r, pw, 1, extra_mask=extra_mask,
            limit=limit if want_ids else 0)
        valid = _drop_scatter(state["valid"], torch.where(ok, safe, cap),
                              False)
        if want_ids:
            ids, present = ids[0], _present(n, limit)[0]
        else:
            ids, present = no_ids
        return valid, n[0], ids, present

    route, forced = _route(schema, where, pw, plan)
    if isinstance(route, PL.IndexProbe):
        if forced:
            return probe_route(route)
        return _select_fresh(index_fresh(state, route.column),
                             probe_route(route), scan_route(route.fallback))
    return scan_route(route)


def delete(schema: TableSchema, state: dict, where: P.Node | None,
           params: Sequence[Any] = (), *, extra_mask=None,
           plan: PL.Plan | None = None):
    """DELETE FROM t WHERE pred: flips validity bits only; payload bytes
    never move. Hash indexes need no maintenance: dead entries are masked
    by the validity gather at probe time."""
    valid, n, _, _ = _delete_core(schema, state, where, params,
                                  want_ids=False, limit=1,
                                  extra_mask=extra_mask, plan=plan)
    return _tick(dict(state, valid=valid)), n


def delete_many_eq(schema: TableSchema, state: dict, column: str,
                   vals: torch.Tensor, active: torch.Tensor, *,
                   per_statement: bool = False):
    """One-pass multi-value equality DELETE (``repro.core.table.
    delete_many_eq``): flip every valid row whose ``column`` equals ANY
    active entry of ``vals``. The clock advances by the number of ACTIVE
    statements. ``per_statement=True`` also credits each deleted row to
    the EARLIEST statement carrying its value. Returns (state, n) or
    (state, n, counts [w])."""
    w = vals.shape[0]
    dev = state["valid"].device
    sentinel = torch.iinfo(torch.int32).max
    act = active.to(torch.bool)
    keyed = torch.where(act, vals.to(torch.int32), sentinel)
    n_act = act.sum(dtype=torch.int32)
    col = state["cols"][column]
    valid = state["valid"]
    ns = None
    if per_statement and w <= _EQ_DIRECT_MAX:
        # narrow batches claim rows statement by statement; inactive
        # lanes are gated explicitly (their sentinel could match INT32_MAX)
        remaining = valid
        parts = []
        for i in range(w):
            m = remaining & (col == keyed[i]) & act[i]
            parts.append(m.sum(dtype=torch.int32))
            remaining = remaining & ~m
        hit = valid & ~remaining
        ns = torch.stack(parts)
    elif w <= _EQ_DIRECT_MAX:
        hit = valid & ((col[None, :] == keyed[:, None]) & act[:, None]).any(0)
    else:
        sv, order = torch.sort(keyed, stable=True)
        pos = torch.searchsorted(sv, col).clamp(0, w - 1)
        hit = valid & (sv[pos] == col) & (pos < n_act)
        if per_statement:
            # searchsorted('left') lands every row on the FIRST lane of its
            # value's run = the earliest statement with that value
            ns = torch.zeros((w + 1,), dtype=torch.int32, device=dev)
            ns.scatter_add_(0, torch.where(hit, order[pos], w),
                            hit.to(torch.int32))
            ns = ns[:w]
    n = hit.sum(dtype=torch.int32)
    state = _tick(dict(state, valid=valid & ~hit), n_act)
    if not per_statement:
        return state, n
    return state, n, ns


def delete_returning(schema: TableSchema, state: dict, where: P.Node | None,
                     params: Sequence[Any] = (), *, limit: int | None = None,
                     plan: PL.Plan | None = None):
    """DELETE that also reports which rows went: (state, n, row_ids
    [limit], present [limit])."""
    limit = schema.max_select if limit is None else limit
    valid, n, ids, present = _delete_core(schema, state, where, params,
                                          want_ids=True, limit=limit,
                                          plan=plan)
    return _tick(dict(state, valid=valid)), n, ids, present


# --------------------------------------------------------------- aggregate

def _reduce(agg: str, v: torch.Tensor | None, m: torch.Tensor):
    """COUNT/SUM/MIN/MAX/AVG over the last axis, with the reference's
    result dtypes: integer sums stay int32 and wrap."""
    if agg == "COUNT" or v is None:
        return m.sum(dim=-1, dtype=torch.int32)
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    flt = v.dtype.is_floating_point
    if agg == "SUM":
        s = torch.where(m, v, 0)
        return s.sum(dim=-1) if flt else s.sum(dim=-1, dtype=v.dtype)
    if agg == "MIN":
        fill = torch.inf if flt else torch.iinfo(v.dtype).max
        return torch.where(m, v, fill).amin(dim=-1).to(v.dtype)
    if agg == "MAX":
        fill = -torch.inf if flt else torch.iinfo(v.dtype).min
        return torch.where(m, v, fill).amax(dim=-1).to(v.dtype)
    if agg == "AVG":
        s = torch.where(m, v.to(torch.float32), 0.0).sum(dim=-1)
        return s / m.sum(dim=-1, dtype=torch.int32).clamp(min=1)
    raise ValueError(f"unknown aggregate {agg!r}")


def aggregate_many(schema: TableSchema, state: dict, agg: str,
                   column: str | None, where: P.Node | None, params_w,
                   w: int, *, plan: PL.Plan | None = None):
    """``w`` aggregates of one shape (params [w]). Returns (state,
    values [w]); an indexed eq WHERE aggregates over one bucket's
    candidates per statement."""
    agg = agg.upper()
    vals = state["cols"][column] if column is not None else None

    def scan_route(r):
        fused = None
        if isinstance(r, PL.FusedScan):
            fused = _fused_scan(schema, state, r.scan, params_w, w, limit=1,
                                want_ids=False)
        if fused is not None and (agg == "COUNT" or vals is None):
            return fused[3]   # the scan's own count
        mask = (fused[2] if fused is not None
                else _match_mask(schema, state, where, params_w, w))
        return _reduce(agg, vals, mask)

    def probe_route(r):
        safe, ok, count, _ = _probe_candidates(schema, state, r, params_w, w)
        if agg == "COUNT" or vals is None:
            return count
        return _reduce(agg, vals[safe], ok)

    route, forced = _route(schema, where, params_w, plan)
    if isinstance(route, PL.IndexProbe):
        if forced:
            out = probe_route(route)
        else:
            out = _select_fresh(index_fresh(state, route.column),
                                probe_route(route),
                                scan_route(route.fallback))
    else:
        out = scan_route(route)
    return _tick(state), out


def aggregate(schema: TableSchema, state: dict, agg: str, column: str | None,
              where: P.Node | None, params: Sequence[Any] = (), *,
              plan: PL.Plan | None = None):
    """One aggregate (the reference's signature). Returns (state, value)."""
    state, out = aggregate_many(schema, state, agg, column, where,
                                _one(params, state["valid"].device), 1,
                                plan=plan)
    return state, out[0]


# ------------------------------------------------------- expiry and upkeep

def expire(schema: TableSchema, state: dict):
    """Automatic expiry, the paper's §4.3 conditions 1 (age) and 2 (rows).
    Condition 3 (op count) is the daemon's trigger. Returns (state,
    n_expired)."""
    pol = schema.expiry
    valid = state["valid"]
    cols = state["cols"]
    now = state["clock"]
    cap = schema.capacity

    # 1. data age: per-row _ttl overrides the table default
    ttl_eff = torch.where(cols["_ttl"] > 0, cols["_ttl"], pol.ttl)
    aged = (ttl_eff > 0) & ((now - cols["_created"]) > ttl_eff)
    expired = valid & aged

    # 2. row-count cap: keep the newest max_rows, ranking rows by
    # (created, row id) with one stable sort
    if 0 < pol.max_rows < cap:
        live = valid & ~expired
        order = torch.sort(cols["_created"], stable=True).indices
        live_in_rank = live.to(torch.int32)[order]
        cum = torch.cumsum(live_in_rank, dim=0, dtype=torch.int32) \
            - live_in_rank
        older_live = torch.zeros((cap,), dtype=torch.int32,
                                 device=valid.device).scatter(0, order, cum)
        n_live = live.sum(dtype=torch.int32)
        younger = n_live - older_live - 1
        expired = expired | (live & (younger >= pol.max_rows))

    n = expired.sum(dtype=torch.int32)
    return _tick(dict(state, valid=valid & ~expired)), n


def flush(schema: TableSchema, state: dict):
    """Drop every row. Hash indexes reset to empty (trivially exact), so
    FLUSH also recovers a stale index."""
    n = state["valid"].sum(dtype=torch.int32)
    state = dict(state, valid=torch.zeros_like(state["valid"]))
    if schema.indexes:
        nb = HX.n_buckets_for(schema.capacity)
        state["indexes"] = {c: HX.empty_index(nb, state["valid"].device)
                            for c in schema.indexes}
    return _tick(state), n


def live_count(state: dict) -> torch.Tensor:
    return state["valid"].sum(dtype=torch.int32)


def batch_touch(schema: TableSchema, state: dict, res: dict,
                active: torch.Tensor) -> dict:
    """Epilogue of the daemon's batched SELECT: touch the RETURNED rows
    and advance the clock by the active statement count (padding must
    not age TTLs)."""
    now = state["clock"]
    tgt = torch.where(res["present"], res["row_ids"], schema.capacity)
    cols = dict(state["cols"],
                _accessed=_drop_scatter(state["cols"]["_accessed"], tgt, now))
    nact = active.to(torch.bool).sum(dtype=torch.int32)
    return _tick(dict(state, cols=cols), nact)
