"""Query planner: lowers a parsed WHERE clause into an explicit plan IR
(port of ``repro.core.planner``; host Python, the same plans and the same
choices).

A WHERE lowers to exactly one of:

``IndexProbe``   an equality term on a hash-indexed column anchors the
                 statement: probe ONE bucket of the device-resident index
                 (kernels/hashidx), verify the remaining conjuncts on the
                 <= bucket_cap candidates. Carries a ``fallback`` scan plan;
                 executors select between the two on device when the index
                 is stale (bucket overflow), without a host sync.
``FusedScan``    a conjunction of <= 4 eq/range terms over int32 columns:
                 the fused relscan kernels (one pass: predicate x validity
                 x count, then the compaction to row ids).
``GenericScan``  everything else: the masked scan over
                 ``predicate.eval_predicate``.

Plans are frozen dataclasses; :func:`plan_where` is memoized per
(schema, where). A sharded table adds the layer above the plan:
:func:`plan_shards` lowers the WHERE to a :class:`ShardRoute` (pruned to
the shard of a partition-key equality, or fan-out to every shard).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import predicate as P
from repro_torch.core.schema import RESERVED_COLUMNS, SQL_TYPES, TableSchema

MAX_RESIDUAL = 8  # index-probe verification budget (terms beyond the key)


@dataclasses.dataclass(frozen=True)
class GenericScan:
    """Evaluate the WHERE with the generic masked scan."""

    reason: str = ""

    kind = "generic-scan"

    @property
    def columns(self) -> tuple[str, ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class FusedScan:
    """One fused relscan pass over the conjunction ``scan.terms``."""

    scan: P.FusedScan

    kind = "fused-scan"

    @property
    def columns(self) -> tuple[str, ...]:
        return self.scan.columns


@dataclasses.dataclass(frozen=True)
class IndexProbe:
    """Probe the hash index of ``column`` with the key term's value and
    verify ``residual`` on the candidates. ``fallback`` is the scan plan
    executors cond onto when the index is stale."""

    column: str
    key: P.FusedTerm                      # the anchoring `col == value`
    residual: tuple[P.FusedTerm, ...]     # remaining conjuncts
    fallback: "FusedScan | GenericScan"

    kind = "index-probe"

    @property
    def columns(self) -> tuple[str, ...]:
        return (self.column,) + tuple(t.col for t in self.residual)


Plan = IndexProbe | FusedScan | GenericScan


@dataclasses.dataclass(frozen=True)
class ShardRoute:
    """Shard routing for one WHERE against a sharded table (the layer
    ABOVE the Plan IR): ``key`` is the equality term on the partition
    column when the statement prunes to the one shard holding that key's
    hash (None = fan-out across all ``n_shards``). The within-shard
    execution still follows a :data:`Plan` (``plan_where``)."""

    column: str                    # the partition column
    key: P.FusedTerm | None        # eq term on it, None -> fan-out
    n_shards: int

    @property
    def pruned(self) -> bool:
        return self.key is not None

    @property
    def kind(self) -> str:
        return "pruned" if self.pruned else f"fan-out x {self.n_shards}"


def int_columns(schema: TableSchema) -> frozenset:
    """The relscan/hashidx-eligible column set: int32-typed user columns
    (INT and interned TEXT) plus the reserved clock columns."""
    return frozenset(
        c.name for c in schema.columns
        if np.dtype(SQL_TYPES[c.sql_type.upper()]) == np.int32
    ) | frozenset(RESERVED_COLUMNS)


@functools.lru_cache(maxsize=4096)
def plan_where(schema: TableSchema, where: P.Node | None,
               ranked: bool = False) -> Plan:
    """Lower ``where`` to a Plan for ``schema`` (memoized: the
    prepared-statement planner cache). ``ranked`` marks an ORDER BY
    statement: ranked reads need the full match mask for ``top_k``, so
    they always scan — the rule lives HERE so the executors, the batched
    routing and EXPLAIN can't drift apart."""
    if ranked:
        return GenericScan("ORDER BY requires the ranked scan")
    if where is None:
        # match-all: one tensor op, nothing to fuse or probe
        return GenericScan("no WHERE")
    ints = int_columns(schema)
    fused = P.classify_fusable(where, ints, max_terms=1 + MAX_RESIDUAL)
    if fused is None:
        return GenericScan("not a fusable conjunction")
    small = fused if len(fused.terms) <= 4 else None
    key = next((t for t in fused.terms
                if t.op == "==" and t.col in schema.indexes), None)
    if key is not None:
        residual = tuple(t for t in fused.terms if t is not key)
        fb = (FusedScan(small) if small is not None
              else GenericScan("conjunction exceeds the 4-term kernel"))
        return IndexProbe(key.col, key, residual, fb)
    if small is not None:
        return FusedScan(small)
    return GenericScan("conjunction exceeds the 4-term kernel")


def _coerce_int_literals(node: P.Node | None) -> P.Node | None:
    """Numerically integral float literals coerced to int for ROUTING
    only: an int32 partition column compared with ``5.0`` matches exactly
    the rows ``5`` matches, so the route may hash the int; the
    within-shard predicate keeps the original literal. Other floats stay:
    they match nothing on an int column, and any route is right for an
    empty result."""
    def coerce(v):
        if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 31:
            return int(v)
        return v

    return P.map_consts(node, coerce)


@functools.lru_cache(maxsize=4096)
def plan_shards(schema: TableSchema, where: P.Node | None) -> ShardRoute:
    """Lower ``where`` to a ShardRoute for a sharded ``schema`` (memoized
    like :func:`plan_where`). A statement prunes iff a top-level equality
    conjunct anchors the partition column; ranges on it, ORs and no WHERE
    visit every shard. The shard itself is computed from the bound value
    at execution time, so batched statements route one by one."""
    col = schema.partition_by
    n = schema.shards
    if where is None or col is None:
        return ShardRoute(col or "", None, n)
    fused = P.classify_fusable(_coerce_int_literals(where), int_columns(schema),
                               max_terms=1 + MAX_RESIDUAL)
    key = None
    if fused is not None:
        key = next((t for t in fused.terms if t.op == "==" and t.col == col),
                   None)
    return ShardRoute(col, key, n)


def as_fused(plan: Plan) -> P.FusedScan | None:
    """The P.FusedScan equivalent of ``plan`` when one exists (<= 4
    terms) — the shim behind ``table._fused_plan`` and the batched-DML
    eq-shape detection."""
    if isinstance(plan, FusedScan):
        return plan.scan
    if isinstance(plan, IndexProbe):
        terms = (plan.key,) + plan.residual
        if len(terms) <= 4:
            return P.FusedScan(terms)
    return None


def columns_of(node: P.Node | None) -> frozenset:
    """Every column name an expression/predicate AST touches."""
    out: set[str] = set()

    def walk(n):
        if n is None:
            return
        if isinstance(n, P.Col):
            out.add(n.name)
        elif isinstance(n, (P.BinOp, P.And, P.Or)):
            walk(n.left), walk(n.right)
        elif isinstance(n, P.Not):
            walk(n.child)
        elif isinstance(n, P.Between):
            walk(n.expr), walk(n.low), walk(n.high)
        elif isinstance(n, P.InList):
            walk(n.expr)
            for i in n.items:
                walk(i)
        elif isinstance(n, P.Func):
            for a in n.args:
                walk(a)

    walk(node)
    return frozenset(out)


def explain(schema: TableSchema, where: P.Node | None,
            ranked: bool = False) -> dict:
    """EXPLAIN payload for one WHERE clause against ``schema``: the chosen
    plan, the columns it reads, (for probes) the fallback, and (for
    sharded tables) the shard route: ``pruned -> shard k`` when the key is
    a constant, ``pruned`` when it binds a ``?``, ``fan-out x n``
    otherwise."""
    plan = plan_where(schema, where, ranked)
    out = {"plan": plan.kind, "table": schema.name,
           "columns": sorted(columns_of(where))}
    if isinstance(plan, IndexProbe):
        out["index"] = plan.column
        out["residual"] = sorted(t.col for t in plan.residual)
        out["fallback"] = plan.fallback.kind
    elif isinstance(plan, FusedScan):
        out["terms"] = [f"{t.col} {t.op}" for t in plan.scan.terms]
    elif plan.reason:
        out["reason"] = plan.reason
    if schema.shards > 1:
        from repro_torch.core import shards as SH  # shards imports planner

        route = plan_shards(schema, where)
        out["shards"] = schema.shards
        out["partition_by"] = route.column
        if route.pruned:
            kind, v = route.key.value
            out["shard_route"] = (f"pruned -> shard "
                                  f"{SH.shard_of_host(int(v), schema.shards)}"
                                  if kind == "const" else "pruned")
        else:
            out["shard_route"] = route.kind
    return out
