"""SQLCached: the cache daemon object (port of ``repro.core.daemon``, for
single-node monolithic tables).

Clients speak a subset of SQL (``execute`` / ``executemany``, or over TCP
through ``core/protocol.py``). Statements are parsed once and planned once
(``core/planner``); each statement shape gets one executor, a Python
closure kept in its table's executor cache (``core/execache.py``), which
pre-plans it: on the card each shape (and type class of its bound values)
is captured once as a CUDA graph and every later dispatch replays it. TEXT
values are interned on the host to int32 ids and turned back into strings
in results. A table's state lives on the daemon's device as a dict of
tensors (``core/table.py``) that keep their addresses: every statement
writes its new state into them in place (a captured graph reads and
writes fixed addresses), and only REINDEX bumps the cache's epoch.

Devices are explicit: ``SQLCached()`` runs on ``"cuda"`` and raises when
no CUDA device is present; ``SQLCached(device="cpu")`` runs every kernel's
plain version on the CPU (the tests do). Kernels are chosen by the device
of their tensors, never by a switch.

Sync-free execution: ``execute`` / ``executemany`` never wait for the
device. Every dispatch returns a lazy :class:`Result` whose device outputs
reach the host on first access, in ONE device-to-host copy of all of them
(``_host_tree``); ``payloads`` and the ``*_device`` accessors never sync.
A Result reads its own copy of the statement's outputs (one
device-to-device copy after the replay), never table state.
``executemany`` runs W same-shape statements in one dispatch: SELECTs and
aggregates launch each kernel once for all W (``table.select_many`` /
``aggregate_many``), single-column eq DELETEs take one pass over the
table, other DELETEs one [W, capacity] mask; UPDATEs run in order, one
statement after another, because each must see the SETs before it.

The paper's third automatic expiry condition (every N cache operations)
is counted on the host (``_expire_flag``, one flag per dispatch, the
same cadence as the reference) and runs inside the same executor call.

Pre-planning (the reference's AOT executor cache): ``CREATE TABLE`` starts
a background warm-up of the table's canonical hot shapes (``warmup=``,
default from ``REPRO_WARMUP``; ``drain_warmup()`` joins it), ``WARMUP t
[LIKE '<stmt>']`` plans shapes synchronously, ``EXPLAIN`` reports
``preplanned``, ``SHOW STATS`` the ``executors`` block, and the batch
scheduler keeps cold groups out of warm waves (:meth:`SQLCached.group_warm`).
Warm-up ticks no clock and no op count and never touches table contents.

Not in this port yet, and refused with ``SQLError``: ``SHARDS n>1`` /
``PARTITION BY``, ``ALTER TABLE ... RESHARD`` / ``RETAIN SLOTS`` and
``CHECKPOINT`` / ``RESTORE``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import planner as PL
from repro_torch.core import predicate as P
from repro_torch.core import sqlparse as S
from repro_torch.core import table as T
from repro_torch.core import telemetry as TEL
from repro_torch.core.execache import ExecutorCache
from repro_torch.core.schema import ExpiryPolicy, TableSchema, make_schema
from repro_torch.lint import lockorder as LK


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA request without a card is an
    error (no silent fall-back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("SQLCached: no CUDA device is present (pass "
                               "device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Interner:
    """Host-side string<->id map (TEXT columns / params). ``intern`` is
    locked: the batch scheduler dispatches disjoint-footprint statement
    groups concurrently, and a string must never receive two ids."""

    def __init__(self):
        self._fwd: dict[str, int] = {}
        self._rev: list[str] = [""]  # id 0 = empty/NULL
        self._lock = LK.make_lock("daemon.interner")

    def intern(self, s: str) -> int:
        i = self._fwd.get(s)
        if i is None:
            with self._lock:
                i = self._fwd.get(s)
                if i is None:
                    i = len(self._rev)
                    # append FIRST: the fast-path read above is lock-free
                    self._rev.append(s)
                    self._fwd[s] = i
        return i

    def lookup(self, i: int) -> str:
        if 0 <= i < len(self._rev):
            return self._rev[i]
        return f"<unknown:{i}>"


_UNSET = object()


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _packed(leaves: list) -> bool:
    """Do these card tensors lie in one small buffer (a statement's packed
    outputs), so that copying the buffer whole copies at most 4 KB more
    than them and their alignment gaps?"""
    if not leaves or leaves[0].device.type == "cpu":
        return False
    ptr = leaves[0].untyped_storage().data_ptr()
    need = 0
    for t in leaves:
        if t.untyped_storage().data_ptr() != ptr or not t.is_contiguous():
            return False
        need += -(-t.numel() * t.element_size() // 16) * 16
    return leaves[0].untyped_storage().nbytes() <= need + 4096


def _host_tree(tree: dict) -> dict:
    """Numpy copy of a nested dict of tensors. Tensors on a card travel in
    ONE device-to-host copy: a statement's outputs are views of one packed
    buffer (``core/execache.py``), which is copied whole; other tensors
    are concatenated on the device first. The host cuts the bytes apart."""
    leaves: list[torch.Tensor] = []

    def collect(x):
        if isinstance(x, dict):
            return {k: collect(v) for k, v in x.items()}
        leaves.append(x)
        return len(leaves) - 1

    skel = collect(tree)
    if _packed(leaves):
        st = leaves[0].untyped_storage()
        buf = torch.empty(0, dtype=torch.uint8, device=leaves[0].device) \
            .set_(st).cpu().numpy()
        arrays = []
        for t in leaves:
            off = t.storage_offset() * t.element_size()
            arrays.append(buf[off:off + t.numel() * t.element_size()]
                          .view(_np_dtype(t.dtype)).reshape(tuple(t.shape)))
    elif any(t.device.type != "cpu" for t in leaves):
        flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
        buf = torch.cat(flat).cpu().numpy()
        arrays, off = [], 0
        for t in leaves:
            nbytes = t.numel() * t.element_size()
            arrays.append(buf[off:off + nbytes].view(_np_dtype(t.dtype))
                          .reshape(tuple(t.shape)))
            off += nbytes
    else:
        arrays = [t.numpy() for t in leaves]

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        return arrays[x]

    return fill(skel)


class _HostStack:
    """One device->host transfer shared by every Result of a micro-batched
    statement: the per-statement Results are index views into the stacked
    [batch, ...] outputs. Thread-safe: the protocol layer's flushers may
    materialize sibling Results of one batch concurrently."""

    __slots__ = ("dev", "_np", "_lock")

    def __init__(self, dev: dict):
        self.dev = dev
        self._np = None
        self._lock = LK.make_lock("daemon.hoststack")

    def host(self) -> dict:
        if self._np is None:
            with self._lock:
                if self._np is None:
                    self._np = _host_tree(self.dev)
        return self._np


class Result:
    """Lazy result of one statement (the reference's contract).

    Reading ``count``, ``rows``, ``arrays``, ``row_ids`` or ``value``
    forces (and caches) the device->host transfer of every device output
    at once; ``payloads``, ``row_ids_device``, ``count_device``,
    ``present_device`` and ``value_device`` return device tensors with no
    sync. A Result built from host values (``Result(count=3)``) behaves
    like an eager record."""

    __slots__ = ("_count", "_rows", "_arrays", "_payloads", "_row_ids",
                 "_value", "_dev", "_ctx")

    def __init__(self, count: int = 0, rows=None, arrays=None, payloads=None,
                 row_ids=None, value: Any = None, *, dev: dict | None = None,
                 ctx: dict | None = None):
        self._dev = dev or {}
        self._ctx = ctx or {}
        if self._dev and "stack" not in self._ctx:
            self._ctx = dict(self._ctx, stack=_HostStack(self._dev),
                             index=None)
        self._count = _UNSET if self._lazy("count") else count
        self._rows = rows
        self._arrays = arrays
        self._payloads = payloads
        self._row_ids = _UNSET if self._lazy("row_ids") else row_ids
        self._value = _UNSET if self._lazy("value") else value

    def _lazy(self, name: str) -> bool:
        stack = self._ctx.get("stack")
        return stack is not None and name in stack.dev

    def _host(self, name: str):
        """Host view of a lazy device output (stack-aware)."""
        out = self._ctx["stack"].host()[name]
        i = self._ctx["index"]
        if i is None:
            return out
        if isinstance(out, dict):
            return {k: v[i] for k, v in out.items()}
        return out[i]

    # ------------------------------------------------- lazy host accessors
    @property
    def count(self) -> int:
        if self._count is _UNSET:
            self._count = int(self._host("count"))
        return self._count

    @property
    def value(self) -> Any:
        if self._value is _UNSET:
            self._value = self._host("value").item()
        return self._value

    def _shown(self) -> int:
        n = self._ctx.get("nshow")
        if n is None:
            n = min(self.count, self._ctx.get("limit", self.count))
        return n

    @property
    def row_ids(self) -> np.ndarray | None:
        if self._row_ids is _UNSET:
            self._row_ids = self._host("row_ids")[: self._shown()]
        return self._row_ids

    def _materialize_rows(self) -> None:
        if self._arrays is not None or not self._lazy("rows"):
            return
        shown = self._shown()
        present = self._host("present")
        columns = self._ctx["columns"]
        interner = self._ctx["interner"]
        text_cols = self._ctx["text_cols"]
        host_rows = self._host("rows")
        arrays = {c: host_rows[c][:shown] for c in columns}
        rows = []
        for i in range(shown):
            if not present[i]:
                continue
            row = {}
            for c in columns:
                v = arrays[c][i].item()
                if c in text_cols:
                    v = interner.lookup(int(v))
                row[c] = v
            rows.append(row)
        self._arrays, self._rows = arrays, rows

    @property
    def rows(self) -> list[dict] | None:
        self._materialize_rows()
        return self._rows

    @property
    def arrays(self) -> dict[str, np.ndarray] | None:
        self._materialize_rows()
        return self._arrays

    @property
    def payloads(self) -> dict[str, torch.Tensor] | None:
        if self._payloads is None and "payload_stack" in self._ctx:
            i = self._ctx["index"]
            self._payloads = {k: v[i]
                              for k, v in self._ctx["payload_stack"].items()}
        return self._payloads

    # --------------------------------------------- zero-sync device access
    @property
    def count_device(self):
        return self._dev.get("count", self._count)

    @property
    def row_ids_device(self):
        ids = self._dev.get("row_ids")
        return ids if ids is not None else (
            None if self._row_ids is _UNSET else self._row_ids)

    @property
    def present_device(self):
        return self._dev.get("present")

    @property
    def value_device(self):
        return self._dev.get("value", None if self._value is _UNSET
                             else self._value)

    def __repr__(self):  # never forces a sync in debuggers/logs
        stack = self._ctx.get("stack")
        lazy = ",".join(sorted(stack.dev)) if stack is not None else "-"
        return f"Result(lazy=[{lazy}])"


@dataclasses.dataclass
class _Table:
    """One live table: its schema, its device state (a dict of tensors,
    ``core/table.py`` layout, whose tensors keep their addresses), its
    executor cache and its host-side bookkeeping."""

    schema: TableSchema
    state: dict
    host_ops: int = 0
    lock: Any = dataclasses.field(default_factory=threading.Lock)
    execs: ExecutorCache = dataclasses.field(default_factory=ExecutorCache)
    stmt_routed: Any = None
    writes_routed: Any = None
    rows_in: Any = None


@dataclasses.dataclass(frozen=True)
class StatementShape:
    """Grouping descriptor for one SQL text (see :meth:`SQLCached.shape_key`).

    ``key`` is hashable and equal exactly when two statements can ride the
    same batched executor. ``batchable`` marks shapes ``executemany``
    accepts; ``is_write`` drives the scheduler's read/write barriers;
    ``reads`` / ``writes`` are column footprints (``None`` = the whole
    table)."""

    key: tuple
    table: str | None
    kind: str  # "select" | "insert" | "delete" | "update" | "admin" | ...
    batchable: bool
    is_write: bool
    reads: frozenset | None = None
    writes: frozenset | None = None


def _bucket(n: int) -> int:
    """Pad batch sizes to powers of two (one executor per bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _np_terms_int(terms, param_cols) -> bool:
    """Host-side dtype gate for the batched probe route: every `?`-bound
    term value must be integer."""
    for t in terms:
        kind, v = t.value
        if kind == "param" and not np.issubdtype(param_cols[v].dtype,
                                                 np.integer):
            return False
    return True


_UNSUPPORTED = {
    S.AlterReshard: "ALTER TABLE ... RESHARD",
    S.AlterRetain: "ALTER TABLE ... RETAIN SLOTS",
    S.Checkpoint: "CHECKPOINT",
    S.Restore: "RESTORE",
}


class SQLCached:
    def __init__(self, auto_expire: bool = True,
                 slow_ms: float | None = None, *, warmup: bool | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.tables: dict[str, _Table] = {}
        self.interner = Interner()
        # serving telemetry (core/telemetry.py): trace spans, latency
        # histograms, slow-statement ring
        self.telemetry = TEL.Telemetry(slow_ms=slow_ms)
        self.auto_expire = auto_expire
        # warmup=None defers to REPRO_WARMUP (default on): CREATE TABLE
        # pre-plans the canonical hot shapes in a background thread; the
        # WARMUP statement works regardless
        if warmup is None:
            warmup = os.environ.get("REPRO_WARMUP", "1") != "0"
        self.warmup = warmup
        self._warm_threads: dict[str, threading.Thread] = {}
        self._stmts: dict[str, S.Statement] = {}
        self._shapes: dict[str, StatementShape] = {}
        self._interned: dict[int, tuple] = {}

    # ------------------------------------------------------------- plumbing
    def _parse(self, sql: str) -> S.Statement:
        stmt = self._stmts.get(sql)
        if stmt is None:
            stmt = S.parse(sql)
            self._stmts[sql] = stmt
        return stmt

    def _table(self, name: str) -> _Table:
        t = self.tables.get(name)
        if t is None:
            raise S.SQLError(f"no such table {name!r}")
        return t

    def _intern_ast(self, node):
        """``node`` with its TEXT constants interned, memoized per parsed
        node (ids never change once given)."""
        hit = self._interned.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        out = P.map_consts(
            node, lambda v: self.interner.intern(v) if isinstance(v, str) else v
        )
        self._interned[id(node)] = (node, out)
        return out

    def _prep_params(self, params: Sequence[Any]) -> tuple:
        out = []
        for p in params:
            if isinstance(p, str):
                p = self.interner.intern(p)
            out.append(p)
        return tuple(out)

    def _param_cols(self, params_list, n: int, b: int, n_params: int):
        """Host [b]-columns of the bound values with the executors' 32-bit
        widths (rows past n repeat the last statement's, as padding). The
        executor cache stages them; executors see device tensors."""
        pm = [self._prep_params(params_list[min(i, n - 1)])
              for i in range(b)]
        return tuple(T.host_column([pm[i][j] for i in range(b)])
                     for j in range(n_params))

    @staticmethod
    def _host_params(params: tuple) -> tuple:
        """One statement's bound values as 0-d host arrays (staged by the
        executor cache, never turned into tensors inside an executor)."""
        return tuple(T.host_column(p) for p in params)

    def _executor(self, t: _Table, key: tuple, builder, expiry: bool = True):
        """The table's :class:`ExecEntry` for ``key`` under the current
        schema epoch (core/execache.py). An entry built through
        :meth:`_with_expiry` plans both expiry variants when the flag can
        fire."""
        fires = (expiry and self.auto_expire
                 and t.schema.expiry.ops_interval > 0)
        return t.execs.get(key, builder, (False, True) if fires else (False,))

    def _sig(self, t: _Table, stmt, kind: str, b) -> tuple:
        """The dispatch signature recorded in ``t.execs.sigs`` once a shape
        is planned: (kind, parsed stmt, bucket, mode, placement), the
        reference's shape; the port's tables are monolithic on one device.
        ``b`` is None on the singleton executors, the power-of-two bucket
        on the executemany family (INSERT always buckets)."""
        return (kind, stmt, b, "mono", ("dev", str(self.device)))

    def _note_sig(self, t: _Table, stmt, kind: str, b) -> None:
        t.execs.note_sig(self._sig(t, stmt, kind, b))

    def _finish_warm(self, t: _Table, entry, stmt, kind: str, b,
                     args: tuple) -> int:
        """Shared tail of every site's warm branch: plan the entry for
        these placeholder values and record the signature."""
        new = entry.warm(t.state, args)
        self._note_sig(t, stmt, kind, b)
        return int(new)

    def _with_expiry(self, schema: TableSchema, base):
        """Wrap ``base(state, *args) -> (state, *outs)`` with the §4.3
        op-count expiry: the flag is computed on the host before the
        dispatch (``_expire_flag``), so choosing the expiry is no device
        sync, and the expiry runs in the same executor call."""
        iv = schema.expiry.ops_interval

        def fn(state, expire_flag, *args):
            out = base(state, *args)
            if iv > 0 and expire_flag:
                out = (T.expire(schema, out[0])[0],) + tuple(out[1:])
            return out

        return fn

    def _expire_flag(self, t: _Table, n: int = 1) -> bool:
        """Paper §4.3 condition 3: expire every N cache operations. Counted
        host-side; ``n`` is the number of STATEMENTS the dispatch carries,
        so the cadence does not depend on how traffic was grouped (the
        flag fires once per crossed interval boundary)."""
        iv = t.schema.expiry.ops_interval
        with t.lock:
            before = t.host_ops
            t.host_ops += n
            return bool(self.auto_expire and iv > 0
                        and before // iv != t.host_ops // iv)

    def _run_state(self, t: _Table, fn, flag: bool, args: tuple):
        """Run an executor entry against the table's state, which it updates
        in place; ``args`` is a host tree of numpy arrays (the bound
        values). Returns the executor's other outputs, as fresh tensors."""
        TEL.note_mode("mono")
        return fn(t.state, flag, args)

    def _note_route(self, t: _Table, n: int, is_write: bool,
                    rows_in: int | None = None) -> None:
        """Statement counters of ``SHOW STATS t`` (one entry: the port's
        tables are monolithic)."""
        with t.lock:
            t.stmt_routed += n
            if is_write:
                t.writes_routed += n
            if rows_in is not None:
                t.rows_in += rows_in

    # ------------------------------------------- scheduler routing hooks
    def group_lane(self, shape, params_list) -> None:
        """Monolithic tables have no execution lanes."""
        return None

    def item_lanes(self, shape, params_list) -> None:
        return None

    def group_shard_ids(self, shape, params_list) -> None:
        return None

    # ----------------------------------------------------------- statements
    def execute(
        self,
        sql: str,
        params: Sequence[Any] = (),
        payloads: Mapping[str, Any] | None = None,
    ) -> Result:
        stmt = self._parse(sql)
        return self._dispatch_stmt(stmt, params, payloads)

    def _dispatch_stmt(
        self,
        stmt: S.Statement,
        params: Sequence[Any] = (),
        payloads: Mapping[str, Any] | None = None,
    ) -> Result:
        """Route one PARSED statement to its handler."""
        if isinstance(stmt, S.CreateTable):
            return self._do_create(stmt)
        if isinstance(stmt, S.DropTable):
            t = self.tables.pop(stmt.table, None)
            if t is not None:
                t.execs.close()
            return Result()
        if isinstance(stmt, S.Insert):
            return self._do_insert_batch(stmt, [tuple(params)],
                                         [payloads] if payloads else None)
        if isinstance(stmt, S.Select):
            return self._do_select(stmt, self._prep_params(params))
        if isinstance(stmt, S.Update):
            return self._do_update(stmt, self._prep_params(params))
        if isinstance(stmt, S.Delete):
            return self._do_delete(stmt, self._prep_params(params))
        if isinstance(stmt, S.Expire):
            return self._do_expire(stmt.table)
        if isinstance(stmt, S.Flush):
            return self._do_flush(stmt.table)
        if isinstance(stmt, S.Reindex):
            return self._do_reindex(stmt.table)
        if isinstance(stmt, S.ShowStats):
            return self._do_show_stats(stmt.table)
        if isinstance(stmt, S.ShowMetrics):
            return self._do_show_metrics(stmt)
        if isinstance(stmt, S.ShowSlow):
            return self._do_show_slow()
        if isinstance(stmt, S.Explain):
            return self._do_explain(stmt.inner)
        if isinstance(stmt, S.ExplainAnalyze):
            return self._do_explain_analyze(stmt, params)
        if isinstance(stmt, S.Warmup):
            return self._do_warmup(stmt)
        name = _UNSUPPORTED.get(type(stmt))
        if name is not None:
            raise S.SQLError(f"{name} is not supported by this port yet "
                             f"(single-node tables only)")
        raise S.SQLError(f"unhandled statement {stmt!r}")

    @staticmethod
    def _clean_footprint(cols) -> frozenset | None:
        """None (whole-table) when a footprint touches reserved columns."""
        fp = frozenset(cols)
        if any(c.startswith("_") for c in fp):
            return None
        return fp

    def shape_key(self, sql: str) -> StatementShape:
        """Classify ``sql`` for cross-connection batching (the scheduler's
        grouping hook); memoized per statement text. Raises ``SQLError``
        on bad SQL."""
        cached = self._shapes.get(sql)
        if cached is not None:
            return cached
        shape = self._shape_key_uncached(sql)
        self._shapes[sql] = shape
        return shape

    def _shape_key_uncached(self, sql: str) -> StatementShape:
        stmt = self._parse(sql)
        clean = self._clean_footprint
        if isinstance(stmt, S.Select):
            reads = set(PL.columns_of(stmt.where))
            if stmt.agg is not None:
                if stmt.agg[1] is not None:
                    reads.add(stmt.agg[1])
            elif stmt.columns:
                reads |= set(stmt.columns)
            else:
                # SELECT *: whole-table reads, from the statement TEXT
                # alone (the live schema may change under a queued DROP)
                reads = None
            if reads is not None and stmt.order_by is not None:
                reads.add(stmt.order_by)
            if reads is not None:
                reads |= set(stmt.payloads)
                reads = clean(reads)
            return StatementShape(("select", stmt), stmt.table, "select",
                                  True, False, reads, frozenset())
        if isinstance(stmt, S.Insert):
            return StatementShape(("insert", stmt), stmt.table, "insert",
                                  True, True, frozenset(), None)
        if isinstance(stmt, S.Delete):
            return StatementShape(("delete", stmt), stmt.table, "delete",
                                  True, True,
                                  clean(PL.columns_of(stmt.where)), None)
        if isinstance(stmt, S.Update):
            reads = set(PL.columns_of(stmt.where))
            writes = set()
            for col, expr in stmt.sets:
                writes.add("_ttl" if col.upper() == "TTL" else col)
                reads |= set(PL.columns_of(expr))
            return StatementShape(("update", stmt), stmt.table, "update",
                                  True, True, clean(reads), clean(writes))
        if isinstance(stmt, (S.Explain, S.ShowMetrics, S.ShowSlow)):
            return StatementShape(("explain", stmt), None, "explain",
                                  False, False, frozenset(), frozenset())
        if isinstance(stmt, S.ExplainAnalyze):
            return StatementShape(("admin", stmt),
                                  getattr(stmt.inner, "table", None),
                                  "admin", False, True)
        table = getattr(stmt, "table", None)
        return StatementShape(("admin", stmt), table, "admin", False, True)

    def execute_async(
        self,
        sql: str,
        params: Sequence[Any] = (),
        payloads: Mapping[str, Any] | None = None,
    ) -> Result:
        """``execute`` under its intent-revealing name (it never waits for
        the device either); ``drain()`` is the barrier."""
        return self.execute(sql, params, payloads)

    def drain(self, table: str | None = None) -> None:
        """Block until every enqueued device op has retired."""
        if table is not None:
            self._table(table)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _do_create(self, stmt: S.CreateTable) -> Result:
        from repro_torch.core.sqlparse import _PAYLOAD_DTYPES

        if stmt.shards > 1 or stmt.partition_by is not None:
            raise S.SQLError("SHARDS / PARTITION BY are not supported by "
                             "this port yet (single-node tables only)")
        schema = make_schema(
            stmt.table,
            list(stmt.columns),
            [(n, s, _PAYLOAD_DTYPES[d]) for (n, s, d) in stmt.payloads],
            capacity=stmt.capacity,
            max_select=stmt.max_select,
            expiry=ExpiryPolicy(stmt.ttl, stmt.max_rows, stmt.ops_interval),
            indexes=stmt.indexes,
            replicas=stmt.replicas,
        )
        old = self.tables.get(stmt.table)
        self.tables[stmt.table] = self._make_table(schema)
        if old is not None:
            old.execs.close()
        if self.warmup:
            # pre-plan the canonical hot shapes off the dispatch thread
            th = threading.Thread(target=self._warm_table_bg,
                                  args=(stmt.table,),
                                  name=f"warmup-{stmt.table}", daemon=True)
            self._warm_threads[stmt.table] = th
            th.start()
        return Result()

    def _make_table(self, schema: TableSchema) -> _Table:
        dev = self.device
        return _Table(schema, T.init_state(schema, dev),
                      lock=LK.make_lock(f"table:{schema.name}"),
                      execs=ExecutorCache(
                          dev, lambda: T.init_state(schema, dev)),
                      stmt_routed=np.zeros(1, np.int64),
                      writes_routed=np.zeros(1, np.int64),
                      rows_in=np.zeros(1, np.int64))

    def _run_admin(self, t: _Table, key: tuple, body):
        """An admin statement (FLUSH / EXPIRE / REINDEX) as an executor
        entry like any other: ``body(state) -> (state, *outs)``."""
        fn = self._executor(t, key + (t.schema,),
                            lambda: lambda st, flag: body(st),
                            expiry=False)
        return self._run_state(t, fn, False, ())

    def _do_reindex(self, name: str) -> Result:
        """REINDEX t: rebuild every hash index from the live rows (the
        recovery path after a bucket overflow). ``value`` is the residual
        overflow (0 = probes are back). Rebuilt indexes change probe
        behaviour for every cached plan, so the schema epoch is bumped
        first, as in the reference."""
        t = self._table(name)
        if not t.schema.indexes:
            return Result(count=0, value=0)
        t.execs.bump()
        self._run_admin(t, ("reindex",),
                        lambda st: (T.build_index(t.schema, st),))
        residual = sum(int(t.state["indexes"][c]["stale"])
                       for c in t.schema.indexes)
        return Result(count=len(t.schema.indexes), value=residual)

    def _do_flush(self, name: str) -> Result:
        """FLUSH keeps the schema epoch: it changes contents, not shapes,
        so every pre-planned executor stays valid."""
        t = self._table(name)
        n, = self._run_admin(t, ("flush",), lambda st: T.flush(t.schema, st))
        return Result(dev={"count": n})

    def _do_expire(self, name: str) -> Result:
        t = self._table(name)
        n, = self._run_admin(t, ("expire",),
                             lambda st: T.expire(t.schema, st))
        return Result(dev={"count": n})

    def _do_show_stats(self, name: str | None) -> Result:
        """SHOW STATS t (= ``EXPLAIN t``): live rows and statement counters
        as one JSON ``VALUE`` row; without a table, the daemon-wide
        roll-up."""
        if name is None:
            return self._do_show_stats_all()
        t = self._table(name)
        live = self.live_rows(name)
        with t.lock:
            stmts = t.stmt_routed.tolist()
            writes = t.writes_routed.tolist()
            rows_in = t.rows_in.tolist()
            host_ops = t.host_ops
        per = [{"shard": 0, "live_rows": live, "statements": stmts[0],
                "writes": writes[0], "inserted_rows": rows_in[0]}]
        info = {"table": name, "shards": 1, "devices": 1,
                "device": str(self.device),
                "replicas": t.schema.replicas,
                "partition_by": t.schema.partition_by,
                "capacity": t.schema.capacity,
                "shard_capacity": t.schema.capacity,
                "host_ops": host_ops,
                "executors": t.execs.stats_dict(),
                "per_shard": per}
        return Result(count=1, value=json.dumps(info, sort_keys=True))

    def _do_show_stats_all(self) -> Result:
        tables = {}
        exec_totals: dict[str, Any] = {"cached": 0, "entries": 0, "hits": 0,
                                       "misses": 0, "compiles": 0,
                                       "fallbacks": 0,
                                       "compile_ms_total": 0.0}
        for name, t in sorted(self.tables.items()):
            ed = t.execs.stats_dict()
            for k in exec_totals:
                exec_totals[k] += ed[k]
            tables[name] = {"shards": 1, "live_rows": self.live_rows(name),
                            "host_ops": t.host_ops}
        exec_totals["compile_ms_total"] = round(
            exec_totals["compile_ms_total"], 3)
        info = {"tables": tables,
                "executors": exec_totals,
                "device": str(self.device),
                "uptime_s": self.telemetry.uptime_s(),
                "telemetry": self.telemetry.enabled,
                "lockcheck": LK.summary(),
                **self.telemetry.sources()}
        return Result(count=len(tables),
                      value=json.dumps(info, sort_keys=True))

    def _do_show_metrics(self, stmt: S.ShowMetrics) -> Result:
        """SHOW METRICS [t] [FORMAT 'prom']: the serving-telemetry report
        (host counters only, never a device sync)."""
        if stmt.table is not None:
            self._table(stmt.table)
        rep = self.telemetry.report(stmt.table)
        if stmt.fmt == "prom":
            return Result(count=len(rep["shapes"]),
                          value=json.dumps(TEL.prom(rep)))
        return Result(count=len(rep["shapes"]),
                      value=json.dumps(rep, sort_keys=True))

    def _do_show_slow(self) -> Result:
        entries = [tr.to_dict() for tr in self.telemetry.slow_entries()]
        return Result(count=len(entries), rows=entries)

    def _do_explain_analyze(self, stmt: S.ExplainAnalyze,
                            params: Sequence[Any] = ()) -> Result:
        """EXPLAIN ANALYZE <stmt>: execute the inner statement (and
        materialize its result) and report its per-stage spans next to
        the plan."""
        amb = TEL.current_traces()
        tr = amb[0] if amb else TEL.Trace()
        try:
            plan = json.loads(self._do_explain(stmt.inner).value)
        except S.SQLError:
            plan = {"statement": type(stmt.inner).__name__.lower()}
        with TEL.dispatch_span([tr]):
            res = self._dispatch_stmt(stmt.inner, params)
            tr.mark("execute")
            count = res.count
            _ = res.rows
            _ = res.value
            tr.mark("render")
        info = {"analyze": True,
                "plan": plan,
                "stages": {k: round(v, 1)
                           for k, v in tr.stage_totals().items()},
                "total_us": round((tr.last - tr.t0) * 1e6, 1),
                "count": count}
        if tr.mode is not None:
            info["exec_mode"] = tr.mode
        if tr.cache is not None:
            info["cache"] = tr.cache
        if tr.group is not None:
            info["group"] = tr.group
        if tr.wave is not None:
            info["wave"] = tr.wave
        return Result(count=count, value=json.dumps(info, sort_keys=True))

    # -------------------------------------------------- executor warm-up
    def _warm_statement(self, t: _Table, stmt) -> int:
        """Pre-plan one statement's executor (monolithic tables have one
        placement). Returns the number of newly planned executables."""
        if isinstance(stmt, S.Insert):
            return self._do_insert_batch(stmt, [], None, _warm=True)
        if isinstance(stmt, S.Select):
            return self._do_select(stmt, (), _warm=True)
        if isinstance(stmt, S.Update):
            return self._do_update(stmt, (), _warm=True)
        if isinstance(stmt, S.Delete):
            return self._do_delete(stmt, (), _warm=True)
        raise S.SQLError("WARMUP supports SELECT/INSERT/UPDATE/DELETE shapes")

    def _canonical_warm_sqls(self, schema: TableSchema) -> list[str]:
        """The canonical hot shapes CREATE-time warm-up pre-plans: the
        full-row INSERT plus an eq-SELECT and eq-DELETE on the partition /
        index columns (the first column when there are none): the paper's
        GET / SET / DELETE triple."""
        cols = schema.column_names
        out = [f"INSERT INTO {schema.name} ({', '.join(cols)}) "
               f"VALUES ({', '.join('?' for _ in cols)})"]
        keys = [c for c in (schema.partition_by, *schema.indexes)
                if c is not None]
        if not keys and cols:
            keys = [cols[0]]
        for c in dict.fromkeys(keys):
            out.append(f"SELECT * FROM {schema.name} WHERE {c} = ?")
            out.append(f"DELETE FROM {schema.name} WHERE {c} = ?")
        return out

    def _do_warmup(self, stmt: S.Warmup) -> Result:
        """WARMUP t [LIKE '<stmt>']: synchronously pre-plan executors, the
        given statement's shape or the canonical hot set. ``count`` is the
        number of newly planned executables (0 = all were planned),
        ``value`` the schema epoch."""
        t = self._table(stmt.table)
        sqls = ([stmt.like] if stmt.like is not None
                else self._canonical_warm_sqls(t.schema))
        new = 0
        for sql in sqls:
            self.shape_key(sql)  # prime the scheduler's admission cache
            new += self._warm_statement(t, self._parse(sql))
        return Result(count=new, value=t.execs.epoch)

    def _warm_table_bg(self, name: str) -> None:
        """CREATE-time background warm-up of the canonical hot shapes, off
        the dispatch thread. Best effort: a statement that raced a DROP
        just stops; warm-up never takes serving down."""
        t = self.tables.get(name)
        if t is None:
            return
        for sql in self._canonical_warm_sqls(t.schema):
            if self.tables.get(name) is not t:
                return  # dropped or recreated under us
            try:
                self.shape_key(sql)
                self._warm_statement(t, self._parse(sql))
            except Exception:  # noqa: BLE001 — warm-up is best effort
                return

    def drain_warmup(self, table: str | None = None) -> None:
        """Join the CREATE-time background warm-up thread(s): callers start
        timing from a planned state."""
        for nm, th in list(self._warm_threads.items()):
            if table is None or nm == table:
                th.join()

    def group_warm(self, shape: StatementShape | None,
                   params_list: Sequence[Sequence[Any]]) -> bool:
        """Scheduler admission hook: will this group's dispatch replay an
        already-planned executable? A host-side signature lookup (never a
        device sync, never an op-count tick). Unknown shapes report warm:
        admin statements and unroutable groups must never serialize a
        wave."""
        if shape is None or shape.table is None or len(shape.key) != 2:
            return True
        if shape.kind not in ("select", "insert", "delete", "update"):
            return True
        t = self.tables.get(shape.table)
        if t is None:
            return True
        kind, stmt = shape.key
        n = len(params_list)
        try:
            if kind == "insert":
                b = min(_bucket(max(n, 1)), t.schema.capacity)
            else:
                b = _bucket(n) if n > 1 else None
            return t.execs.has_sig(self._sig(t, stmt, kind, b))
        except Exception:  # noqa: BLE001 — admission is best effort
            return True

    def _preplanned(self, t: _Table, stmt) -> bool:
        """EXPLAIN's ``preplanned`` bit: the statement's single-statement
        dispatch already has a planned executable (host signature set
        only, no device sync)."""
        kind = type(stmt).__name__.lower()
        b = 1 if kind == "insert" else None
        return t.execs.has_sig(self._sig(t, stmt, kind, b))

    def _do_explain(self, stmt: S.Statement) -> Result:
        """EXPLAIN <stmt>: report (don't run) the inner statement's plan
        as one VALUE row of JSON."""
        if isinstance(stmt, (S.Select, S.Update, S.Delete)):
            t = self._table(stmt.table)
            where = self._intern_ast(stmt.where)
            ranked = isinstance(stmt, S.Select) and stmt.order_by is not None
            info = PL.explain(t.schema, where, ranked=ranked)
            info["statement"] = type(stmt).__name__.lower()
            info["preplanned"] = self._preplanned(t, stmt)
            if info["plan"] == "index-probe":
                # stale > 0: every probe currently takes the scan fallback
                info["stale"] = int(
                    t.state["indexes"][info["index"]]["stale"])
            return Result(count=1, value=json.dumps(info, sort_keys=True))
        info = {"statement": type(stmt).__name__.lower(),
                "plan": "insert" if isinstance(stmt, S.Insert) else "admin"}
        table = getattr(stmt, "table", None)
        if table is not None:
            info["table"] = table
            t = self.tables.get(table)
            if t is not None and isinstance(stmt, S.Insert):
                info["preplanned"] = self._preplanned(t, stmt)
        return Result(count=1, value=json.dumps(info, sort_keys=True))

    def executemany(
        self,
        sql: str,
        params_list: Sequence[Sequence[Any]],
        payloads_list: Sequence[Mapping[str, Any]] | None = None,
        *,
        per_statement: bool = False,
    ) -> "Result | list[Result]":
        """One statement over many parameter rows, in ONE dispatch (rows
        padded to a power-of-two bucket).

        INSERT/DELETE/UPDATE return one aggregate :class:`Result`; SELECT
        (rows and aggregates) returns ``list[Result]``, one per row, all
        views into one stacked transfer. ``per_statement=True`` makes every
        kind return ``list[Result]`` with per-statement counts under
        sequential semantics."""
        stmt = self._parse(sql)
        if isinstance(stmt, (S.Delete, S.Update)):
            return self._do_batch_dml(stmt, params_list,
                                      per_statement=per_statement)
        if isinstance(stmt, S.Select):
            return self._do_batch_select(stmt, params_list)
        if not isinstance(stmt, S.Insert):
            raise S.SQLError("executemany supports INSERT/SELECT/DELETE/"
                             "UPDATE")
        return self._do_insert_batch(stmt, params_list, payloads_list,
                                     per_statement=per_statement)

    def _do_insert_batch(self, stmt: S.Insert,
                         params_list: Sequence[Sequence[Any]],
                         payloads_list=None, *,
                         per_statement: bool = False, _warm: bool = False
                         ) -> "Result | list[Result] | int":
        """The INSERT arm of :meth:`executemany` (single INSERTs come here
        as a batch of one). ``_warm=True`` pre-plans the b=1 executor from
        placeholder values instead of running (no clock tick, no op
        count; returns the number of new plans)."""
        t = self._table(stmt.table)
        schema = t.schema
        cols = stmt.columns or schema.column_names[: len(stmt.values)]
        if len(cols) != len(stmt.values):
            raise S.SQLError("INSERT column/value count mismatch")
        n_params = max((P.collect_params(v) for v in stmt.values), default=0)
        if stmt.ttl is not None:
            n_params = max(n_params, P.collect_params(stmt.ttl))
        if _warm:
            n = 1
            params_list = [(0,) * n_params]
        else:
            n = len(params_list)
            if n == 0:
                return [] if per_statement else Result(count=0)
        if n > schema.capacity:
            raise S.SQLError(f"INSERT of {n} rows exceeds CAPACITY "
                             f"{schema.capacity}")
        # the padded batch takes one slot a row, so it never outgrows the
        # table (padding rows are masked off)
        b = min(_bucket(n), schema.capacity)
        param_cols = self._param_cols(params_list, n, b, n_params)
        row_mask = np.arange(b) < n

        pl_args = {}
        for p in schema.payloads:
            if payloads_list and p.name in (payloads_list[0] or {}):
                arrs = [np.asarray(pl[p.name]) for pl in payloads_list]
                # stack rows (padding repeats the last one)
                pl_args[p.name] = np.stack(arrs + [arrs[-1]] * (b - n))

        values_ast = tuple(self._intern_ast(v) for v in stmt.values)
        ttl_ast = self._intern_ast(stmt.ttl) if stmt.ttl is not None else None
        key = ("insert", schema, values_ast, ttl_ast, tuple(cols), b,
               tuple(sorted(pl_args)))
        dev = self.device

        def build():
            def base(state, param_cols, pl_args, row_mask):
                values = {}
                for cname, vast in zip(cols, values_ast):
                    v = P.eval_expr(vast, {}, param_cols)
                    values[cname] = torch.broadcast_to(
                        T.to_device(v, dev), (b,))
                ttl = 0
                if ttl_ast is not None:
                    ttl = P.eval_expr(ttl_ast, {}, param_cols)
                return T.insert(schema, state, values, pl_args, row_mask,
                                ttl)

            return self._with_expiry(schema, base)

        fn = self._executor(t, key, build)
        args = (param_cols, pl_args, row_mask)
        if _warm:
            return self._finish_warm(t, fn, stmt, "insert", b, args)
        flag = self._expire_flag(t, n)
        slots, evicted = self._run_state(t, fn, flag, args)
        self._note_sig(t, stmt, "insert", b)
        self._note_route(t, n, True, rows_in=n)
        if per_statement:
            # one row per statement; each Result reports the batch's
            # eviction total as its value
            return [Result(count=1, dev={"value": evicted})
                    for _ in range(n)]
        return Result(count=n, dev={"row_ids": slots, "value": evicted},
                      ctx={"nshow": n})

    def _do_batch_dml(self, stmt, params_list: Sequence[Sequence[Any]],
                      per_statement: bool = False) -> "Result | list[Result]":
        """W same-shape DELETE/UPDATE statements in one dispatch.
        Single-column equality DELETEs take ONE pass over the table
        (``table.delete_many_eq``); other DELETEs one [W, capacity] mask
        (deletes commute, so the union count equals the sequential total;
        ``per_statement`` credits a row to the earliest statement). UPDATEs
        run one after another so later statements see earlier SETs."""
        t = self._table(stmt.table)
        schema = t.schema
        n = len(params_list)
        if n == 0:
            return [] if per_statement else Result(count=0)
        is_delete = isinstance(stmt, S.Delete)
        flag = self._expire_flag(t, n)
        b = _bucket(n)
        where = self._intern_ast(stmt.where)
        sets = ()
        n_params = P.collect_params(where)
        if not is_delete:
            sets = tuple((c, self._intern_ast(e)) for c, e in stmt.sets)
            for _, e in sets:
                n_params = max(n_params, P.collect_params(e))
        host_cols = self._param_cols(params_list, n, b, n_params)
        active = np.arange(b) < n
        fused = T._fused_plan(schema, where) if is_delete else None
        eq_term = (fused.terms[0]
                   if fused is not None and len(fused.terms) == 1
                   and fused.terms[0].op == "==" else None)
        if (eq_term is not None and eq_term.value[0] == "param"
                and not np.issubdtype(host_cols[eq_term.value[1]].dtype,
                                      np.integer)):
            eq_term = None  # float param: keep exact-compare semantics
        update_plan = None
        idx_rebuild = ()
        if not is_delete:
            set_cols = {("_ttl" if c.upper() == "TTL" else c)
                        for c, _ in sets}
            idx_rebuild = tuple(c for c in schema.indexes if c in set_cols)
            update_plan = T.plan_for(schema, where)
            if isinstance(update_plan, PL.IndexProbe) and (
                    idx_rebuild
                    or not _np_terms_int(
                        (update_plan.key,) + update_plan.residual,
                        host_cols)):
                # rewriting the key column mid-batch would strand the
                # index entries later statements probe: scan, and rebuild
                # once after the batch
                update_plan = update_plan.fallback
        key = ("dml", schema, is_delete, where, sets, b, eq_term,
               update_plan, per_statement)
        dev = self.device

        def build():
            if eq_term is not None:
                kind, v = eq_term.value

                def base(state, param_cols, active):
                    vals = (param_cols[v].to(torch.int32) if kind == "param"
                            else torch.full((b,), v, dtype=torch.int32,
                                            device=dev))
                    return T.delete_many_eq(schema, state, eq_term.col,
                                            vals, active,
                                            per_statement=per_statement)

                return self._with_expiry(schema, base)

            def base(state, param_cols, active):
                if is_delete:
                    m = (T._match_mask(schema, state, where, param_cols, b)
                         & active[:, None])
                    hit = m.any(dim=0)
                    n_hit = hit.sum(dtype=torch.int32)
                    # a row hit by several statements counts for the
                    # EARLIEST one (later ones find it gone)
                    mi = m.to(torch.int32)
                    claimed = (torch.cumsum(mi, dim=0) - mi) > 0
                    ns = (m & ~claimed).sum(dim=1, dtype=torch.int32)
                    nact = active.sum(dtype=torch.int32)
                    state = T._tick(dict(state, valid=state["valid"] & ~hit),
                                    nact)
                    return state, n_hit, ns

                def run(route):
                    # every lane of the bucket runs; a padding lane matches
                    # no row, and the clock then takes back its tick, so
                    # one executor serves any count in the bucket
                    st, parts = state, []
                    for i in range(b):
                        pr = tuple(c[i] for c in param_cols)
                        st, k = T.update(schema, st, where, dict(sets), pr,
                                         extra_mask=active[i], plan=route,
                                         maintain_indexes=False)
                        parts.append(k)
                    pad = b - active.sum(dtype=torch.int32)
                    st = dict(st, clock=st["clock"] - pad,
                              ops=st["ops"] - pad)
                    return st, torch.stack(parts)

                if isinstance(update_plan, PL.IndexProbe):
                    # the index cannot change inside the batch, so one
                    # freshness flag picks the probe run or the scan run
                    # (both computed: no host sync)
                    st, ns = T._select_fresh(
                        T.index_fresh(state, update_plan.column),
                        run(update_plan), run(update_plan.fallback))
                else:
                    st, ns = run(update_plan)
                for c in idx_rebuild:  # deferred: ONE rebuild per dispatch
                    st = T.build_index(schema, st, c)
                return st, ns.sum(dtype=torch.int32), ns

            return self._with_expiry(schema, base)

        fn = self._executor(t, key, build)
        kind = "delete" if is_delete else "update"
        outs = self._run_state(t, fn, flag, (host_cols, active))
        self._note_sig(t, stmt, kind, b)
        self._note_route(t, n, True)
        if per_statement:
            stack = _HostStack({"count": outs[1]})
            return [Result(ctx={"stack": stack, "index": i})
                    for i in range(n)]
        return Result(dev={"count": outs[0]})

    def _do_batch_select(self, stmt: S.Select,
                         params_list: Sequence[Sequence[Any]]
                         ) -> list[Result]:
        """W same-statement SELECTs in ONE dispatch: each kernel launches
        once for all W (``table.select_many``). Reads in a batch don't
        interleave with writes, the clock advances by the batch size, and
        the touch covers the RETURNED rows. Returns one lazy Result per
        statement, all views into one stacked transfer. Aggregates batch
        the same way (:meth:`_do_batch_agg`)."""
        if stmt.agg is not None:
            return self._do_batch_agg(stmt, params_list)
        t = self._table(stmt.table)
        schema = t.schema
        n = len(params_list)
        if n == 0:
            return []
        flag = self._expire_flag(t, n)
        b = _bucket(n)
        where = self._intern_ast(stmt.where)
        columns = stmt.columns or schema.column_names
        limit = stmt.limit if stmt.limit is not None else schema.max_select
        n_params = P.collect_params(where)
        param_cols = self._param_cols(params_list, n, b, n_params)
        active = np.arange(b) < n
        key = ("select_batch", schema, where, tuple(columns), stmt.payloads,
               stmt.order_by, stmt.descending, limit, b,
               self._probes(schema, where, param_cols,
                            stmt.order_by is not None))

        def build():
            def base(state, param_cols, active):
                _, res = T.select_many(
                    schema, state, where, param_cols, b, columns=columns,
                    order_by=stmt.order_by, descending=stmt.descending,
                    limit=limit, with_payloads=stmt.payloads, active=active,
                    touch=False)
                # one epilogue for the batch: touch the returned rows and
                # advance the clock by the REAL statement count
                return T.batch_touch(schema, state, res, active), res

            return self._with_expiry(schema, base)

        fn = self._executor(t, key, build)
        res, = self._run_state(t, fn, flag, (param_cols, active))
        self._note_sig(t, stmt, "select", b)
        self._note_route(t, n, False)
        stack = _HostStack({"count": res["count"], "rows": res["rows"],
                            "present": res["present"],
                            "row_ids": res["row_ids"]})
        ctx = {"columns": tuple(columns), "limit": limit,
               "text_cols": set(schema.text_columns()),
               "interner": self.interner, "stack": stack}
        if stmt.payloads:
            ctx["payload_stack"] = dict(res["payloads"])
        return [Result(ctx=dict(ctx, index=i)) for i in range(n)]

    @staticmethod
    def _probes(schema: TableSchema, where, host_cols,
                ranked: bool = False) -> bool:
        """Does a batch take the IndexProbe route (part of its executor's
        key, as in the reference): every probe term bound to an integer."""
        plan = T.plan_for(schema, where, ranked)
        return (isinstance(plan, PL.IndexProbe)
                and _np_terms_int((plan.key,) + plan.residual, host_cols))

    def _do_batch_agg(self, stmt: S.Select,
                      params_list: Sequence[Sequence[Any]]) -> list[Result]:
        """W same-shape aggregate SELECTs in ONE dispatch; the clock
        advances by the number of ACTIVE statements."""
        t = self._table(stmt.table)
        schema = t.schema
        n = len(params_list)
        if n == 0:
            return []
        flag = self._expire_flag(t, n)
        b = _bucket(n)
        agg, col = stmt.agg
        where = self._intern_ast(stmt.where)
        n_params = P.collect_params(where)
        param_cols = self._param_cols(params_list, n, b, n_params)
        active = np.arange(b) < n
        key = ("agg_batch", schema, agg, col, where, b,
               self._probes(schema, where, param_cols))

        def build():
            def base(state, param_cols, active):
                _, vals = T.aggregate_many(schema, state, agg, col, where,
                                           param_cols, b)
                return T._tick(state, active.sum(dtype=torch.int32)), vals

            return self._with_expiry(schema, base)

        fn = self._executor(t, key, build)
        vals, = self._run_state(t, fn, flag, (param_cols, active))
        self._note_sig(t, stmt, "select", b)
        self._note_route(t, n, False)
        stack = _HostStack({"value": vals})
        return [Result(ctx={"stack": stack, "index": i}) for i in range(n)]

    def _do_select(self, stmt: S.Select, params: tuple,
                   _warm: bool = False) -> "Result | int":
        """One SELECT. ``_warm=True`` pre-plans its executor from
        placeholder values (one int 0 per ``?``: the plan is keyed by the
        values' types, not the values) instead of running."""
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        if _warm:
            params = (0,) * P.collect_params(where)
        args = (self._host_params(params),)
        if stmt.agg is not None:
            agg, col = stmt.agg
            key = ("agg", schema, agg, col, where)
            fn = self._executor(
                t, key,
                lambda: self._with_expiry(
                    schema,
                    lambda st, pr: T.aggregate(schema, st, agg, col, where,
                                               pr)))
            if _warm:
                return self._finish_warm(t, fn, stmt, "select", None, args)
            val, = self._run_state(t, fn, self._expire_flag(t, 1), args)
            self._note_sig(t, stmt, "select", None)
            self._note_route(t, 1, False)
            return Result(dev={"value": val})
        columns = stmt.columns or schema.column_names
        limit = stmt.limit if stmt.limit is not None else schema.max_select
        key = ("select", schema, where, tuple(columns), stmt.payloads,
               stmt.order_by, stmt.descending, limit)

        def build():
            def base(st, pr):
                return T.select(schema, st, where, pr, columns=columns,
                                order_by=stmt.order_by,
                                descending=stmt.descending, limit=limit,
                                with_payloads=stmt.payloads)

            return self._with_expiry(schema, base)

        fn = self._executor(t, key, build)
        if _warm:
            return self._finish_warm(t, fn, stmt, "select", None, args)
        res, = self._run_state(t, fn, self._expire_flag(t, 1), args)
        self._note_sig(t, stmt, "select", None)
        self._note_route(t, 1, False)
        return Result(
            payloads=dict(res["payloads"]),
            dev={"count": res["count"], "rows": res["rows"],
                 "present": res["present"], "row_ids": res["row_ids"]},
            ctx={"columns": tuple(columns), "limit": limit,
                 "text_cols": set(schema.text_columns()),
                 "interner": self.interner},
        )

    def _do_update(self, stmt: S.Update, params: tuple,
                   _warm: bool = False) -> "Result | int":
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        sets = tuple((c, self._intern_ast(e)) for c, e in stmt.sets)
        if _warm:
            n_params = P.collect_params(where)
            for _, e in sets:
                n_params = max(n_params, P.collect_params(e))
            params = (0,) * n_params
        args = (self._host_params(params),)
        key = ("update", schema, where, sets)
        fn = self._executor(
            t, key, lambda: self._with_expiry(
                schema,
                lambda st, pr: T.update(schema, st, where, dict(sets), pr)))
        if _warm:
            return self._finish_warm(t, fn, stmt, "update", None, args)
        n, = self._run_state(t, fn, self._expire_flag(t, 1), args)
        self._note_sig(t, stmt, "update", None)
        self._note_route(t, 1, True)
        return Result(dev={"count": n})

    def _do_delete(self, stmt: S.Delete, params: tuple,
                   _warm: bool = False) -> "Result | int":
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        if _warm:
            params = (0,) * P.collect_params(where)
        args = (self._host_params(params),)
        # fusable deletes on payload-bearing tables also report WHICH rows
        # went (row ids feed incremental index maintenance); scalar tables
        # keep the mask-only path
        returning = (T._fused_plan(schema, where) is not None
                     and bool(schema.payloads))
        key = ("delete", schema, where, returning)

        def build():
            def base(st, pr):
                if returning:
                    return T.delete_returning(schema, st, where, pr)
                return T.delete(schema, st, where, pr)

            return self._with_expiry(schema, base)

        fn = self._executor(t, key, build)
        if _warm:
            return self._finish_warm(t, fn, stmt, "delete", None, args)
        outs = self._run_state(t, fn, self._expire_flag(t, 1), args)
        self._note_sig(t, stmt, "delete", None)
        self._note_route(t, 1, True)
        if returning:
            n, ids, present = outs
            return Result(dev={"count": n, "row_ids": ids,
                               "present": present},
                          ctx={"limit": schema.max_select})
        return Result(dev={"count": outs[0]})

    # ----------------------------------------------------- serving-plane API
    def table_state(self, name: str) -> dict:
        """The table's device state: a dict of the table's own tensors,
        which every later statement updates in place (their addresses stay
        until the table is dropped). A caller reads it on the daemon's
        stream right after the statement it follows (the serving engine's
        page-table upkeep); a snapshot is a copy."""
        return self._table(name).state

    def swap_table_state(self, name: str, state: dict) -> None:
        """Install a state (``convert.state_from_numpy`` turns the
        reference's pytree into one) by copying it into the table's own
        tensors. Its tensors must lie on this daemon's device and match
        the table's layout."""
        t = self._table(name)
        want = T.init_state(t.schema, "meta")
        _check_layout(want, state, self.device, name)
        _copy_into(t.state, state)

    def schema(self, name: str) -> TableSchema:
        return self._table(name).schema

    def live_rows(self, name: str) -> int:
        return int(T.live_count(self._table(name).state))

    def advance_clock(self, ticks: int, table: str | None = None) -> None:
        """Advance the logical clock (tests / wall-time sync)."""
        names = [table] if table else list(self.tables)
        for nm in names:
            self._table(nm).state["clock"].add_(ticks)


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])


def _check_layout(want, got, device, name: str, path: str = "") -> None:
    """Raise unless ``got`` has ``want``'s keys, shapes and dtypes and its
    tensors lie on ``device``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"swap_table_state({name!r}): keys of "
                             f"{path or 'state'} differ from the table's")
        for k in want:
            _check_layout(want[k], got[k], device, name, f"{path}/{k}")
        return
    if not isinstance(got, torch.Tensor) or got.shape != want.shape \
            or got.dtype != want.dtype or got.device != device:
        raise ValueError(f"swap_table_state({name!r}): {path} must be a "
                         f"{tuple(want.shape)} {want.dtype} tensor on "
                         f"{device}")
