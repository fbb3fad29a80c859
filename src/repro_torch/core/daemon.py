"""SQLCached: the cache daemon object (port of ``repro.core.daemon``, for
single-node monolithic tables).

Clients speak a subset of SQL (``execute`` / ``executemany``, or over TCP
through ``core/protocol.py``). Statements are parsed once and planned once
(``core/planner``); each statement shape gets one executor, a Python
closure kept in its table's executor dict. TEXT values are interned on the
host to int32 ids and turned back into strings in results. A table's state
lives on the daemon's device as a dict of tensors (``core/table.py``).

Devices are explicit: ``SQLCached()`` runs on ``"cuda"`` and raises when
no CUDA device is present; ``SQLCached(device="cpu")`` runs every kernel's
plain version on the CPU (the tests do). Kernels are chosen by the device
of their tensors, never by a switch.

Sync-free execution: ``execute`` / ``executemany`` never wait for the
device. Every dispatch returns a lazy :class:`Result` whose device outputs
reach the host on first access, in ONE device-to-host copy of all of them
(``_host_tree``); ``payloads`` and the ``*_device`` accessors never sync.
Executors return fresh tensors, so a Result never aliases table state.
``executemany`` runs W same-shape statements in one dispatch: SELECTs and
aggregates launch each kernel once for all W (``table.select_many`` /
``aggregate_many``), single-column eq DELETEs take one pass over the
table, other DELETEs one [W, capacity] mask; UPDATEs run in order, one
statement after another, because each must see the SETs before it.

The paper's third automatic expiry condition (every N cache operations)
is counted on the host (``_expire_flag``, one flag per dispatch, the
same cadence as the reference) and runs inside the same executor call.

Not in this port yet, and refused with ``SQLError``: ``SHARDS n>1`` /
``PARTITION BY``, ``ALTER TABLE ... RESHARD`` / ``RETAIN SLOTS``,
``CHECKPOINT`` / ``RESTORE`` and ``WARMUP``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import planner as PL
from repro_torch.core import predicate as P
from repro_torch.core import sqlparse as S
from repro_torch.core import table as T
from repro_torch.core import telemetry as TEL
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


def _host_tree(tree: dict) -> dict:
    """Numpy copy of a nested dict of tensors. Tensors on a card travel in
    ONE device-to-host copy: their bytes are concatenated on the device,
    copied once, and cut apart on the host."""
    leaves: list[torch.Tensor] = []

    def collect(x):
        if isinstance(x, dict):
            return {k: collect(v) for k, v in x.items()}
        leaves.append(x)
        return len(leaves) - 1

    skel = collect(tree)
    if any(t.device.type != "cpu" for t in leaves):
        flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
        buf = torch.cat(flat).cpu().numpy()
        arrays, off = [], 0
        for t in leaves:
            nbytes = t.numel() * t.element_size()
            np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
            arrays.append(buf[off:off + nbytes].view(np_dt)
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


class _Executors:
    """Per-table executor dict: one Python closure per statement shape,
    plus the host-side set of dispatch signatures already served
    (EXPLAIN's ``preplanned``) and hit/miss counters."""

    def __init__(self):
        self._entries: dict[Any, Any] = {}
        self.sigs: set = set()
        self._lock = LK.make_lock("daemon.executors")
        self.counters = TEL.Counters({"hits": 0, "misses": 0})

    def get(self, key, builder):
        fn = self._entries.get(key)
        if fn is not None:
            self.counters.add("hits")
            TEL.note_exec("hit")
            return fn
        with self._lock:
            fn = self._entries.get(key)
            if fn is None:
                fn = builder()
                self._entries[key] = fn
        self.counters.add("misses")
        TEL.note_exec("miss")
        return fn

    def forget_sigs(self) -> None:
        with self._lock:
            self.sigs.clear()

    def stats_dict(self) -> dict:
        """The ``executors`` block of ``SHOW STATS t``."""
        return {"entries": len(self._entries),
                "hits": self.counters["hits"],
                "misses": self.counters["misses"]}


@dataclasses.dataclass
class _Table:
    """One live table: its schema, its device state (a dict of tensors,
    ``core/table.py`` layout) and its host-side bookkeeping."""

    schema: TableSchema
    state: dict
    host_ops: int = 0
    lock: Any = dataclasses.field(default_factory=threading.Lock)
    execs: _Executors = dataclasses.field(default_factory=_Executors)
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
    S.Warmup: "WARMUP",
}


class SQLCached:
    def __init__(self, auto_expire: bool = True,
                 slow_ms: float | None = None, *, device=None):
        self.device = resolve_device(device)
        self.tables: dict[str, _Table] = {}
        self.interner = Interner()
        # serving telemetry (core/telemetry.py): trace spans, latency
        # histograms, slow-statement ring
        self.telemetry = TEL.Telemetry(slow_ms=slow_ms)
        self.auto_expire = auto_expire
        self._stmts: dict[str, S.Statement] = {}
        self._shapes: dict[str, StatementShape] = {}

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
        return P.map_consts(
            node, lambda v: self.interner.intern(v) if isinstance(v, str) else v
        )

    def _prep_params(self, params: Sequence[Any]) -> tuple:
        out = []
        for p in params:
            if isinstance(p, str):
                p = self.interner.intern(p)
            out.append(p)
        return tuple(out)

    def _param_cols(self, params_list, n: int, b: int, n_params: int):
        """Host [b]-columns of the bound values (rows past n repeat the
        last statement's, as padding) and their device tensors."""
        pm = [self._prep_params(params_list[min(i, n - 1)])
              for i in range(b)]
        host = tuple(np.asarray([pm[i][j] for i in range(b)])
                     for j in range(n_params))
        return pm, host, tuple(T.param_column(c, self.device) for c in host)

    def _executor(self, t: _Table, key: tuple, builder):
        return t.execs.get(key, builder)

    def _note_sig(self, t: _Table, stmt, kind: str, b) -> None:
        t.execs.sigs.add((kind, stmt, b))

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
        """Run an executor against the table's state and install the new
        state. Returns the executor's other outputs."""
        TEL.note_mode("mono")
        out = fn(t.state, flag, *args)
        t.state = out[0]
        return out[1:]

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
            self.tables.pop(stmt.table, None)
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
        self.tables[stmt.table] = self._make_table(schema)
        return Result()

    def _make_table(self, schema: TableSchema) -> _Table:
        return _Table(schema, T.init_state(schema, self.device),
                      lock=LK.make_lock(f"table:{schema.name}"),
                      stmt_routed=np.zeros(1, np.int64),
                      writes_routed=np.zeros(1, np.int64),
                      rows_in=np.zeros(1, np.int64))

    def _do_reindex(self, name: str) -> Result:
        """REINDEX t: rebuild every hash index from the live rows (the
        recovery path after a bucket overflow). ``value`` is the residual
        overflow (0 = probes are back)."""
        t = self._table(name)
        if not t.schema.indexes:
            return Result(count=0, value=0)
        t.execs.forget_sigs()
        t.state = T.build_index(t.schema, t.state)
        residual = sum(int(t.state["indexes"][c]["stale"])
                       for c in t.schema.indexes)
        return Result(count=len(t.schema.indexes), value=residual)

    def _do_flush(self, name: str) -> Result:
        t = self._table(name)
        t.state, n = T.flush(t.schema, t.state)
        return Result(dev={"count": n})

    def _do_expire(self, name: str) -> Result:
        t = self._table(name)
        t.state, n = T.expire(t.schema, t.state)
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
        exec_totals = {"entries": 0, "hits": 0, "misses": 0}
        for name, t in sorted(self.tables.items()):
            ed = t.execs.stats_dict()
            for k in exec_totals:
                exec_totals[k] += ed[k]
            tables[name] = {"shards": 1, "live_rows": self.live_rows(name),
                            "host_ops": t.host_ops}
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

    def _preplanned(self, t: _Table, stmt) -> bool:
        """EXPLAIN's ``preplanned`` bit: this statement shape has already
        been served (host signature set only, no device sync)."""
        kind = type(stmt).__name__.lower()
        b = 1 if kind == "insert" else None
        return (kind, stmt, b) in t.execs.sigs

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
                         per_statement: bool = False
                         ) -> "Result | list[Result]":
        """The INSERT arm of :meth:`executemany` (single INSERTs come here
        as a batch of one)."""
        t = self._table(stmt.table)
        schema = t.schema
        cols = stmt.columns or schema.column_names[: len(stmt.values)]
        if len(cols) != len(stmt.values):
            raise S.SQLError("INSERT column/value count mismatch")
        n = len(params_list)
        if n == 0:
            return [] if per_statement else Result(count=0)
        if n > schema.capacity:
            raise S.SQLError(f"INSERT of {n} rows exceeds CAPACITY "
                             f"{schema.capacity}")
        # the padded batch takes one slot a row, so it never outgrows the
        # table (padding rows are masked off)
        b = min(_bucket(n), schema.capacity)
        n_params = max((P.collect_params(v) for v in stmt.values), default=0)
        if stmt.ttl is not None:
            n_params = max(n_params, P.collect_params(stmt.ttl))
        _, _, param_cols = self._param_cols(params_list, n, b, n_params)
        row_mask = torch.arange(b, device=self.device) < n

        pl_args = {}
        for p in schema.payloads:
            if payloads_list and p.name in (payloads_list[0] or {}):
                arrs = [np.asarray(pl[p.name]) for pl in payloads_list]
                # stack rows (padding repeats the last one)
                pl_args[p.name] = T.to_device(
                    np.stack(arrs + [arrs[-1]] * (b - n)), self.device)

        values_ast = tuple(self._intern_ast(v) for v in stmt.values)
        ttl_ast = self._intern_ast(stmt.ttl) if stmt.ttl is not None else None
        flag = self._expire_flag(t, n)
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
        slots, evicted = self._run_state(t, fn, flag,
                                         (param_cols, pl_args, row_mask))
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
        _, host_cols, param_cols = self._param_cols(params_list, n, b,
                                                    n_params)
        active = torch.arange(b, device=self.device) < n
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

                def base(state, param_cols, active, n_real):
                    vals = (param_cols[v].to(torch.int32) if kind == "param"
                            else torch.full((b,), v, dtype=torch.int32,
                                            device=dev))
                    return T.delete_many_eq(schema, state, eq_term.col,
                                            vals, active,
                                            per_statement=per_statement)

                return self._with_expiry(schema, base)

            def base(state, param_cols, active, n_real):
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
                    st, parts = state, []
                    for i in range(n_real):
                        pr = tuple(c[i] for c in param_cols)
                        st, k = T.update(schema, st, where, dict(sets), pr,
                                         plan=route, maintain_indexes=False)
                        parts.append(k)
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
        outs = self._run_state(t, fn, flag, (param_cols, active, n))
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
        _, _, param_cols = self._param_cols(params_list, n, b, n_params)
        active = torch.arange(b, device=self.device) < n
        key = ("select_batch", schema, where, tuple(columns), stmt.payloads,
               stmt.order_by, stmt.descending, limit, b)

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
        _, _, param_cols = self._param_cols(params_list, n, b, n_params)
        active = torch.arange(b, device=self.device) < n
        key = ("agg_batch", schema, agg, col, where, b)

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

    def _do_select(self, stmt: S.Select, params: tuple) -> Result:
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        flag = self._expire_flag(t, 1)
        if stmt.agg is not None:
            agg, col = stmt.agg
            key = ("agg", schema, agg, col, where)
            fn = self._executor(
                t, key,
                lambda: self._with_expiry(
                    schema,
                    lambda st, pr: T.aggregate(schema, st, agg, col, where,
                                               pr)))
            val, = self._run_state(t, fn, flag, (params,))
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
        res, = self._run_state(t, fn, flag, (params,))
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

    def _do_update(self, stmt: S.Update, params: tuple) -> Result:
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        sets = tuple((c, self._intern_ast(e)) for c, e in stmt.sets)
        flag = self._expire_flag(t, 1)
        key = ("update", schema, where, sets)
        fn = self._executor(
            t, key, lambda: self._with_expiry(
                schema,
                lambda st, pr: T.update(schema, st, where, dict(sets), pr)))
        n, = self._run_state(t, fn, flag, (params,))
        self._note_sig(t, stmt, "update", None)
        self._note_route(t, 1, True)
        return Result(dev={"count": n})

    def _do_delete(self, stmt: S.Delete, params: tuple) -> Result:
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        flag = self._expire_flag(t, 1)
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
        outs = self._run_state(t, fn, flag, (params,))
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
        """The table's device state (a dict of tensors; executors never
        write into it, so it stays a consistent snapshot)."""
        return self._table(name).state

    def swap_table_state(self, name: str, state: dict) -> None:
        """Install a state (``convert.state_from_numpy`` turns the
        reference's pytree into one). Its tensors must lie on this
        daemon's device and match the table's layout."""
        t = self._table(name)
        want = T.init_state(t.schema, "meta")
        _check_layout(want, state, self.device, name)
        t.state = state

    def schema(self, name: str) -> TableSchema:
        return self._table(name).schema

    def live_rows(self, name: str) -> int:
        return int(T.live_count(self._table(name).state))

    def advance_clock(self, ticks: int, table: str | None = None) -> None:
        """Advance the logical clock (tests / wall-time sync)."""
        names = [table] if table else list(self.tables)
        for nm in names:
            t = self._table(nm)
            t.state = dict(t.state, clock=t.state["clock"] + ticks)


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
