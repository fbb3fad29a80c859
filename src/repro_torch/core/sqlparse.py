"""SQL-subset parser for the cache daemon (port of ``repro.core.sqlparse``:
the same grammar and the same statement dataclasses; payload dtypes are
torch dtypes). The port executes the single-node subset; the parser still
parses every statement so that ASTs compare equal to the reference's.

SQLcached's client interface is "an almost complete set of SQL statements"
over a text protocol. We implement the subset that a cache plane needs
(the paper itself notes n-way joins are a performance anti-pattern in a
cache daemon and we exclude them):

  CREATE TABLE t (a INT, b TEXT, INDEX(a), ...,
                  PAYLOAD kv TENSOR(16,2,8,64) BF16)
      [CAPACITY 4096] [MAX_SELECT 256] [TTL 100] [MAX_ROWS 1000]
      [OPS_INTERVAL 64] [SHARDS 4 | SHARDS(4)] [PARTITION BY a]
  INSERT INTO t (a, b) VALUES (?, 'x') [TTL 50]
  SELECT a, b FROM t WHERE a = ? AND b BETWEEN 2 AND 7
      [ORDER BY a [ASC|DESC]] [LIMIT 10]
  SELECT COUNT(*) | MIN(a) | MAX(a) | SUM(a) | AVG(a) FROM t [WHERE ...]
  SELECT PAYLOAD(kv), a FROM t WHERE ...
  UPDATE t SET a = a + 1, TTL = 200 WHERE b = ?
  DELETE FROM t WHERE user_id = ?
  EXPIRE t            -- run automatic expiry now
  FLUSH t             -- drop all rows (the memcached way)
  REINDEX t           -- rebuild t's hash indexes (recovers a stale,
                         i.e. overflowed, index once the duplicate
                         burst that overflowed it is gone)
  DROP TABLE t
  EXPLAIN <stmt>      -- report the chosen query plan (index-probe /
                         fused-scan / generic-scan) without executing
  EXPLAIN t           -- per-shard skew/usage stats (= SHOW STATS t)
  EXPLAIN ANALYZE <stmt>
                      -- execute the statement and report its actual
                         per-stage span timings (wire/parse/queue/lock/
                         execute/render) next to the plan
  SHOW STATS t        -- per-shard live rows + routed-statement counters
  SHOW STATS          -- daemon-wide roll-up: tables, scheduler stats,
                         executor-cache totals, uptime
  SHOW METRICS [t] [FORMAT 'prom']
                      -- serving telemetry report (core/telemetry.py):
                         per-table x per-kind log2 latency histograms,
                         percentiles, stage breakdowns; FORMAT 'prom'
                         emits a Prometheus-style text exposition
  SHOW SLOW           -- bounded ring of slow-statement span trees
                         (SQLCached(slow_ms=...) / REPRO_SLOW_MS)
  ALTER TABLE t RESHARD n
                      -- live re-partition: rebuild the shard pytree at
                         n shards by one bulk device-side re-split (row
                         metadata/TTLs ride along verbatim; n = 1
                         converts back to a monolithic table)
  ALTER TABLE t RETAIN SLOTS 0,3,5 OF 16
                      -- cluster rebalance primitive: keep only the rows
                         whose partition hash lands in the listed slots
                         out of OF slots (same multiplicative hash as
                         SHARDS/RESHARD — shards.shard_of); everything
                         else is dropped in one device-side masked
                         delete. COUNT reports the rows dropped.
  CHECKPOINT t TO 'dir'
                      -- atomic on-disk snapshot of t's device state
                         (checkpoint/store.py format) + the interner
                         strings its TEXT columns reference
  RESTORE t FROM 'dir'
                      -- replace t's contents from a snapshot; TEXT ids
                         are re-interned into THIS daemon's interner
                         (cross-process safe — replica bootstrap),
                         sharded tables re-split rows by hash and hash
                         indexes rebuild
  WARMUP t [LIKE 'SELECT ...']
                      -- pre-plan executors (AOT compile) ahead of
                         traffic: canonical hot shapes per placed lane
                         device, or exactly the quoted statement's shape
                         (core/execache.py). COUNT = new compiles

``REPLICAS r`` in the CREATE option tail declares the table's cluster
replication factor (default 1). The daemon itself stores r as schema
metadata only — mirroring writes to r ring-successor nodes is the
cluster client's job (core/cluster.py); carrying it in the CREATE text
lets every node of a replica group parse the SAME statement verbatim.

``INDEX(col)`` in a CREATE column list declares a device-resident hash
index on an INT/TEXT column; equality WHEREs on it become O(1) bucket
probes (core/planner.py decides, EXPLAIN shows the decision).

``SHARDS n`` (equivalently ``SHARDS(n)``) hash-partitions the table's
rows across ``n`` independent shard tables (core/shards.py), split by a
multiplicative hash of the ``PARTITION BY`` column (defaults to the
first indexed column, else the first INT/TEXT column). An equality WHERE
on the partition column prunes execution to exactly one shard;
everything else fans out across all shards and merges the partials
(EXPLAIN reports the shard route next to the plan).

Statements parse to frozen dataclasses (hashable → usable as static jit
arguments); `?` placeholders become Param nodes so one parse+jit serves
every execution (the prepared-statement cache of the paper).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.core import predicate as P
from repro_torch.core.schema import SQL_TYPES

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|!=|<>|==|[=<>+\-*/%(),?])
    """,
    re.VERBOSE,
)

_PAYLOAD_DTYPES = {
    "FLOAT": torch.float32,
    "F32": torch.float32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "INT8": torch.int8,
    "INT32": torch.int32,
    "BOOL": torch.bool,
}

_AGG_NAMES = ("COUNT", "SUM", "MIN", "MAX", "AVG")


class SQLError(ValueError):
    pass


def tokenize(sql: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SQLError(f"bad token at {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------- statements


@dataclasses.dataclass(frozen=True)
class CreateTable:
    table: str
    columns: tuple[tuple[str, str], ...]  # (name, sql_type)
    payloads: tuple[tuple[str, tuple[int, ...], str], ...]  # (name, shape, dtype)
    capacity: int = 4096
    max_select: int = 1024
    ttl: int = 0
    max_rows: int = 0
    ops_interval: int = 0
    indexes: tuple[str, ...] = ()  # hash-indexed columns (INDEX(col))
    shards: int = 1  # hash-partition count (SHARDS n)
    partition_by: str | None = None  # PARTITION BY col (None = default)
    replicas: int = 1  # cluster replication factor (REPLICAS r)


@dataclasses.dataclass(frozen=True)
class Insert:
    table: str
    columns: tuple[str, ...]
    values: tuple[P.Node, ...]
    ttl: P.Node | None = None


@dataclasses.dataclass(frozen=True)
class Select:
    table: str
    columns: tuple[str, ...]  # () = *
    payloads: tuple[str, ...] = ()
    agg: tuple[str, str | None] | None = None  # (fn, col)
    where: P.Node | None = None
    order_by: str | None = None
    descending: bool = False
    limit: int | None = None


@dataclasses.dataclass(frozen=True)
class Update:
    table: str
    sets: tuple[tuple[str, P.Node], ...]
    where: P.Node | None = None


@dataclasses.dataclass(frozen=True)
class Delete:
    table: str
    where: P.Node | None = None


@dataclasses.dataclass(frozen=True)
class Expire:
    table: str


@dataclasses.dataclass(frozen=True)
class Flush:
    table: str


@dataclasses.dataclass(frozen=True)
class Reindex:
    """REINDEX t: bulk-rebuild the table's hash indexes from the current
    rows, clearing the stale flag when the rebuild fits its buckets."""

    table: str


@dataclasses.dataclass(frozen=True)
class DropTable:
    table: str


@dataclasses.dataclass(frozen=True)
class ShowStats:
    """SHOW STATS t (equivalently ``EXPLAIN t``): per-shard skew report —
    live rows, routed-statement and write counters per execution lane.
    Without a table, the daemon-wide roll-up (tables, scheduler stats,
    executor-cache totals, uptime)."""

    table: str | None = None


@dataclasses.dataclass(frozen=True)
class ShowMetrics:
    """SHOW METRICS [t] [FORMAT 'prom']: the serving-telemetry report —
    per-(table, kind) log2 latency histograms, percentiles and per-stage
    breakdowns (core/telemetry.py). FORMAT 'prom' returns a
    Prometheus-style text exposition (JSON-string-encoded on the wire)."""

    table: str | None = None
    fmt: str | None = None


@dataclasses.dataclass(frozen=True)
class ShowSlow:
    """SHOW SLOW: the bounded ring of slow-statement span trees captured
    by ``SQLCached(slow_ms=...)`` / ``REPRO_SLOW_MS``."""


@dataclasses.dataclass(frozen=True)
class AlterReshard:
    """ALTER TABLE t RESHARD n: live re-partition of a table's rows
    across ``n`` shards (bulk device-side re-split; admin barrier)."""

    table: str
    shards: int


@dataclasses.dataclass(frozen=True)
class AlterRetain:
    """ALTER TABLE t RETAIN SLOTS a,b,c OF m: keep only the rows whose
    partition-column hash (``shards.shard_of(value, m)``) is one of the
    listed slots; drop the rest (one device-side masked delete). The
    cluster tier's rebalance primitive — after a replica bootstraps from
    a full snapshot it RETAINs exactly the key slots the ring assigns
    it, so a node join/leave moves only 1/N of the keyspace."""

    table: str
    slots: tuple[int, ...]
    of: int


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """CHECKPOINT t TO 'dir': atomic on-disk snapshot of the table's
    device state plus the interner strings its TEXT columns reference
    (checkpoint/store.py format) — the replica-bootstrap source."""

    table: str
    path: str


@dataclasses.dataclass(frozen=True)
class Restore:
    """RESTORE t FROM 'dir': replace the table's contents from a
    CHECKPOINT snapshot. TEXT ids re-intern into this daemon's interner,
    sharded tables re-split rows by hash, hash indexes rebuild — safe
    across processes (replica bootstrap on a different daemon)."""

    table: str
    path: str


@dataclasses.dataclass(frozen=True)
class Warmup:
    """WARMUP t [LIKE '<stmt>']: pre-plan executors ahead of traffic.

    Without LIKE, compiles the table's canonical hot shapes (full-row
    INSERT plus eq-SELECT/DELETE on the partition/index columns) for
    every placed lane device. With LIKE, parses the quoted statement and
    pre-plans exactly that shape. COUNT reports newly compiled
    executables (0 = everything was already planned)."""

    table: str
    like: str | None = None


@dataclasses.dataclass(frozen=True)
class Explain:
    """EXPLAIN <stmt>: report the inner statement's query plan."""

    inner: "Statement"


@dataclasses.dataclass(frozen=True)
class ExplainAnalyze:
    """EXPLAIN ANALYZE <stmt>: execute the inner statement and report
    its measured per-stage span timings next to the plan."""

    inner: "Statement"


Statement = (
    CreateTable | Insert | Select | Update | Delete | Expire | Flush
    | Reindex | DropTable | ShowStats | ShowMetrics | ShowSlow
    | AlterReshard | AlterRetain | Checkpoint | Restore | Warmup
    | Explain | ExplainAnalyze
)


# ------------------------------------------------------------------- parser


class _Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0
        self.n_params = 0

    # -- token helpers
    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws) -> str | None:
        kind, val = self.peek()
        if kind == "name" and val.upper() in kws:
            self.next()
            return val.upper()
        return None

    def expect_kw(self, *kws) -> str:
        got = self.accept_kw(*kws)
        if got is None:
            raise SQLError(f"expected {'/'.join(kws)}, got {self.peek()[1]!r}")
        return got

    def accept_op(self, *ops) -> str | None:
        kind, val = self.peek()
        if kind == "op" and val in ops:
            self.next()
            return val
        return None

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise SQLError(f"expected {op!r}, got {self.peek()[1]!r}")

    def name(self) -> str:
        kind, val = self.next()
        if kind != "name":
            raise SQLError(f"expected identifier, got {val!r}")
        return val

    def integer(self) -> int:
        kind, val = self.next()
        if kind != "num" or "." in val:
            raise SQLError(f"expected integer, got {val!r}")
        return int(val)

    # -- expressions
    def expr(self) -> P.Node:
        return self._or()

    def _or(self) -> P.Node:
        node = self._and()
        while self.accept_kw("OR"):
            node = P.Or(node, self._and())
        return node

    def _and(self) -> P.Node:
        node = self._not()
        while self.accept_kw("AND"):
            node = P.And(node, self._not())
        return node

    def _not(self) -> P.Node:
        if self.accept_kw("NOT"):
            return P.Not(self._not())
        return self._cmp()

    def _cmp(self) -> P.Node:
        node = self._add()
        op = self.accept_op("=", "==", "!=", "<>", "<", "<=", ">", ">=")
        if op:
            return P.BinOp(op, node, self._add())
        if self.accept_kw("BETWEEN"):
            lo = self._add()
            self.expect_kw("AND")
            return P.Between(node, lo, self._add())
        if self.accept_kw("IN"):
            self.expect_op("(")
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            self.expect_op(")")
            return P.InList(node, tuple(items))
        return node

    def _add(self) -> P.Node:
        node = self._mul()
        while True:
            op = self.accept_op("+", "-")
            if not op:
                return node
            node = P.BinOp(op, node, self._mul())

    def _mul(self) -> P.Node:
        node = self._unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return node
            node = P.BinOp(op, node, self._unary())

    def _unary(self) -> P.Node:
        if self.accept_op("-"):
            return P.BinOp("-", P.Const(0), self._unary())
        return self._primary()

    def _primary(self) -> P.Node:
        kind, val = self.peek()
        if kind == "num":
            self.next()
            return P.Const(float(val) if "." in val or "e" in val.lower() else int(val))
        if kind == "str":
            self.next()
            return P.Const(val[1:-1].replace("''", "'"))
        if kind == "op" and val == "?":
            self.next()
            node = P.Param(self.n_params)
            self.n_params += 1
            return node
        if kind == "op" and val == "(":
            self.next()
            node = self.expr()
            self.expect_op(")")
            return node
        if kind == "name":
            nm = self.name()
            if self.accept_op("("):
                args = []
                if not self.accept_op(")"):
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                    self.expect_op(")")
                return P.Func(nm, tuple(args))
            return P.Col(nm)
        raise SQLError(f"unexpected token {val!r}")

    _STMT_KWS = ("CREATE", "INSERT", "SELECT", "UPDATE", "DELETE",
                 "EXPIRE", "FLUSH", "REINDEX", "DROP", "SHOW", "ALTER",
                 "CHECKPOINT", "RESTORE", "WARMUP")

    # -- statements
    def statement(self) -> Statement:
        explain = self.accept_kw("EXPLAIN") is not None
        analyze = False
        if explain:
            # ANALYZE must be consumed before the EXPLAIN <table> branch
            # or "EXPLAIN ANALYZE x" would parse as ShowStats("ANALYZE")
            analyze = self.accept_kw("ANALYZE") is not None
            if not analyze:
                kind, val = self.peek()
                if kind == "name" and val.upper() not in self._STMT_KWS:
                    # EXPLAIN <table>: the per-shard stats report
                    stmt = ShowStats(self.name())
                    if self.peek()[0] != "eof":
                        raise SQLError(
                            f"trailing tokens: {self.peek()[1]!r}")
                    return stmt
        kw = self.expect_kw(*self._STMT_KWS)
        fn = getattr(self, f"_stmt_{kw.lower()}")
        stmt = fn()
        if self.peek()[0] != "eof":
            raise SQLError(f"trailing tokens: {self.peek()[1]!r}")
        if analyze:
            return ExplainAnalyze(stmt)
        return Explain(stmt) if explain else stmt

    def _stmt_create(self) -> CreateTable:
        self.expect_kw("TABLE")
        table = self.name()
        self.expect_op("(")
        columns, payloads, indexes = [], [], []
        while True:
            nk, nv = self.peek()
            follows_paren = (nk == "name" and nv.upper() == "INDEX"
                             and self.toks[self.i + 1][1] == "(")
            if follows_paren and self.accept_kw("INDEX"):
                self.expect_op("(")
                indexes.append(self.name())
                self.expect_op(")")
            elif self.accept_kw("PAYLOAD"):
                pname = self.name()
                self.expect_kw("TENSOR")
                self.expect_op("(")
                shape = [self.integer()]
                while self.accept_op(","):
                    shape.append(self.integer())
                self.expect_op(")")
                dt = "FLOAT"
                kind, val = self.peek()
                if kind == "name" and val.upper() in _PAYLOAD_DTYPES:
                    dt = self.next()[1].upper()
                payloads.append((pname, tuple(shape), dt))
            else:
                cname = self.name()
                ctype = self.name().upper()
                if ctype not in SQL_TYPES:
                    raise SQLError(f"unknown type {ctype!r}")
                columns.append((cname, ctype))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        opts = {"capacity": 4096, "max_select": 1024, "ttl": 0, "max_rows": 0,
                "ops_interval": 0, "shards": 1, "replicas": 1}
        partition_by = None
        while True:
            kw = self.accept_kw("CAPACITY", "MAX_SELECT", "TTL", "MAX_ROWS",
                                "OPS_INTERVAL", "SHARDS", "PARTITION",
                                "REPLICAS")
            if not kw:
                break
            if kw == "PARTITION":
                self.expect_kw("BY")
                partition_by = self.name()
            elif kw == "SHARDS" and self.accept_op("("):
                opts["shards"] = self.integer()  # SHARDS(n) form
                self.expect_op(")")
            else:
                opts[kw.lower()] = self.integer()
        if opts["shards"] < 1:
            raise SQLError("SHARDS must be >= 1")
        if opts["replicas"] < 1:
            raise SQLError("REPLICAS must be >= 1")
        return CreateTable(table, tuple(columns), tuple(payloads),
                           indexes=tuple(indexes), partition_by=partition_by,
                           **opts)

    def _stmt_insert(self) -> Insert:
        self.expect_kw("INTO")
        table = self.name()
        cols = []
        if self.accept_op("("):
            cols.append(self.name())
            while self.accept_op(","):
                cols.append(self.name())
            self.expect_op(")")
        self.expect_kw("VALUES")
        self.expect_op("(")
        vals = [self.expr()]
        while self.accept_op(","):
            vals.append(self.expr())
        self.expect_op(")")
        ttl = None
        if self.accept_kw("TTL"):
            ttl = self.expr()
        return Insert(table, tuple(cols), tuple(vals), ttl)

    def _stmt_select(self) -> Select:
        columns: list[str] = []
        payloads: list[str] = []
        agg = None
        if self.accept_op("*"):
            pass
        else:
            while True:
                kind, val = self.peek()
                up = val.upper() if kind == "name" else ""
                if up in _AGG_NAMES:
                    self.next()
                    self.expect_op("(")
                    if self.accept_op("*"):
                        agg = (up, None)
                    else:
                        agg = (up, self.name())
                    self.expect_op(")")
                elif up == "PAYLOAD":
                    self.next()
                    self.expect_op("(")
                    payloads.append(self.name())
                    self.expect_op(")")
                else:
                    columns.append(self.name())
                if not self.accept_op(","):
                    break
        self.expect_kw("FROM")
        table = self.name()
        where = self.expr() if self.accept_kw("WHERE") else None
        order_by, desc = None, False
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self.name()
            if self.accept_kw("DESC"):
                desc = True
            else:
                self.accept_kw("ASC")
        limit = self.integer() if self.accept_kw("LIMIT") else None
        return Select(table, tuple(columns), tuple(payloads), agg, where,
                      order_by, desc, limit)

    def _stmt_update(self) -> Update:
        table = self.name()
        self.expect_kw("SET")
        sets = []
        while True:
            col = self.name()
            self.expect_op("=")
            sets.append((col, self.expr()))
            if not self.accept_op(","):
                break
        where = self.expr() if self.accept_kw("WHERE") else None
        return Update(table, tuple(sets), where)

    def _stmt_delete(self) -> Delete:
        self.expect_kw("FROM")
        table = self.name()
        where = self.expr() if self.accept_kw("WHERE") else None
        return Delete(table, where)

    def _stmt_expire(self) -> Expire:
        return Expire(self.name())

    def _stmt_flush(self) -> Flush:
        return Flush(self.name())

    def _stmt_reindex(self) -> Reindex:
        return Reindex(self.name())

    def _stmt_drop(self) -> DropTable:
        self.expect_kw("TABLE")
        return DropTable(self.name())

    def _stmt_show(self) -> "ShowStats | ShowMetrics | ShowSlow":
        kw = self.expect_kw("STATS", "METRICS", "SLOW")
        if kw == "SLOW":
            return ShowSlow()
        if kw == "METRICS":
            table = None
            kind, val = self.peek()
            if kind == "name" and val.upper() != "FORMAT":
                table = self.name()
            fmt = None
            if self.accept_kw("FORMAT"):
                fmt = self._string().lower()
                if fmt not in ("json", "prom"):
                    raise SQLError(f"unknown METRICS format {fmt!r}")
            return ShowMetrics(table, fmt)
        if self.peek()[0] == "name":
            return ShowStats(self.name())
        return ShowStats(None)

    def _stmt_alter(self) -> "AlterReshard | AlterRetain":
        self.expect_kw("TABLE")
        table = self.name()
        kw = self.expect_kw("RESHARD", "RETAIN")
        if kw == "RESHARD":
            n = self.integer()
            if n < 1:
                raise SQLError("RESHARD must be >= 1")
            return AlterReshard(table, n)
        self.expect_kw("SLOTS")
        slots = [self.integer()]
        while self.accept_op(","):
            slots.append(self.integer())
        self.expect_kw("OF")
        m = self.integer()
        if m < 1:
            raise SQLError("RETAIN ... OF m: m must be >= 1")
        if any(s < 0 or s >= m for s in slots):
            raise SQLError(f"RETAIN slot out of range [0, {m})")
        return AlterRetain(table, tuple(sorted(set(slots))), m)

    def _string(self) -> str:
        kind, val = self.next()
        if kind != "str":
            raise SQLError(f"expected string literal, got {val!r}")
        return val[1:-1].replace("''", "'")

    def _stmt_checkpoint(self) -> Checkpoint:
        table = self.name()
        self.expect_kw("TO")
        return Checkpoint(table, self._string())

    def _stmt_restore(self) -> Restore:
        table = self.name()
        self.expect_kw("FROM")
        return Restore(table, self._string())

    def _stmt_warmup(self) -> Warmup:
        table = self.name()
        like = self._string() if self.accept_kw("LIKE") else None
        return Warmup(table, like)


def parse(sql: str) -> Statement:
    return _Parser(sql).statement()
