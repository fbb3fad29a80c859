"""Cluster tier: consistent-hash routing, replication and failover over
the tagged wire — N daemons behind one client (port of
``repro.core.cluster``: the client speaks only the wire, so it is the
reference's code over the port's parser, planner, telemetry and
protocol; the daemons behind it run ``python -m repro_torch.core.protocol``
or ``repro_torch.core.protocol.ThreadedServer``, and a client of either
package can drive daemons of either).

The paper ships SQLcached on "several large web sites", which means
fleets of daemons; this module is the routing layer in front of them
(the follow-up papers' clustering step, see PAPERS.md). Nothing here
runs on a daemon: the cluster is a CLIENT-side construct over the plain
tagged protocol (core/protocol.py), so daemons stay single-node simple
and any daemon can join any cluster.

Placement
---------
A :class:`HashRing` (consistent hashing, virtual nodes, deterministic
md5 points — stable across processes and PYTHONHASHSEED) maps keys to
nodes. Two granularities:

- A table WITHOUT an INT ``PARTITION BY`` column lives whole on
  ``ring.lookup(table, r)`` — its *group* of r nodes (``REPLICAS r``
  from the CREATE; the daemon stores r, we enforce it).
- A table WITH an INT partition column is *spread*: its keyspace is cut
  into ``NSLOTS`` cluster slots by the same multiplicative hash the
  daemon shards with (``shards.shard_of_host`` — so the daemon-side
  ``ALTER TABLE .. RETAIN SLOTS .. OF NSLOTS`` handover primitive
  computes the exact same membership), and slot s lives on
  ``ring.lookup(f"{table}/{s}", r)``. Adding or removing a node remaps
  only ~1/N of the slots — that is the point of the ring.
  (TEXT partition columns spread by per-daemon interner ids, which no
  two daemons share — those tables fall back to whole-table placement.)

Routing
-------
The client parses each statement (core/sqlparse.py) and reuses the
single-node shard planner for pruning: an equality on the partition
column (``planner.plan_shards``) routes to ONE slot group; everything
else fans out. Fan-out row reads choose a *cover* — one live member per
slot, deduped by node — and the merge keeps only each node's assigned
slots (rows carry the partition column, so the slot of every row is
recomputable client-side); ORDER BY re-sorts and LIMIT re-applies after
the merge. Fan-out aggregates go to every live node: COUNT/SUM divide
by the replication factor (each row has r live copies when healthy),
AVG is rewritten into SUM+COUNT and re-divided, MIN/MAX are
replication-immune. CREATE/DROP go to every node (any node may inherit
any slot later), so topology changes never need schema shipping.

Replication, acks, failover
---------------------------
Writes are mirrored to every live member of the target group UNDER THE
SAME TAG, in one pipelined flush; the result reported is the first
group member's. **Acknowledged means: the response block for the
statement's tag has been read back from every member that is still
considered live.** On connection loss or statement timeout the failed
node is marked down and the survivor's response — same tag, already
executed — stands in; that is the idempotent replay that makes a
kill -9 mid-pipeline lose zero acknowledged writes. Reads round-robin
across live group members; a failed read is re-sent to a surviving
replica with capped exponential backoff + jitter
(``protocol.backoff_delays``), and the survivor is thereby promoted
(the first live member of a group is its primary — death just filters
the list). Ordering: one ClusterClient preserves statement order per
node connection, so replicas converge and read-your-writes holds per
client; cross-client writes race exactly like memcached.

Topology changes
----------------
``add_node`` / ``remove_node`` recompute groups and move only the
remapped slots. A fresh node bulk-bootstraps via the daemon's
CHECKPOINT/RESTORE (checkpoint/store.py snapshots; RESTORE re-splits
rows through the RESHARD machinery and re-interns TEXT), then trims to
its owned slots with RETAIN; residual slots (and gains by already-
populated nodes, where RESTORE would clobber) move by row replay —
SELECT * from a surviving donor, slot-filtered, re-INSERTed. Checkpoint
directories default to a local tempdir; point ``checkpoint_dir`` at
shared storage when daemons span machines. ``SHOW CLUSTER`` (handled
client-side) reports nodes, health, tables, and group membership.

Known limits (documented, not surprises): fan-out write counts are
``sum // r`` and exact only while every replica is up; row replay moves
at most ``MAX_SELECT`` rows per table and drops tensor payloads (they
never cross the socket); a crashed node that restarts must rejoin via
``remove_node`` + ``add_node`` — promotion never un-happens by itself.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import itertools
import json
import tempfile
import time
from typing import Any, Sequence

from repro_torch.core import planner as PL
from repro_torch.core import predicate as P
from repro_torch.core import sqlparse as S
from repro_torch.core import telemetry as TEL
from repro_torch.core.protocol import (SQLCachedClient, _encode_arg,
                                 backoff_delays)
from repro_torch.core.schema import ExpiryPolicy, TableSchema, make_schema
from repro_torch.core.shards import shard_of_host

# cluster keyspace granularity for spread tables: partition values hash
# into this many slots, each placed on the ring independently. 64 keeps
# moved-data fractions fine-grained for small fleets while RETAIN lists
# stay short. Changing it changes placement — a cluster constant.
NSLOTS = 64


class ClusterError(RuntimeError):
    """Cluster-level failure: no live replica, unacknowledged write,
    un-mergeable fan-out, unknown table."""


def _norm_node(node) -> str:
    """Canonical node name 'host:port' from a string or (host, port)."""
    if isinstance(node, str):
        host, _, port = node.rpartition(":")
        return f"{host}:{int(port)}"
    host, port = node
    return f"{host}:{int(port)}"


def _node_addr(name: str) -> tuple[str, int]:
    host, _, port = name.rpartition(":")
    return host, int(port)


def _hash_point(key: str) -> int:
    """Deterministic 64-bit ring coordinate (md5 — stable across
    processes, unlike hash())."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each node contributes ``vnodes`` points; a key maps to the first
    point clockwise, and :meth:`lookup` walks on to collect r DISTINCT
    nodes — the key's replica group. Adding/removing one node moves only
    the keys whose successor changed: ~1/N of the keyspace."""

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        self.vnodes = vnodes
        self._points: list[tuple[int, str]] = []
        self.nodes: list[str] = []
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        if node in self.nodes:
            raise ValueError(f"node {node!r} already on the ring")
        self.nodes.append(node)
        for i in range(self.vnodes):
            bisect.insort(self._points, (_hash_point(f"{node}#{i}"), node))

    def remove(self, node: str) -> None:
        self.nodes.remove(node)
        self._points = [p for p in self._points if p[1] != node]

    def lookup(self, key: str, r: int = 1) -> tuple[str, ...]:
        """The r distinct nodes owning ``key``, clockwise from its hash
        (all nodes when r >= N). Order matters: index 0 is the primary."""
        if not self._points:
            raise ClusterError("empty ring")
        out: list[str] = []
        i = bisect.bisect_right(self._points, (_hash_point(key), "￿"))
        for k in range(len(self._points)):
            node = self._points[(i + k) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) >= r:
                    break
        return tuple(out)


def _schema_of(stmt: S.CreateTable) -> TableSchema:
    """The daemon's CREATE lowering, run client-side so routing sees the
    same schema (incl. the defaulted partition column) as every node."""
    from repro_torch.core.sqlparse import _PAYLOAD_DTYPES

    return make_schema(
        stmt.table, list(stmt.columns),
        [(n, s, _PAYLOAD_DTYPES[d]) for (n, s, d) in stmt.payloads],
        capacity=stmt.capacity, max_select=stmt.max_select,
        expiry=ExpiryPolicy(stmt.ttl, stmt.max_rows, stmt.ops_interval),
        indexes=stmt.indexes, shards=stmt.shards,
        partition_by=stmt.partition_by, replicas=stmt.replicas)


@dataclasses.dataclass
class _TableMeta:
    create_sql: str
    schema: TableSchema
    replicas: int
    spread: bool                 # slot-routed (INT partition column)
    pcol: str | None             # partition column (spread tables)
    # slot -> replica group (member order = promotion order); whole-table
    # tables keep one group under key None. Membership is STATIC between
    # topology calls — health only filters it, so promotion is simply
    # "first member not marked down".
    groups: dict[Any, tuple[str, ...]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class _Pending:
    """One submitted cluster statement: its routing decision at submit
    time plus the per-member responses as they arrive."""

    sql: str
    params: tuple
    mode: str                    # local|create|drop|group_write|group_read
    #                              |fanall_write|agg_read|rows_fanout
    #                              |stats|any_read
    sqls: tuple[str, ...] = ()   # wire statements (AVG rewrites to 2)
    meta: _TableMeta | None = None
    groups: list = dataclasses.field(default_factory=list)
    slots: list = dataclasses.field(default_factory=list)
    node_slots: dict = dataclasses.field(default_factory=dict)
    div: int = 1                 # fan-all count deflation (replicas)
    agg: tuple | None = None
    order_by: str | None = None
    descending: bool = False
    limit: int | None = None
    local: dict | None = None
    resp: dict = dataclasses.field(default_factory=dict)
    #                              (gi, node, sub_i) -> dict | Exception


_AVG_RE = None  # built lazily (re import kept out of the hot path)


def _avg_rewrite(sql: str) -> tuple[str, str]:
    """AVG(col) fan-outs merge as sum(SUM)/sum(COUNT): rewrite the one
    statement into its SUM and COUNT(*) twins (same WHERE, same params)."""
    global _AVG_RE
    if _AVG_RE is None:
        import re
        _AVG_RE = re.compile(r"AVG\s*\(\s*(\w+)\s*\)", re.IGNORECASE)
    m = _AVG_RE.search(sql)
    if m is None:  # pragma: no cover — guarded by the caller
        raise ClusterError(f"cannot rewrite AVG statement: {sql!r}")
    return (sql[:m.start()] + f"SUM({m.group(1)})" + sql[m.end():],
            sql[:m.start()] + "COUNT(*)" + sql[m.end():])


class _ClusterBase:
    """Routing + merging shared by the sync and async clients (network
    I/O lives in the subclasses)."""

    def __init__(self, nodes, *, replica_default: int = 1,
                 statement_retries: int = 4, retry_base: float = 0.05,
                 retry_cap: float = 2.0):
        names = [_norm_node(n) for n in nodes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate nodes")
        self._ring = HashRing(names)
        self._down: set[str] = set()
        self._tables: dict[str, _TableMeta] = {}
        self._parse_cache: dict[str, S.Statement] = {}
        self._tagno = 0
        self._rr = 0
        self.replica_default = replica_default
        self.statement_retries = statement_retries
        self.retry_base, self.retry_cap = retry_base, retry_cap

    # ----------------------------------------------------------- utilities
    def _next_tag(self) -> str:
        # one monotonic counter for the whole cluster: a mirrored write
        # carries the SAME tag on every member connection (idempotent
        # replay), and no connection ever sees a tag twice
        self._tagno += 1
        return f"c{self._tagno}"

    def _rr_next(self) -> int:
        self._rr += 1
        return self._rr

    def _live_nodes(self) -> list[str]:
        return [n for n in self._ring.nodes if n not in self._down]

    def _live(self, members) -> list[str]:
        return [m for m in members if m not in self._down]

    def _parse(self, sql: str) -> S.Statement:
        stmt = self._parse_cache.get(sql)
        if stmt is None:
            stmt = S.parse(sql)
            if len(self._parse_cache) < 4096:
                self._parse_cache[sql] = stmt
        return stmt

    def _meta(self, table: str) -> _TableMeta:
        m = self._tables.get(table)
        if m is None:
            raise ClusterError(
                f"unknown table {table!r}: CREATE it through this "
                f"ClusterClient so routing metadata exists")
        return m

    def _compute_groups(self, name: str, spread: bool,
                        replicas: int) -> dict:
        if spread:
            return {s: self._ring.lookup(f"{name}/{s}", replicas)
                    for s in range(NSLOTS)}
        return {None: self._ring.lookup(name, replicas)}

    def _register(self, sql: str, stmt: S.CreateTable) -> _TableMeta:
        schema = _schema_of(stmt)
        pby = schema.partition_by
        spread = (pby is not None
                  and not schema.column(pby).is_text)
        replicas = max(stmt.replicas, self.replica_default)
        meta = _TableMeta(sql, schema, replicas, spread,
                          pby if spread else None)
        meta.groups = self._compute_groups(stmt.table, spread, replicas)
        self._tables[stmt.table] = meta
        return meta

    # ------------------------------------------------------------- routing
    def _route(self, sql: str, params: Sequence[Any]) -> _Pending:
        params = tuple(params)
        if sql.strip().rstrip(";").upper() == "SHOW CLUSTER":
            return _Pending(sql, params, "local", local=self.show_cluster())
        stmt = self._parse(sql)
        p = _Pending(sql, params, "", sqls=(sql,))
        if isinstance(stmt, S.CreateTable):
            p.mode = "create"
            p.meta = self._register(sql, stmt)
            return p
        if isinstance(stmt, S.DropTable):
            p.mode = "drop"
            self._tables.pop(stmt.table, None)
            return p
        if isinstance(stmt, (S.AlterRetain, S.Checkpoint, S.Restore)):
            raise ClusterError(
                f"{type(stmt).__name__} is node-local admin — issue it on "
                f"a direct SQLCachedClient (the cluster uses it "
                f"internally during topology changes)")
        if isinstance(stmt, S.Explain):
            p.mode = "any_read"  # plans are identical on every node
            return p
        if isinstance(stmt, S.ShowStats):
            p.mode = "stats"
            p.meta = self._meta(stmt.table)
            return p
        meta = self._meta(stmt.table)
        p.meta = meta
        if isinstance(stmt, S.Insert):
            p.mode = "group_write"
            p.groups = [meta.groups[self._insert_slot(meta, stmt, params)]]
            return p
        if isinstance(stmt, S.Select):
            slot = self._where_slot(meta, stmt.where, params)
            p.agg = stmt.agg
            p.order_by, p.descending = stmt.order_by, stmt.descending
            p.limit = stmt.limit
            if slot is not _FANOUT:
                p.mode = "group_read"
                p.groups = [meta.groups[slot]]
                return p
            if stmt.agg is not None:
                p.mode = "agg_read"
                p.div = meta.replicas
                if stmt.agg[0].upper() == "AVG":
                    p.sqls = _avg_rewrite(sql)
                return p
            if not meta.spread:
                p.mode = "group_read"
                p.groups = [meta.groups[None]]
                return p
            # spread fan-out row read: merge must recompute each row's
            # slot and (for ORDER BY) re-sort — both need the columns
            cols = stmt.columns
            if cols and meta.pcol not in cols:
                raise ClusterError(
                    f"fan-out SELECT on spread table {stmt.table!r} must "
                    f"project the partition column {meta.pcol!r} (or *) "
                    f"so the merge can de-duplicate replicas")
            if stmt.order_by and cols and stmt.order_by not in cols:
                raise ClusterError(
                    f"fan-out ORDER BY {stmt.order_by!r} must be in the "
                    f"projection so the merge can re-sort")
            p.mode = "rows_fanout"
            return p
        if isinstance(stmt, (S.Update, S.Delete)):
            slot = self._where_slot(meta, stmt.where, params)
            if slot is not _FANOUT:
                p.mode = "group_write"
                p.groups = [meta.groups[slot]]
            elif not meta.spread:
                p.mode = "group_write"
                p.groups = [meta.groups[None]]
            else:
                p.mode = "fanall_write"
                p.div = meta.replicas
            return p
        if isinstance(stmt, (S.Expire, S.Flush, S.Reindex, S.AlterReshard)):
            if meta.spread:
                p.mode = "fanall_write"
                p.div = meta.replicas
            else:
                p.mode = "group_write"
                p.groups = [meta.groups[None]]
            return p
        raise ClusterError(f"unroutable statement: {sql!r}")

    def _insert_slot(self, meta: _TableMeta, stmt: S.Insert, params):
        if not meta.spread:
            return None
        try:
            idx = stmt.columns.index(meta.pcol)
        except ValueError:
            return self._slot_of(0)  # defaulted partition value
        node = stmt.values[idx]
        if isinstance(node, P.Const):
            v = node.value
        elif isinstance(node, P.Param):
            v = params[node.index]
        else:
            raise ClusterError(
                f"cluster INSERT needs a literal or ? for partition "
                f"column {meta.pcol!r} (a row lives on exactly one group)")
        return self._slot_of(v)

    @staticmethod
    def _slot_of(v) -> int:
        return shard_of_host(int(v), NSLOTS)

    def _where_slot(self, meta: _TableMeta, where, params):
        """The single cluster slot a WHERE prunes to, or _FANOUT. Reuses
        the single-node shard planner: same eq-on-partition-column rule,
        same hash."""
        if not meta.spread or where is None:
            return None if not meta.spread else _FANOUT
        route = PL.plan_shards(meta.schema, where)
        if route.key is None:
            return _FANOUT
        return self._slot_of(route.key.resolve(params))

    # ----------------------------------------------------------- assembling
    def _plan_sends(self, p: _Pending):
        """Expand one pending statement into (node, tag, sql, key) sends.
        Called at collect/dispatch time so it sees current health."""
        sends: list[tuple[str, str, str, tuple]] = []
        if p.mode == "local":
            return sends
        if p.mode in ("create", "drop", "fanall_write"):
            live = self._live_nodes()
            if not live:
                raise ClusterError("no live nodes")
            p.groups = [tuple(live)]
            tag = self._next_tag()
            for n in live:
                sends.append((n, tag, p.sqls[0], (0, n, 0)))
        elif p.mode == "group_write":
            for gi, members in enumerate(p.groups):
                live = self._live(members)
                if not live:
                    raise ClusterError(
                        f"no live replica for {p.sql!r} "
                        f"(group {tuple(members)})")
                tag = self._next_tag()  # SAME tag on every mirror
                for m in live:
                    sends.append((m, tag, p.sqls[0], (gi, m, 0)))
        elif p.mode in ("group_read", "any_read"):
            groups = p.groups or [tuple(self._live_nodes())]
            p.groups = groups
            for gi, members in enumerate(groups):
                live = self._live(members)
                if not live:
                    raise ClusterError(
                        f"no live replica for {p.sql!r} "
                        f"(group {tuple(members)})")
                reader = live[self._rr_next() % len(live)]
                sends.append((reader, self._next_tag(), p.sqls[0],
                              (gi, reader, 0)))
        elif p.mode in ("agg_read", "stats"):
            live = self._live_nodes()
            if not live:
                raise ClusterError("no live nodes")
            p.groups = [tuple(live)]
            for n in live:
                for si, q in enumerate(p.sqls):
                    sends.append((n, self._next_tag(), q, (0, n, si)))
        elif p.mode == "rows_fanout":
            # cover assignment: every slot read exactly once, deduped by
            # node — the merge keeps only each node's assigned slots
            meta = p.meta
            assign: dict[str, set[int]] = {}
            for slot, members in meta.groups.items():
                live = self._live(members)
                if not live:
                    raise ClusterError(
                        f"no live replica for slot {slot} of "
                        f"{meta.schema.name!r}")
                assign.setdefault(
                    live[self._rr_next() % len(live)], set()).add(slot)
            p.node_slots = assign
            for n in assign:
                sends.append((n, self._next_tag(), p.sqls[0], (0, n, 0)))
        else:  # pragma: no cover
            raise ClusterError(f"bad mode {p.mode!r}")
        return sends

    # -------------------------------------------------------------- merging
    def _merge(self, p: _Pending) -> dict:
        """Fold per-member responses into ONE result dict. Assumes the
        transport layer already ran fallbacks; raises ClusterError when a
        required response is missing and RuntimeError (verbatim) when the
        authoritative member reported a statement error."""
        if p.mode == "local":
            return p.local
        if p.mode in ("create", "drop"):
            return self._first_of_group(p, 0)
        if p.mode == "group_write":
            res = None
            for gi in range(len(p.groups)):
                res = self._first_of_group(p, gi)
            return res
        if p.mode in ("group_read", "any_read"):
            return self._first_of_group(p, 0)
        if p.mode == "fanall_write":
            counts, value = [], None
            for (gi, n, si), r in sorted(p.resp.items()):
                r = self._raise_err(r)
                counts.append(r["count"])
                if value is None:
                    value = r["value"]
            if not counts:
                raise ClusterError(f"write unacknowledged: {p.sql!r}")
            return {"count": sum(counts) // max(1, p.div),
                    "value": value, "rows": []}
        if p.mode == "stats":
            per = {n: self._raise_err(r)["value"]
                   for (gi, n, si), r in sorted(p.resp.items())}
            return {"count": len(per), "value": {"cluster_stats": per},
                    "rows": []}
        if p.mode == "agg_read":
            return self._merge_agg(p)
        if p.mode == "rows_fanout":
            return self._merge_rows(p)
        raise ClusterError(f"bad mode {p.mode!r}")  # pragma: no cover

    @staticmethod
    def _raise_err(r):
        if isinstance(r, Exception):
            raise r
        return r

    def _first_of_group(self, p: _Pending, gi: int) -> dict:
        """The group's authoritative response: first member IN GROUP
        ORDER that answered — i.e. the (possibly just-promoted) primary."""
        members = p.groups[gi]
        for m in members:
            r = p.resp.get((gi, m, 0))
            if r is not None:
                return self._raise_err(r)
        raise ClusterError(
            f"no replica of group {tuple(members)} answered: {p.sql!r}")

    def _merge_agg(self, p: _Pending) -> dict:
        fn = p.agg[0].upper()
        vals: list[list[Any]] = [[] for _ in p.sqls]
        for (gi, n, si), r in sorted(p.resp.items()):
            r = self._raise_err(r)
            vals[si].append(r["value"])
        if not vals[0]:
            raise ClusterError(f"no node answered: {p.sql!r}")
        nums = [v for v in vals[0] if v is not None]
        if fn == "AVG":
            total = sum(v for v in vals[0] if v is not None)
            cnt = sum(v for v in vals[1] if v is not None)
            value = (total / cnt) if cnt else 0.0
        elif fn in ("COUNT", "SUM"):
            value = sum(nums)
            if p.div > 1:
                # every row has `replicas` live copies when healthy
                value = (value // p.div if isinstance(value, int)
                         else value / p.div)
        elif fn == "MIN":
            value = min(nums) if nums else None
        elif fn == "MAX":
            value = max(nums) if nums else None
        else:
            raise ClusterError(f"unmergeable aggregate {fn!r}")
        return {"count": 0, "value": value, "rows": []}

    def _merge_rows(self, p: _Pending) -> dict:
        pcol = p.meta.pcol
        rows: list[dict] = []
        for (gi, n, si), r in sorted(p.resp.items()):
            r = self._raise_err(r)
            owned = p.node_slots.get(n, set())
            for row in r["rows"]:
                if self._slot_of(row[pcol]) in owned:
                    rows.append(row)
        if p.order_by:
            rows.sort(key=lambda row: row[p.order_by],
                      reverse=p.descending)
        if p.limit is not None:
            rows = rows[: p.limit]
        return {"count": len(rows), "value": None, "rows": rows}

    # --------------------------------------------------------------- health
    def mark_down(self, node: str) -> None:
        self._down.add(_norm_node(node))

    def mark_up(self, node: str) -> None:
        self._down.discard(_norm_node(node))

    def show_cluster(self) -> dict:
        """The SHOW CLUSTER report (client-side — this layer owns the
        topology). ``value`` mirrors what a VALUE row would carry."""
        nodes = [{"node": n,
                  "status": "down" if n in self._down else "up"}
                 for n in self._ring.nodes]
        tables = {}
        for t, m in self._tables.items():
            primaries: dict[str, int] = {}
            for members in m.groups.values():
                live = self._live(members)
                if live:
                    primaries[live[0]] = primaries.get(live[0], 0) + 1
            tables[t] = {"replicas": m.replicas, "spread": m.spread,
                         "slots": NSLOTS if m.spread else 1,
                         "partition_by": m.pcol,
                         "primary_of": primaries}
        return {"count": len(nodes), "rows": [],
                "value": {"nodes": nodes, "nslots": NSLOTS,
                          "tables": tables}}


_FANOUT = object()  # sentinel: statement visits every slot


class ClusterClient(_ClusterBase):
    """Synchronous cluster client: one :class:`SQLCachedClient` per
    daemon, consistent-hash routing, write mirroring, read failover and
    live topology changes. See the module docstring for semantics.

    ``execute`` is a one-statement pipeline; :meth:`pipeline` batches —
    statements fan out per node in one flush each and responses merge in
    submission order."""

    def __init__(self, nodes, *, timeout: float = 30.0,
                 connect_retries: int = 5, retry_base: float = 0.05,
                 retry_cap: float = 2.0, statement_retries: int = 4,
                 replica_default: int = 1,
                 checkpoint_dir: str | None = None):
        super().__init__(nodes, replica_default=replica_default,
                         statement_retries=statement_retries,
                         retry_base=retry_base, retry_cap=retry_cap)
        self.timeout = timeout
        self.connect_retries = connect_retries
        self._conns: dict[str, SQLCachedClient] = {}
        self._ckdir = checkpoint_dir
        self._ckno = 0

    # ------------------------------------------------------------ transport
    def _conn(self, node: str) -> SQLCachedClient:
        c = self._conns.get(node)
        if c is None:
            host, port = _node_addr(node)
            try:
                c = SQLCachedClient(
                    host, port, timeout=self.timeout,
                    connect_retries=self.connect_retries,
                    retry_base=self.retry_base, retry_cap=self.retry_cap)
            except OSError:
                self.mark_down(node)
                raise
            self._conns[node] = c
        return c

    def _drop_conn(self, node: str) -> None:
        c = self._conns.pop(node, None)
        if c is not None:
            try:
                c._sock.close()
            except OSError:
                pass

    def _fail_node(self, node: str) -> None:
        self.mark_down(node)
        self._drop_conn(node)

    def _exec_on(self, node: str, sql: str,
                 params: Sequence[Any] = ()) -> dict:
        """One tagged statement on one node (reconnect-once). Used by
        fallback reads and topology plumbing; raises ConnectionError
        (caller decides about marking down) or RuntimeError (server ERR)."""
        for attempt in (0, 1):
            conn = self._conn(node)
            tag = self._next_tag()
            frame = [f"EXEC#{tag} {sql}"]
            frame += [_encode_arg(v) for v in params]
            frame.append(f"GO#{tag}")
            try:
                conn._sock.sendall(("\r\n".join(frame) + "\r\n").encode())
                return conn._read_result(tag)
            except OSError as e:
                self._drop_conn(node)
                if attempt:
                    raise ConnectionError(f"{node}: {e}") from e
        raise AssertionError  # pragma: no cover

    # ------------------------------------------------------------ execution
    def execute(self, sql: str, params: Sequence[Any] = ()) -> dict:
        pl = self.pipeline()
        pl.execute(sql, params)
        res = pl.collect(return_exceptions=True)[0]
        if isinstance(res, Exception):
            raise res
        return res

    def pipeline(self) -> "ClusterPipeline":
        return ClusterPipeline(self)

    def warmup(self, table: str, like: str | None = None) -> int:
        """Pre-plan ``table``'s executors on EVERY live node serving it
        (``WARMUP t [LIKE ...]`` fan-out — reads load-balance across
        replicas, so a single-node WARMUP would leave the others cold).
        Returns the total number of newly compiled executables."""
        sql = f"WARMUP {table}"
        if like is not None:
            sql += " LIKE '" + like.replace("'", "''") + "'"
        members: set[str] = set()
        meta = self._tables.get(table)
        if meta is not None:
            for mem in meta.groups.values():
                members.update(mem)
        else:
            members.update(self._ring.nodes)
        new = 0
        for node in sorted(members):
            if node in self._down:
                continue
            try:
                new += int(self._exec_on(node, sql)["count"])
            except (ConnectionError, OSError):
                self._fail_node(node)
        return new

    def metrics(self, table: str | None = None) -> dict:
        """Fan ``SHOW METRICS [t]`` out to every live node and merge the
        telemetry reports into one pane of glass. Raw histogram buckets
        SUM across nodes (exact) and percentiles are recomputed from the
        merged buckets — never percentile-of-percentile
        (``telemetry.merge_reports``). With a table, only the nodes of
        its replica groups are asked (like :meth:`warmup`); nodes that
        answer ERR (e.g. a table they don't serve) are skipped."""
        sql = "SHOW METRICS" + (f" {table}" if table is not None else "")
        members: set[str] = set()
        meta = self._tables.get(table) if table is not None else None
        if meta is not None:
            for mem in meta.groups.values():
                members.update(mem)
        else:
            members.update(self._ring.nodes)
        reports = []
        for node in sorted(members):
            if node in self._down:
                continue
            try:
                rep = self._exec_on(node, sql)["value"]
            except (ConnectionError, OSError):
                self._fail_node(node)
                continue
            except RuntimeError:
                continue  # node ERR'd (no such table there) — skip it
            if isinstance(rep, dict):
                reports.append(rep)
        return TEL.merge_reports(reports)

    def ping_all(self, deadline: float | None = None) -> dict[str, bool]:
        """Probe every ring node; marks failures down (and successful
        probes up). The sync health check behind SHOW CLUSTER."""
        out = {}
        for n in list(self._ring.nodes):
            try:
                c = self._conn(n)
                if deadline is not None:
                    c._sock.settimeout(deadline)
                try:
                    ok = c.ping()
                finally:
                    if deadline is not None:
                        c._sock.settimeout(self.timeout)
            except OSError:
                ok = False
            out[n] = ok
            if ok:
                self.mark_up(n)
            else:
                self._fail_node(n)
        return out

    def close(self) -> None:
        for n in list(self._conns):
            c = self._conns.pop(n)
            try:
                c.close()
            except OSError:
                pass

    # ------------------------------------------------------------ fallbacks
    def _finish(self, p: _Pending) -> dict:
        """Run read fallbacks for missing responses, then merge."""
        if p.mode in ("group_read", "any_read"):
            for gi, members in enumerate(p.groups):
                got = any((gi, m, 0) in p.resp for m in members)
                if not got:
                    node, res = self._read_retry(members, p.sqls[0],
                                                 p.params, p.sql)
                    p.resp[(gi, node, 0)] = res
        elif p.mode == "rows_fanout":
            missing = [slot for slot, members in p.meta.groups.items()
                       if not any(self._slot_answered(p, slot, n)
                                  for n in p.node_slots)]
            if missing:
                self._rows_fallback(p, missing)
        elif p.mode == "agg_read":
            # a dead node's shard of the data survives on its replicas —
            # which DID answer; fan-all agg just folds what it got (the
            # /replicas deflation is documented healthy-cluster-exact)
            pass
        return self._merge(p)

    def _slot_answered(self, p: _Pending, slot: int, node: str) -> bool:
        return (slot in p.node_slots.get(node, ())
                and isinstance(p.resp.get((0, node, 0)), dict))

    def _rows_fallback(self, p: _Pending, slots: list) -> None:
        """Re-cover slots whose reader died: reassign each to a surviving
        member and re-execute (with backoff) once per new node."""
        assign: dict[str, set] = {}
        for slot in slots:
            live = self._live(p.meta.groups[slot])
            if not live:
                raise ClusterError(
                    f"no live replica for slot {slot} of "
                    f"{p.meta.schema.name!r}")
            assign.setdefault(
                live[self._rr_next() % len(live)], set()).add(slot)
        for node, owned in assign.items():
            _, res = self._read_retry(
                [node] + [m for s in owned
                          for m in p.meta.groups[s] if m != node],
                p.sqls[0], p.params, p.sql)
            p.node_slots[node] = p.node_slots.get(node, set()) | owned
            p.resp[(0, node, 0)] = res

    def _read_retry(self, members, sql, params,
                    orig: str) -> tuple[str, dict]:
        """Failover read: try live members round-robin with capped
        exponential backoff + jitter; server ERRs surface verbatim (a
        statement error is not a node failure)."""
        last: Exception | None = None
        for delay in itertools.chain(
                [0.0], backoff_delays(self.statement_retries,
                                      self.retry_base, self.retry_cap)):
            if delay:
                time.sleep(delay)
            live = self._live(members)
            if not live:
                break
            node = live[self._rr_next() % len(live)]
            try:
                return node, self._exec_on(node, sql, params)
            except (ConnectionError, OSError) as e:
                self._fail_node(node)
                last = e
        raise ClusterError(
            f"no live replica answered {orig!r} "
            f"(group {tuple(members)}): {last}")

    # ------------------------------------------------------------- topology
    def _ck_path(self, table: str) -> str:
        if self._ckdir is None:
            self._ckdir = tempfile.mkdtemp(prefix="sqlcached-cluster-ck-")
        self._ckno += 1
        return f"{self._ckdir}/{table}-{self._ckno}"

    def add_node(self, node) -> dict:
        """Join a FRESH daemon: replay every CREATE on it, remap the
        ring (~1/N of slots move), bulk-bootstrap via CHECKPOINT/RESTORE
        from the donor covering the most gained slots, RETAIN down to the
        owned set, row-replay the remainder, then trim the shrunk old
        holders. Returns a per-table movement report."""
        name = _norm_node(node)
        old = {t: dict(m.groups) for t, m in self._tables.items()}
        self._ring.add(name)
        self.mark_up(name)
        report: dict[str, dict] = {}
        for t, meta in self._tables.items():
            self._exec_on(name, meta.create_sql)
            new_groups = self._compute_groups(t, meta.spread, meta.replicas)
            gained = [k for k, mem in new_groups.items()
                      if name in mem and name not in old[t].get(k, ())]
            moved = self._bootstrap(name, t, meta, gained, old[t],
                                    fresh=True,
                                    owned=[k for k, mem in new_groups.items()
                                           if name in mem])
            self._trim_losers(t, meta, old[t], new_groups, exclude=(name,))
            meta.groups = new_groups
            # pre-plan the joiner's executors before the ring routes
            # traffic at it — a fresh node must not pay first-hit
            # compiles inside the serving path (core/execache.py)
            self._exec_on(name, f"WARMUP {t}")
            report[t] = {"gained": len(gained), "moved_rows": moved}
        return report

    def remove_node(self, node) -> dict:
        """Take a node out — decommission or post-crash cleanup (works
        whether or not the process still runs). Each group it served
        gains the next ring successor, bootstrapped from a surviving
        member (CHECKPOINT/RESTORE when the gainer holds nothing of the
        table, row replay otherwise). Returns a movement report."""
        name = _norm_node(node)
        self._ring.remove(name)
        self.mark_down(name)
        self._drop_conn(name)
        report: dict[str, dict] = {}
        for t, meta in self._tables.items():
            old_groups = dict(meta.groups)
            new_groups = self._compute_groups(t, meta.spread, meta.replicas)
            gains: dict[str, list] = {}
            for k, mem in new_groups.items():
                for m in mem:
                    if m not in old_groups.get(k, ()):
                        gains.setdefault(m, []).append(k)
            moved = 0
            for gainer, keys in gains.items():
                moved += self._bootstrap(gainer, t, meta, keys, old_groups,
                                         fresh=False,
                                         owned=[k for k, mem
                                                in new_groups.items()
                                                if gainer in mem])
            meta.groups = new_groups
            report[t] = {"gainers": len(gains), "moved_rows": moved}
        self.mark_down(name)  # stays down until re-added
        return report

    def _bootstrap(self, dest: str, table: str, meta: _TableMeta,
                   keys: list, old_groups: dict, *, fresh: bool,
                   owned: list) -> int:
        """Move the data for ``keys`` (slots, or [None] for whole-table)
        onto ``dest``. ``fresh`` means dest verifiably holds nothing of
        the table, enabling the bulk CHECKPOINT/RESTORE path."""
        if not keys:
            return 0
        donors: dict[Any, str] = {}
        for k in keys:
            d = next((m for m in old_groups.get(k, ())
                      if m not in self._down and m != dest), None)
            if d is not None:
                donors[k] = d
        if not donors:
            return 0  # nothing live to copy from (data only on dest)
        moved = 0
        replay_keys = dict(donors)
        if fresh:
            # bulk path: one donor's snapshot, restored through the
            # daemon's RESHARD re-split, then trimmed to the owned slots
            by_donor: dict[str, list] = {}
            for k, d in donors.items():
                by_donor.setdefault(d, []).append(k)
            best = max(by_donor, key=lambda d: len(by_donor[d]))
            ck = self._ck_path(table)
            r = self._exec_on(best, f"CHECKPOINT {table} TO '{ck}'")
            self._exec_on(dest, f"RESTORE {table} FROM '{ck}'")
            moved += r["count"]
            if meta.spread:
                slot_list = ",".join(str(s) for s in sorted(owned))
                self._exec_on(dest, f"ALTER TABLE {table} RETAIN SLOTS "
                                    f"{slot_list} OF {NSLOTS}")
            # the snapshot delivered EVERY owned slot best was a member
            # of — not just the slots donor-mapped to best; replaying
            # those too would duplicate rows on dest
            for k in list(replay_keys):
                if best in old_groups.get(k, ()):
                    replay_keys.pop(k)
            if not meta.spread:
                return moved
        # row replay for the rest (and for non-fresh gainers, where a
        # whole-table RESTORE would clobber the slots they already hold)
        by_donor = {}
        for k, d in replay_keys.items():
            by_donor.setdefault(d, []).append(k)
        for d, ks in by_donor.items():
            moved += self._replay_rows(table, meta, ks, d, dest)
        return moved

    def _replay_rows(self, table: str, meta: _TableMeta, keys: list,
                     donor: str, dest: str) -> int:
        """SELECT * on the donor, keep rows of the moving slots, INSERT
        them on dest (pipelined). Bounded by MAX_SELECT; payloads don't
        cross the wire — documented limits of the replay path."""
        res = self._exec_on(donor, f"SELECT * FROM {table}")
        rows = res["rows"]
        if meta.spread and keys != [None]:
            want = set(keys)
            rows = [r for r in rows
                    if self._slot_of(r[meta.pcol]) in want]
        if not rows:
            return 0
        cols = [c.name for c in meta.schema.columns]
        sql = (f"INSERT INTO {table} ({', '.join(cols)}) "
               f"VALUES ({', '.join('?' for _ in cols)})")
        frames: list[str] = []
        tags: list[str] = []
        for row in rows:
            tag = self._next_tag()
            frames.append(f"EXEC#{tag} {sql}")
            frames += [_encode_arg(row[c]) for c in cols]
            frames.append(f"GO#{tag}")
            tags.append(tag)
        conn = self._conn(dest)
        conn._sock.sendall(("\r\n".join(frames) + "\r\n").encode())
        for tag in tags:
            conn._read_result(tag)
        return len(rows)

    def _trim_losers(self, table: str, meta: _TableMeta, old: dict,
                     new: dict, exclude=()) -> None:
        losers: dict[str, list] = {}
        for k, mem in old.items():
            for m in mem:
                if m in exclude or m in self._down:
                    continue
                if m not in new.get(k, ()):
                    losers.setdefault(m, []).append(k)
        for m, lost in losers.items():
            if meta.spread:
                owned = sorted(k for k, mem in new.items() if m in mem)
                if owned:
                    slots = ",".join(str(s) for s in owned)
                    self._exec_on(m, f"ALTER TABLE {table} RETAIN SLOTS "
                                     f"{slots} OF {NSLOTS}")
                else:
                    self._exec_on(m, f"FLUSH {table}")
            else:
                self._exec_on(m, f"FLUSH {table}")


class ClusterPipeline:
    """Pipelined cluster statements: each ``execute`` routes immediately;
    ``collect`` fans the frames out per node (one flush per node), reads
    every node's responses in ITS submission order, runs failover for
    anything a dead node left unanswered, and merges per-statement
    results back into global submission order — exactly one entry per
    queued statement, always."""

    def __init__(self, cc: ClusterClient):
        self._cc = cc
        self._stmts: list[_Pending] = []
        self.results: list = []

    def __len__(self) -> int:
        return len(self._stmts)

    def execute(self, sql: str, params: Sequence[Any] = ()) -> int:
        self._stmts.append(self._cc._route(sql, params))
        return len(self._stmts) - 1

    def collect(self, return_exceptions: bool = False) -> list:
        cc = self._cc
        bufs: dict[str, list[str]] = {}
        expect: dict[str, list[tuple[str, _Pending, tuple]]] = {}
        route_errors: dict[int, Exception] = {}
        for i, p in enumerate(self._stmts):
            try:
                for node, tag, sql, key in cc._plan_sends(p):
                    frame = [f"EXEC#{tag} {sql}"]
                    frame += [_encode_arg(v) for v in p.params]
                    frame.append(f"GO#{tag}")
                    bufs.setdefault(node, []).extend(frame)
                    expect.setdefault(node, []).append((tag, p, key))
            except ClusterError as e:
                route_errors[i] = e
        # one flush per node; a dead socket fails the node, not the batch
        for node, lines in bufs.items():
            try:
                cc._conn(node)._sock.sendall(
                    ("\r\n".join(lines) + "\r\n").encode())
            except OSError:
                cc._fail_node(node)
        # drain each node in its own submission order
        for node, exps in expect.items():
            conn = cc._conns.get(node)
            if conn is None or node in cc._down:
                continue
            for tag, p, key in exps:
                try:
                    p.resp[key] = conn._read_result(tag)
                except RuntimeError as e:
                    p.resp[key] = e  # server ERR: an answer, not a death
                except OSError:
                    cc._fail_node(node)
                    break
        # failover + merge, in submission order
        out: list = []
        errs: list[Exception] = []
        for i, p in enumerate(self._stmts):
            if i in route_errors:
                out.append(route_errors[i])
                errs.append(route_errors[i])
                continue
            try:
                out.append(cc._finish(p))
            except Exception as e:  # noqa: BLE001 — per-stmt isolation
                out.append(e)
                errs.append(e)
        self._stmts.clear()
        self.results = out
        if errs and not return_exceptions:
            raise errs[0]
        return out

    def __enter__(self) -> "ClusterPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.collect(return_exceptions=True)


class AsyncClusterClient(_ClusterBase):
    """Asyncio cluster client: one :class:`AsyncSQLCachedClient` per
    node. ``execute`` coroutines may run concurrently (``gather``) —
    each fans out to its target nodes through the per-node multiplexing
    clients, so N in-flight statements still cost one round trip. Write
    mirroring, acks and read failover follow the sync client's
    semantics; topology changes (add/remove node) live on the sync
    client only."""

    def __init__(self, nodes, *, timeout: float = 30.0,
                 connect_retries: int = 5, retry_base: float = 0.05,
                 retry_cap: float = 2.0, statement_retries: int = 4,
                 replica_default: int = 1):
        super().__init__(nodes, replica_default=replica_default,
                         statement_retries=statement_retries,
                         retry_base=retry_base, retry_cap=retry_cap)
        self.timeout = timeout
        self.connect_retries = connect_retries
        self._conns: dict[str, Any] = {}

    async def _conn(self, node: str):
        from repro_torch.core.protocol import AsyncSQLCachedClient

        c = self._conns.get(node)
        if c is None:
            host, port = _node_addr(node)
            try:
                c = await AsyncSQLCachedClient.connect(
                    host, port, connect_retries=self.connect_retries,
                    retry_base=self.retry_base, retry_cap=self.retry_cap)
            except OSError:
                self.mark_down(node)
                raise
            self._conns[node] = c
        return c

    async def _drop_conn(self, node: str) -> None:
        c = self._conns.pop(node, None)
        if c is not None:
            try:
                await c.close()
            except Exception:  # noqa: BLE001
                pass

    async def _fail_node(self, node: str) -> None:
        self.mark_down(node)
        await self._drop_conn(node)

    async def _exec_on(self, node: str, sql: str,
                       params: Sequence[Any] = ()) -> dict:
        import asyncio

        conn = await self._conn(node)
        try:
            return await asyncio.wait_for(conn.execute(sql, params),
                                          self.timeout)
        except asyncio.TimeoutError as e:
            raise ConnectionError(f"{node}: statement timeout") from e

    async def execute(self, sql: str, params: Sequence[Any] = ()) -> dict:
        import asyncio

        p = self._route(sql, params)
        if p.mode == "local":
            return p.local
        sends = self._plan_sends(p)

        async def one(node, tag, q, key):
            try:
                p.resp[key] = await self._exec_on(node, q, p.params)
            except RuntimeError as e:
                p.resp[key] = e
            except (ConnectionError, OSError):
                await self._fail_node(node)

        await asyncio.gather(*(one(*s) for s in sends))
        # read failover: re-send anything a dead node left unanswered
        if p.mode in ("group_read", "any_read"):
            for gi, members in enumerate(p.groups):
                if not any((gi, m, 0) in p.resp for m in members):
                    node, res = await self._read_retry(members, p.sqls[0],
                                                       p.params, sql)
                    p.resp[(gi, node, 0)] = res
        elif p.mode == "rows_fanout":
            missing = [s for s, members in p.meta.groups.items()
                       if not any(
                           s in p.node_slots.get(n, ())
                           and isinstance(p.resp.get((0, n, 0)), dict)
                           for n in p.node_slots)]
            for slot in missing:
                node, res = await self._read_retry(
                    p.meta.groups[slot], p.sqls[0], p.params, sql)
                p.node_slots[node] = (p.node_slots.get(node, set())
                                      | {slot})
                p.resp[(0, node, 0)] = res
        return self._merge(p)

    async def _read_retry(self, members, sql, params, orig):
        import asyncio

        last: Exception | None = None
        for delay in itertools.chain(
                [0.0], backoff_delays(self.statement_retries,
                                      self.retry_base, self.retry_cap)):
            if delay:
                await asyncio.sleep(delay)
            live = self._live(members)
            if not live:
                break
            node = live[self._rr_next() % len(live)]
            try:
                return node, await self._exec_on(node, sql, params)
            except (ConnectionError, OSError) as e:
                await self._fail_node(node)
                last = e
        raise ClusterError(
            f"no live replica answered {orig!r} "
            f"(group {tuple(members)}): {last}")

    async def ping_all(self, deadline: float = 2.0) -> dict[str, bool]:
        import asyncio

        out = {}
        for n in list(self._ring.nodes):
            try:
                c = await self._conn(n)
                out[n] = await c.ping(deadline=deadline)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                out[n] = False
            if out[n]:
                self.mark_up(n)
            else:
                await self._fail_node(n)
        return out

    async def close(self) -> None:
        for n in list(self._conns):
            await self._drop_conn(n)
