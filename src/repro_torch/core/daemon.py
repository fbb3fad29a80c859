"""SQLCached: the cache daemon object (port of ``repro.core.daemon``, for
single-node tables, monolithic or sharded).

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

Sharded tables (``CREATE TABLE t (...) SHARDS n [PARTITION BY col]``,
``core/shards.py``) keep one stacked state (every leaf ``[n, ...]``) and
``n`` execution LANES, each a dict of views ``leaf[i]``. A dispatch picks a
shape (``_exec_mode``): a statement (group) whose shard route is provable
on the host and lands on one shard runs the monolithic executors on that
lane (``lane``: one CUDA graph per statement shape and lane, over that
lane's views, row ids globalized in the graph); everything else runs the
stacked executors of ``core/shards.py`` on the whole stack (``stacked``),
whose kernels take the shards on one axis. Clocks stay in logical
lockstep through lazy catch-up deltas, and an op-count expiry that fires
during a lane dispatch is replayed by every other lane on its next
dispatch at the recorded time (``_Table``), as in the reference.
``SQLCached(lane_exec=False)`` sends every sharded statement to the
stacked path. EXPLAIN reports the shard route, ``SHOW STATS t`` the
per-shard skew, and ``ALTER TABLE t RESHARD n`` re-partitions live.

Mesh placement (as in the reference): when more than one device is
visible (``launch/mesh.visible_devices``), a sharded table is PLACED over
``lane_mesh_for(n)``: its stack is split into contiguous blocks, one on
each mesh device (``shards.place_lanes``), and a lane is a view of its
block. A pruned route runs the monolithic executors on its lane's device
(one graph a shape and lane, captured there); a fan-out is the fourth
dispatch shape, ``mesh``: the stacked executors run once a block on its
device and the blocks' results merge on the home device, the mesh's
first entry (``execache.MeshEntry``; a batched SELECT then touches its
returned rows block by block). RESHARD re-splits through the home device
and places the new count's mesh; CHECKPOINT saves the gathered stack (one
copy to the host a device); RESTORE places onto this daemon's mesh, so a
snapshot moves across mesh sizes. SHOW STATS and EXPLAIN report devices
from host metadata. ``SQLCached(mesh_exec=False)`` or ``REPRO_MESH=0``
keeps every table unplaced (one stack on the daemon's device).

Snapshots and the cluster tier's handover (``core/cluster.py`` drives
them): ``CHECKPOINT t TO 'dir'`` writes the table (a sharded table's
caught-up stack) and the interner's strings in ``checkpoint/store.py``'s
format, which the reference reads too; ``RESTORE t FROM 'dir'`` loads a
snapshot of any shard count, re-interns its TEXT ids and re-splits it
into the table's layout; ``ALTER TABLE t RETAIN SLOTS ... OF m`` masks
dead every row whose partition value hashes outside the listed slots.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import store as CK
from repro_torch.core import planner as PL
from repro_torch.core import predicate as P
from repro_torch.core import shards as SH
from repro_torch.core import sqlparse as S
from repro_torch.core import table as T
from repro_torch.core import telemetry as TEL
from repro_torch.core.execache import ExecutorCache
from repro_torch.core.execache import MeshEntry
from repro_torch.core.schema import ExpiryPolicy, TableSchema, make_schema
from repro_torch.launch.mesh import lane_mesh_for
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
    """One live table: its schema, its device state (a dict of tensors
    whose tensors keep their addresses: ``core/table.py``'s layout, or
    for a sharded table ``core/shards.py``'s stack), its executor cache
    and its host-side bookkeeping. ``eng`` is the module that executes
    whole-table statements against ``state`` (``core.table`` or
    ``core.shards``).

    A sharded table also has ``lanes``: lane ``i`` is shard ``i`` of the
    stack as views, which the monolithic executors take. Clock lockstep
    is LAZY, as in the reference: ``ticks_total`` counts the table's
    logical ticks, ``lane_ticks[i]`` those applied to lane i's clock, and
    every dispatch first adds the lane's deficit in the same executor
    call. ``expire_due[i]`` is None or the ``ticks_total`` at which a
    table-wide op-count expiry fired while lane i was not dispatched: its
    next dispatch replays that expiry at that time (validity only).
    ``stmt_routed`` / ``writes_routed`` / ``rows_in`` are per-shard skew
    counters (``SHOW STATS t``): pruned statements count for their shard,
    fan-out for every shard.

    ``mesh`` is the table's placement (``launch.mesh.lane_mesh_for``; None:
    unplaced). A placed table has no single ``state``: ``blocks[k]`` is the
    stack's k-th block on ``mesh[k]``, and its lanes are views of the
    blocks."""

    schema: TableSchema
    state: dict | None
    execs: ExecutorCache
    host_ops: int = 0
    eng: Any = T
    lanes: list | None = None
    mesh: tuple | None = None
    blocks: list | None = None
    lock: Any = dataclasses.field(default_factory=threading.Lock)
    ticks_total: int = 0
    lane_ticks: list = dataclasses.field(default_factory=list)
    expire_due: list = dataclasses.field(default_factory=list)
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


def _i32(x) -> np.ndarray:
    """A host int32 array (0-d for a scalar) the executor cache stages."""
    return np.asarray(x, np.int32)


def _replay_expiry(eng, xsch: TableSchema, state: dict,
                   pre_delta: torch.Tensor) -> dict:
    """``state`` with the op-count expiries its lanes still owe replayed:
    where ``pre_delta >= 0`` (0-d for a lane, [S] for the stack), the
    lane's validity after an expiry run ``pre_delta`` ticks ago (ages at
    the firing time; only validity changes, the firing dispatch already
    ticked)."""
    d = pre_delta.clamp(min=0)
    aged = dict(state, clock=state["clock"] - d, ops=state["ops"] - d)
    due = pre_delta >= 0
    if due.dim():
        due = due[:, None]
    return dict(state, valid=torch.where(
        due, eng.expire(xsch, aged)[0]["valid"], state["valid"]))


class SQLCached:
    def __init__(self, auto_expire: bool = True, lane_exec: bool = True,
                 slow_ms: float | None = None, *, warmup: bool | None = None,
                 device=None, mesh_exec: bool = True):
        self.device = resolve_device(device)
        self.tables: dict[str, _Table] = {}
        self.interner = Interner()
        # serving telemetry (core/telemetry.py): trace spans, latency
        # histograms, slow-statement ring
        self.telemetry = TEL.Telemetry(slow_ms=slow_ms)
        self.auto_expire = auto_expire
        # lane_exec=False sends every sharded statement to the stacked
        # executors (the reference's baseline regime for lane locks)
        self.lane_exec = lane_exec
        # mesh_exec=False (or REPRO_MESH=0) keeps every sharded table on
        # the daemon's device (the reference's baseline for its mesh bench)
        self.mesh_exec = mesh_exec and os.environ.get("REPRO_MESH",
                                                      "1") != "0"
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

    def _executor(self, t: _Table, key: tuple, builder, expiry: bool = True,
                  sid: int | None = None, merge=None, post=None):
        """The table's :class:`ExecEntry` for ``key`` under the current
        schema epoch (core/execache.py). An entry built through
        :meth:`_build_exec` plans both expiry variants when the flag can
        fire; a lane's entry (``sid``) primes on that lane of the shadow
        state, on the lane's device. A ``mesh`` dispatch (``key[0]``) is a
        :class:`MeshEntry` (:meth:`_mesh_entry`): ``merge`` combines the
        blocks' outputs, ``post`` = (body, args) runs after it."""
        fires = (expiry and self.auto_expire
                 and t.schema.expiry.ops_interval > 0)
        flags = (False, True) if fires else (False,)
        if key[0] == "mesh":
            return self._mesh_entry(t, key, builder, flags, merge, post)
        view = dev = None
        if sid is not None:
            per = t.schema.shards // (len(t.mesh) if t.mesh else 1)
            view = (lambda sh: SH.lane_view(sh, sid % per))
            dev = t.mesh[sid // per] if t.mesh else None
        return t.execs.get(key, builder, flags, view=view, device=dev)

    def _mesh_entry(self, t: _Table, key: tuple, builder, flags, merge,
                    post=None) -> MeshEntry:
        """A mesh fan-out's entries: the closure ``builder()`` makes, one
        entry a block (run on the block's device, on the block marked
        with its first global shard: ``shards.as_block``), ``merge(list of
        block outputs) -> outputs`` on the home device, and ``post = (body,
        args)``: ``body(block, flag, *args(rest, merged))`` a block, where
        the statement writes what the merge decides. Each part is keyed by
        the dispatch's key and its place."""
        mesh = t.mesh
        per = t.schema.shards // len(mesh)

        def in_block(k: int, fn):
            def run(st, *a):
                out = fn(SH.as_block(st, k * per), *a)
                return (SH.unblock(out[0]),) + tuple(out[1:])
            return run

        blocks = [t.execs.get(key + ("block", k, str(dev)),
                              lambda k=k: in_block(k, builder()),
                              (False,) if post else flags, device=dev)
                  for k, dev in enumerate(mesh)]

        def merge_entry(sig, build):   # views of the blocks' packed bytes
            return t.execs.get(key + ("merge", str(mesh[0]), sig), build,
                               view=lambda sh: {}, device=mesh[0])
        posts = post_args = None
        if post is not None:
            body, post_args = post
            posts = [t.execs.get(key + ("post", k, str(dev)),
                                 lambda k=k: in_block(k, body), flags,
                                 device=dev)
                     for k, dev in enumerate(mesh)]
        return MeshEntry(blocks, mesh[0], merge, merge_entry, posts,
                         post_args)

    def _sig(self, t: _Table, stmt, kind: str, b, mode: str, sid) -> tuple:
        """The dispatch signature recorded in ``t.execs.sigs`` once a shape
        is planned: (kind, parsed stmt, bucket, mode, placement), the
        reference's shape. A lane has plans of its own, so its placement
        names the lane. ``b`` is None on the singleton executors, the
        power-of-two bucket on the executemany family (INSERT always
        buckets)."""
        if mode == "mesh":
            place = ("mesh", tuple(str(d) for d in t.mesh))
        elif mode == "lane":
            devs = SH.lane_devices(t.mesh, t.schema.shards)
            place = ("dev", str(devs[sid] if devs else self.device), sid)
        else:
            place = ("dev", str(self.device))
        return (kind, stmt, b, mode, place)

    def _note_sig(self, t: _Table, stmt, kind: str, b, mode: str,
                  sid) -> None:
        t.execs.note_sig(self._sig(t, stmt, kind, b, mode, sid))

    def _target(self, t: _Table, mode: str, sid):
        """The state a dispatch of ``mode`` runs on: a lane's views, a
        placed table's blocks or the table's own state."""
        if mode == "lane":
            return t.lanes[sid]
        return t.blocks if mode == "mesh" else t.state

    def _finish_warm(self, t: _Table, entry, stmt, kind: str, b, mode: str,
                     sid, site_args: tuple) -> int:
        """Shared tail of every site's warm branch: plan the entry for
        placeholder values whose types match what ``_run_state`` passes
        (the clock catch-up deltas included), and record the signature."""
        if mode == "lane":
            lead = (_i32(0), _i32(-1))
        elif mode in ("stacked", "mesh"):
            n = t.schema.shards
            lead = (_i32(np.zeros(n)), _i32(np.full(n, -1)))
        else:
            lead = ()
        new = entry.warm(self._target(t, mode, sid), lead + tuple(site_args))
        self._note_sig(t, stmt, kind, b, mode, sid)
        return int(new)

    def _build_exec(self, xsch: TableSchema, base, mode: str, eng):
        """Wrap ``base(state, *args) -> (state, *outs)`` for one dispatch
        shape with the §4.3 op-count expiry (the flag is computed on the
        host before the dispatch, ``_expire_flag``, so choosing it is no
        device sync) and, on a sharded table, the lazy clock catch-up:

        * ``mono``:    ``fn(state, flag, *args)``;
        * ``lane``:    ``fn(lane, flag, delta, pre_delta, *args)``: ``delta``
          catches the lane's clock up to the table's logical time, and a
          ``pre_delta >= 0`` replays a table-wide expiry this lane missed,
          ``pre_delta`` ticks ago (validity only). The fired expiry covers
          this lane only;
        * ``stacked``: ``fn(stack, flag, deltas, pre_deltas, *args)``, the
          same for every shard at once;
        * ``mesh``: the ``stacked`` closure of one block (its slices of the
          deltas), which :meth:`_mesh_entry` runs once a block.

        The replay is computed on every dispatch of a table with an op
        interval and kept where due (a device select, no host branch on
        a device value)."""
        iv = xsch.expiry.ops_interval
        if mode == "mono":
            def fn(state, expire_flag, *args):
                out = base(state, *args)
                if iv > 0 and expire_flag:
                    out = (T.expire(xsch, out[0])[0],) + tuple(out[1:])
                return out

            return fn

        def fn(state, expire_flag, delta, pre_delta, *args):
            state = dict(state, clock=state["clock"] + delta,
                         ops=state["ops"] + delta)
            if iv > 0:
                state = _replay_expiry(eng, xsch, state, pre_delta)
            out = base(state, *args)
            if iv > 0 and expire_flag:
                out = (eng.expire(xsch, out[0])[0],) + tuple(out[1:])
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

    def _run_state(self, t: _Table, fn, mode: str, sid, flag: bool,
                   ticks: int, args: tuple):
        """Run an executor entry against the right state (the table's, or
        one lane's views), which it updates in place, booking the lazy
        clock catch-up. ``args`` is a host tree of numpy arrays (the bound
        values); ``ticks`` the clock ticks the executor performs. Returns
        the executor's other outputs, as fresh tensors."""
        TEL.note_mode(mode)
        if mode == "mono":
            return fn(t.state, flag, args)
        n_sh = t.schema.shards
        # a fired expiry ticks the clock once more than the base executor
        total = ticks + (1 if flag else 0)
        with t.lock:
            g0 = t.ticks_total
            t.ticks_total = g0 + total
            fire_at = g0 + ticks if flag else None
            if mode == "lane":
                old_tick = t.lane_ticks[sid]
                t.lane_ticks[sid] = g0 + total
                pre_at = t.expire_due[sid]
                t.expire_due[sid] = None
            else:
                old_ticks = list(t.lane_ticks)
                deltas = _i32([g0 - lt for lt in t.lane_ticks])
                t.lane_ticks = [g0 + total] * n_sh
                pre_ats = list(t.expire_due)
                t.expire_due = [None] * n_sh
        if mode == "lane":
            lead = (_i32(g0 - old_tick),
                    _i32(-1 if pre_at is None else g0 - pre_at))
        else:
            lead = (deltas,
                    _i32([-1 if at is None else g0 - at for at in pre_ats]))
        try:
            out = fn(self._target(t, mode, sid), flag, lead + tuple(args))
        except Exception:
            # the executor raised before it wrote the state (a bad
            # binding): un-book the ticks so the clocks do not drift
            with t.lock:
                if mode == "lane":
                    t.lane_ticks[sid] = old_tick
                    t.expire_due[sid] = pre_at
                else:
                    t.lane_ticks = old_ticks
                    t.expire_due = pre_ats
                if t.ticks_total == g0 + total:
                    t.ticks_total = g0
            raise
        if mode == "lane" and flag:
            # the boundary fired and ran on this lane: every other lane
            # replays it on its own next dispatch (armed only once the
            # dispatch has succeeded)
            with t.lock:
                for i in range(n_sh):
                    if i != sid:
                        t.expire_due[i] = fire_at
        return out

    def _note_route(self, t: _Table, sid, n: int, is_write: bool,
                    rows_in=None) -> None:
        """Per-shard skew counters of ``SHOW STATS t``: pruned traffic
        counts for its shard, fan-out (``sid`` None) for every shard."""
        with t.lock:
            if sid is None:
                t.stmt_routed += n
                if is_write:
                    t.writes_routed += n
            else:
                t.stmt_routed[sid] += n
                if is_write:
                    t.writes_routed[sid] += n
            if rows_in is not None:
                t.rows_in += rows_in

    @staticmethod
    def _insert_sids(t: _Table, pvals, n_rows: int):
        """Per-shard inserted-row counts from the host-read partition
        values (None = not readable); a monolithic table counts every row
        into its one entry."""
        if t.lanes is None:
            return np.asarray([n_rows], np.int64)
        if pvals is None:
            return None
        n_sh = t.schema.shards
        out = np.zeros(n_sh, np.int64)
        for v in pvals:
            out[SH.shard_of_host(v, n_sh)] += 1
        return out

    @staticmethod
    def _check_partition_update(t: _Table, set_cols) -> None:
        """Refuse an UPDATE of a sharded table's partition column before
        anything is counted (the lane path runs the monolithic executors,
        which know no partition)."""
        if t.lanes is None:
            return
        cols = {("_ttl" if c.upper() == "TTL" else c) for c in set_cols}
        if t.schema.partition_by in cols:
            raise ValueError(
                f"cannot UPDATE partition column "
                f"{t.schema.partition_by!r} of sharded table "
                f"{t.schema.name!r} (DELETE + INSERT instead)")

    def _caught_up_blocks(self, t: _Table) -> list:
        """A SNAPSHOT of a sharded table at its logical time, as its blocks
        on their devices (an unplaced table: one block, the stack): every
        lane's clock caught up and every deferred expiry replayed (validity
        only), so it never shows rows the lockstep engine already dropped.
        Reads the live state and writes nothing back."""
        with t.lock:
            g0 = t.ticks_total
            deltas = [g0 - lt for lt in t.lane_ticks]
            pre = [-1 if due is None else g0 - due for due in t.expire_due]
        srcs = t.blocks if t.mesh is not None else [t.state]
        per = t.schema.shards // len(srcs)
        out = []
        for k, blk in enumerate(srcs):
            dev = blk["valid"].device
            dk, pk = deltas[k * per:(k + 1) * per], pre[k * per:(k + 1) * per]
            st = SH._tree(lambda x: x.clone(), blk)
            d = T.to_device(_i32(dk), dev)
            st["clock"] = st["clock"] + d
            st["ops"] = st["ops"] + d
            if t.schema.expiry.ops_interval > 0 and max(pk) >= 0:
                st = _replay_expiry(SH, t.schema, st,
                                    T.to_device(_i32(pk), dev))
            out.append(st)
        return out

    def _caught_up(self, t: _Table) -> dict:
        """The caught-up snapshot as one stack on the daemon's device (a
        placed table's blocks gathered there)."""
        blocks = self._caught_up_blocks(t)
        if len(blocks) == 1:
            return blocks[0]
        return SH.gather_lanes(blocks, self.device)

    # ------------------------------------------- scheduler routing hooks
    def _lane_of(self, t: _Table, stmt, params_list,
                 pvals=None) -> int | None:
        """THE lane-route decision: the one lane this statement (group)
        executes on, or None for a whole-table dispatch. The scheduler's
        lock (:meth:`group_lane`) and the dispatch shape
        (:meth:`_exec_mode`) both read it, so they cannot disagree."""
        if t.lanes is None or not self.lane_exec or stmt is None:
            return None
        try:
            ids = self._shard_ids_of(t, stmt, params_list, pvals=pvals)
        except Exception:  # noqa: BLE001 — routing is best effort
            return None
        if ids is None or len(ids) != 1:
            return None
        if isinstance(stmt, S.Insert) and _bucket(
                len(params_list)) > SH.shard_capacity(t.schema):
            # a padded batch wider than one shard goes through the stacked
            # split, which chunks it
            return None
        return next(iter(ids))

    def group_lane(self, shape: StatementShape | None,
                   params_list: Sequence[Sequence[Any]]) -> int | None:
        """The execution lane a batch of same-shape statements runs on
        (None = the dispatch takes the whole table); the BatchScheduler
        locks exactly what this reports."""
        if shape is None or shape.table is None:
            return None
        t = self.tables.get(shape.table)
        if t is None:
            return None
        stmt = shape.key[1] if len(shape.key) == 2 else None
        return self._lane_of(t, stmt, params_list)

    def item_lanes(self, shape: StatementShape | None,
                   params_list: Sequence[Sequence[Any]]) -> list | None:
        """Per-statement lane routes of one group (entry i: the lane
        statement i dispatches on, None when it fans out), or None when
        lane routing does not apply. The scheduler splits a multi-lane
        group into per-lane sub-batches with it."""
        if shape is None or shape.table is None:
            return None
        t = self.tables.get(shape.table)
        if t is None or t.lanes is None or not self.lane_exec:
            return None
        stmt = shape.key[1] if len(shape.key) == 2 else None
        if stmt is None:
            return None
        return [self._lane_of(t, stmt, [pr]) for pr in params_list]

    def group_shard_ids(self, shape: StatementShape | None,
                        params_list: Sequence[Sequence[Any]]
                        ) -> frozenset | None:
        """The shard ids a batch of same-shape statements touches, when the
        host can prove them (sharded table, every statement prunes or an
        INSERT's partition values are readable); None = every shard. Two
        groups with disjoint sets commute at the scheduler."""
        if shape is None or shape.table is None:
            return None
        t = self.tables.get(shape.table)
        if t is None or not SH.is_sharded(t.schema):
            return None
        stmt = shape.key[1] if len(shape.key) == 2 else None
        if stmt is None:
            return None
        return self._shard_ids_of(t, stmt, params_list)

    def _shard_ids_of(self, t: _Table, stmt,
                      params_list: Sequence[Sequence[Any]],
                      pvals=None) -> frozenset | None:
        """Host-side shard routing of one statement (group), shared by
        :meth:`group_shard_ids` and the lane route. ``pvals`` reuses an
        INSERT's extraction."""
        n = t.schema.shards
        if isinstance(stmt, S.Insert):
            if pvals is None:
                pvals = self._insert_pvals(t, stmt, params_list)
            if pvals is None:
                return None
            return frozenset(SH.shard_of_host(v, n) for v in pvals)
        if not isinstance(stmt, (S.Select, S.Update, S.Delete)):
            return None
        route = PL.plan_shards(t.schema, self._intern_ast(stmt.where))
        if route.key is None:
            return None
        kind, v = route.key.value
        out = set()
        for pr in params_list:
            if kind == "const":
                val = v
            else:
                if v >= len(pr):
                    return None
                val = self._host_pval(pr[v])
                if val is None:
                    return None
            out.add(SH.shard_of_host(int(val), n))
        return frozenset(out)

    def _host_pval(self, val) -> int | None:
        """One bound partition-key value for host routing: TEXT interned,
        ints passed through, anything else (floats keep exact-compare
        semantics) None. The one value rule of every host router."""
        if isinstance(val, str):
            val = self.interner.intern(val)
        if isinstance(val, bool) or not isinstance(val, (int, np.integer)):
            return None
        return int(val)

    def _insert_pvals(self, t: _Table, stmt,
                      params_list: Sequence[Sequence[Any]]) -> list | None:
        """The host-readable partition value of every row of an INSERT
        batch, or None when it is not provable (a computed expression, a
        non-integer binding)."""
        pcol = t.schema.partition_by
        cols = stmt.columns or t.schema.column_names[: len(stmt.values)]
        if pcol not in cols:
            return [0] * len(params_list)  # the column's default
        vast = stmt.values[list(cols).index(pcol)]
        if isinstance(vast, P.Const) and isinstance(vast.value, int) \
                and not isinstance(vast.value, bool):
            return [int(vast.value)] * len(params_list)
        if not isinstance(vast, P.Param):
            return None
        j = vast.index
        out = []
        for pr in params_list:
            if j >= len(pr):
                return None
            val = self._host_pval(pr[j])
            if val is None:
                return None
            out.append(val)
        return out

    def _exec_mode(self, t: _Table, stmt, params_list, n_stmts: int,
                   pvals=None):
        """The dispatch shape of one statement (group), consuming the §4.3
        op-count interval: ``(mode, eng, xsch, sid, flag)`` with mode
        ``mono`` (unsharded), ``lane`` (every statement provably on shard
        ``sid``: the monolithic executors on that lane), ``stacked``
        (fan-out, several shards or an unknown route) or, on a placed
        table, ``mesh`` (the same routes, a block at a time)."""
        sid = self._lane_of(t, stmt, params_list, pvals=pvals)
        fired = self._expire_flag(t, n_stmts)
        if t.lanes is None:
            return "mono", T, t.schema, None, fired
        if sid is not None:
            return "lane", T, SH.shard_schema(t.schema), sid, fired
        if t.mesh is not None:
            return "mesh", SH, t.schema, None, fired
        return "stacked", SH, t.schema, None, fired

    def _warm_env(self, t: _Table, mode: str):
        """(eng, xsch) of a forced dispatch mode: the warm paths' twin of
        :meth:`_exec_mode`, which would consume the op interval."""
        if mode == "lane":
            return T, SH.shard_schema(t.schema)
        return t.eng, t.schema

    def _lane_offset(self, t: _Table, mode: str, sid) -> int:
        """The first global row id of a lane dispatch's shard (0 else)."""
        return sid * SH.shard_capacity(t.schema) if mode == "lane" else 0

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
        if isinstance(stmt, S.AlterReshard):
            return self._do_reshard(stmt)
        if isinstance(stmt, S.Explain):
            return self._do_explain(stmt.inner)
        if isinstance(stmt, S.ExplainAnalyze):
            return self._do_explain_analyze(stmt, params)
        if isinstance(stmt, S.Warmup):
            return self._do_warmup(stmt)
        if isinstance(stmt, S.AlterRetain):
            return self._do_retain(stmt)
        if isinstance(stmt, S.Checkpoint):
            return self._do_checkpoint(stmt)
        if isinstance(stmt, S.Restore):
            return self._do_restore(stmt)
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

        schema = make_schema(
            stmt.table,
            list(stmt.columns),
            [(n, s, _PAYLOAD_DTYPES[d]) for (n, s, d) in stmt.payloads],
            capacity=stmt.capacity,
            max_select=stmt.max_select,
            expiry=ExpiryPolicy(stmt.ttl, stmt.max_rows, stmt.ops_interval),
            indexes=stmt.indexes,
            shards=stmt.shards,
            partition_by=stmt.partition_by,
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

    def _mesh_for(self, schema: TableSchema):
        """The placement mesh this daemon gives ``schema`` (None: unplaced:
        an unsharded table, placement off, or one visible device)."""
        if not SH.is_sharded(schema) or not self.mesh_exec:
            return None
        return lane_mesh_for(schema.shards, home=self.device)

    def _layout(self, schema: TableSchema):
        """(engine, shadow builder) of a schema's layout on this device:
        the shadow is the whole state, or one block of a placed table."""
        dev = self.device
        if SH.is_sharded(schema):
            mesh = self._mesh_for(schema)
            per = schema.shards // (len(mesh) if mesh else 1)
            return SH, lambda: SH.init_state(schema, dev, per)
        return T, lambda: T.init_state(schema, dev)

    def _place(self, t: _Table, schema: TableSchema, state: dict) -> None:
        """Set ``t``'s storage to ``state`` (``schema``'s stacked layout on
        any device) placed as this daemon places ``schema``: the state and
        its lane views, or the mesh's blocks and their lane views."""
        n = schema.shards
        mesh = self._mesh_for(schema)
        t.mesh = mesh
        if mesh is None:
            t.state, t.blocks = state, None
            t.lanes = ([SH.lane_view(state, i) for i in range(n)]
                       if n > 1 else None)
        else:
            t.blocks = SH.place_lanes(mesh, state)
            t.state = None
            t.lanes = SH.disassemble_lanes(mesh, n, t.blocks)

    def _make_table(self, schema: TableSchema) -> _Table:
        n = schema.shards
        eng, init = self._layout(schema)
        t = _Table(schema, None, eng=eng,
                   lock=LK.make_lock(f"table:{schema.name}"),
                   execs=ExecutorCache(self.device, init),
                   stmt_routed=np.zeros(n, np.int64),
                   writes_routed=np.zeros(n, np.int64),
                   rows_in=np.zeros(n, np.int64))
        self._place(t, schema, (SH if n > 1 else T).init_state(schema,
                                                               self.device))
        if n > 1:
            t.lane_ticks = [0] * n
            t.expire_due = [None] * n
        return t

    def _run_blocks(self, t: _Table, key: tuple, body, args: tuple = ()):
        """An admin statement that reads no clock, on every block of a
        placed table: ``body(block, *args) -> (block, *outs)`` as one
        executor entry a block on its device. Returns each block's outs."""
        outs = []
        per = t.schema.shards // len(t.mesh)
        for k, (dev, blk) in enumerate(SH.assemble_lanes(t.mesh, t.blocks)):
            def build(k=k):
                def fn(st, flag, *a):
                    out = body(SH.as_block(st, k * per), *a)
                    return (SH.unblock(out[0]),) + tuple(out[1:])
                return fn

            e = t.execs.get(key + ("block", k, str(dev)), build, device=dev)
            outs.append(e(blk, False, args))
        return outs

    def _stale(self, t: _Table, column: str) -> int:
        """The overflow count of ``column``'s index, summed over shards
        (an admin read: one sync)."""
        srcs = t.blocks if t.mesh is not None else [t.state]
        return sum(int(b["indexes"][column]["stale"].sum()) for b in srcs)

    def _run_admin(self, t: _Table, key: tuple, body):
        """An admin statement that reads no clock (REINDEX) as an executor
        entry on the table's state: ``body(state) -> (state, *outs)`` (a
        placed table: on each block)."""
        if t.mesh is not None:
            return self._run_blocks(t, key + (t.schema,), body)
        fn = self._executor(t, key + (t.schema,),
                            lambda: lambda st, flag: body(st),
                            expiry=False)
        return self._run_state(t, fn, "mono", None, False, 0, ())

    def _run_stacked_admin(self, t: _Table, key: tuple, body):
        """FLUSH / EXPIRE: ``body(state) -> (state, *outs)`` on the whole
        table, as a dispatch of its layout (a sharded table's clocks catch
        up and its deferred expiries replay first; one tick)."""
        mode = ("mono" if t.lanes is None
                else "mesh" if t.mesh is not None else "stacked")
        fn = self._executor(
            t, (mode, None) + key + (t.schema,),
            lambda: self._build_exec(t.schema, body, mode, t.eng),
            expiry=False, merge=SH.merge_sum)
        return self._run_state(t, fn, mode, None, False, 1, ())

    def _do_reindex(self, name: str) -> Result:
        """REINDEX t: rebuild every hash index from the live rows (the
        recovery path after a bucket overflow); a sharded table rebuilds
        every shard's in one call of the build. ``value`` is the residual
        overflow (0 = probes are back). Rebuilt indexes change probe
        behaviour for every cached plan, so the schema epoch is bumped
        first, as in the reference."""
        t = self._table(name)
        if not t.schema.indexes:
            return Result(count=0, value=0)
        t.execs.bump()
        self._run_admin(t, ("reindex",),
                        lambda st: (t.eng.build_index(t.schema, st),))
        residual = sum(self._stale(t, c) for c in t.schema.indexes)
        return Result(count=len(t.schema.indexes), value=residual)

    def _do_flush(self, name: str) -> Result:
        """FLUSH keeps the schema epoch: it changes contents, not shapes,
        so every pre-planned executor stays valid."""
        t = self._table(name)
        n, = self._run_stacked_admin(t, ("flush",),
                                     lambda st: t.eng.flush(t.schema, st))
        return Result(dev={"count": n})

    def _do_expire(self, name: str) -> Result:
        t = self._table(name)
        n, = self._run_stacked_admin(t, ("expire",),
                                     lambda st: t.eng.expire(t.schema, st))
        return Result(dev={"count": n})

    def _do_show_stats(self, name: str | None) -> Result:
        """SHOW STATS t (= ``EXPLAIN t``): the per-shard skew report, live
        rows (of the caught-up snapshot: deferred expiries applied) and
        the routed-statement counters, as one JSON ``VALUE`` row; without
        a table, the daemon-wide roll-up."""
        if name is None:
            return self._do_show_stats_all()
        t = self._table(name)
        n = t.schema.shards
        if t.lanes is None:
            live = [int(T.live_count(t.state))]
        else:
            live = self._caught_up(t)["valid"].sum(
                dim=1, dtype=torch.int32).tolist()
        with t.lock:
            stmts = t.stmt_routed.tolist()
            writes = t.writes_routed.tolist()
            rows_in = t.rows_in.tolist()
            host_ops = t.host_ops
        # each lane's device from host placement metadata (no sync)
        devs = (SH.lane_devices(t.mesh, n) or [self.device] * n
                if t.lanes is not None else None)
        per = [{"shard": i, "live_rows": live[i], "statements": stmts[i],
                "writes": writes[i], "inserted_rows": rows_in[i],
                **({"device": devs[i].index or 0} if devs else {})}
               for i in range(n)]
        info = {"table": name, "shards": n,
                "devices": len(t.mesh) if t.mesh is not None else 1,
                "device": str(self.device),
                "replicas": t.schema.replicas,
                "partition_by": t.schema.partition_by,
                "capacity": t.schema.capacity,
                "shard_capacity": (SH.shard_capacity(t.schema) if n > 1
                                   else t.schema.capacity),
                "host_ops": host_ops,
                "executors": t.execs.stats_dict(),
                "per_shard": per}
        return Result(count=n, value=json.dumps(info, sort_keys=True))

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
            tables[name] = {"shards": t.schema.shards,
                            "live_rows": self.live_rows(name),
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

    def _do_reshard(self, stmt: S.AlterReshard) -> Result:
        """ALTER TABLE t RESHARD n: live re-partition through one device
        re-split of every live row of the caught-up snapshot (row metadata
        and TTL stamps ride along, so contents round-trip exactly) and one
        stacked index build. ``n = 1`` makes the table monolithic. Refused,
        the table untouched, when the skew would overflow a new shard.
        The new layout has new tensors, so every plan is retired (epoch
        bump with a new shadow state); the skew counters keep their
        totals, spread evenly over the new shards."""
        t = self._table(stmt.table)
        old_schema = t.schema
        new_n = stmt.shards
        if new_n == old_schema.shards:
            return Result(count=self.live_rows(stmt.table), value=new_n)
        try:
            new_schema = dataclasses.replace(old_schema, shards=new_n)
        except (ValueError, KeyError) as e:
            raise S.SQLError(str(e)) from e
        src = self._caught_up(t) if t.lanes is not None else t.state
        state, counts = SH.reshard(old_schema, new_schema, src)
        counts = counts.cpu().numpy()   # an admin statement: the sync is fine
        cap_new = (SH.shard_capacity(new_schema) if new_n > 1
                   else new_schema.capacity)
        if int(counts.max()) > cap_new:
            raise S.SQLError(
                f"RESHARD {new_n}: {int(counts.max())} live rows hash to "
                f"one shard but a shard holds only {cap_new} — resolve "
                f"the skew (or raise CAPACITY) first")
        self._install(t, new_schema, state,
                      stmt_routed=self._respread(t.stmt_routed, new_n),
                      writes_routed=self._respread(t.writes_routed, new_n),
                      rows_in=self._respread(t.rows_in, new_n))
        return Result(count=int(counts.sum()), value=new_n)

    def _install(self, t: _Table, schema: TableSchema, state: dict,
                 **bookkeeping) -> None:
        """Install new tensors in ``schema``'s layout (RESHARD, RESTORE),
        placed on ``schema``'s mesh, under the table's lock, with their
        lanes and every lane's clock
        taken as caught up (``bookkeeping``: more of the table's fields
        to set there); then retire every plan, whose graphs bound the old
        tensors (epoch bump with the layout's shadow builder)."""
        n = schema.shards
        eng, init = self._layout(schema)
        with t.lock:
            g0 = t.ticks_total
            t.eng, t.schema = eng, schema
            self._place(t, schema, state)
            t.lane_ticks = [g0] * n
            t.expire_due = [None] * n
            for k, v in bookkeeping.items():
                setattr(t, k, v)
        t.execs.bump(shadow=init)

    @staticmethod
    def _respread(old: np.ndarray, new_n: int) -> np.ndarray:
        """A per-shard counter through a RESHARD: the total spread evenly
        over the new shards (remainder to the low ones)."""
        total = int(old.sum())
        out = np.full(new_n, total // new_n, np.int64)
        out[: total % new_n] += 1
        return out

    # ------------------------------------------- snapshots and handover
    def _do_retain(self, stmt: S.AlterRetain) -> Result:
        """ALTER TABLE t RETAIN SLOTS i,j,... OF m: keep only the rows whose
        partition value, cast to int32, hashes (``shards.shard_of`` at
        modulus m) into one of the listed slots; every other row is masked
        dead. The cluster tier's handover primitive: after a ring change a
        node keeps the slots it still owns. Validity only, as in the
        reference: indexes and TTL stamps are untouched (probes mask dead
        rows) and no clock ticks. A sharded table takes one masked pass
        over its stacked ``valid``, which its lanes see (they are views);
        the pass is one executor entry (one graph on the card) that writes
        ``valid`` in place. ``count`` is the rows dropped, ``value`` the
        number of slots listed."""
        t = self._table(stmt.table)
        pby = t.schema.partition_by
        if pby is None:
            raise S.SQLError(
                f"RETAIN: table {stmt.table!r} has no PARTITION BY column "
                f"(cluster slot ownership needs a partition key)")
        of = stmt.of

        def body(st, slots):
            # ``slots`` is staged sorted: membership is one binary search
            slot = SH.shard_of(st["cols"][pby].to(torch.int32), of)
            at = torch.searchsorted(slots, slot).clamp(max=slots.shape[0] - 1)
            keep = st["valid"] & (slots[at] == slot)
            dropped = (st["valid"] & ~keep).sum(dtype=torch.int32)
            return dict(st, valid=keep), dropped

        key = ("retain", pby, stmt.slots, of, t.schema)
        slots = _i32(sorted(stmt.slots))
        if t.mesh is not None:
            outs = self._run_blocks(t, key, body, (slots,))
            d = SH.merge_sum([o[0].to(self.device) for o in outs])
            return Result(value=len(stmt.slots), dev={"count": d})
        fn = self._executor(t, key,
                            lambda: lambda st, flag, slots: body(st, slots),
                            expiry=False)
        d, = self._run_state(t, fn, "mono", None, False, 0, (slots,))
        return Result(value=len(stmt.slots), dev={"count": d})

    def _do_checkpoint(self, stmt: S.Checkpoint) -> Result:
        """CHECKPOINT t TO 'dir': an atomic snapshot of the table as step 0
        of ``checkpoint/store.py`` (written to ``step_0.tmp/``, renamed to
        ``step_0/``, one .npy a leaf: the reference's format). A sharded
        table saves its stack caught up to the table's logical time. TEXT
        columns hold this daemon's interner ids, so the interner's strings
        ride along in the meta and RESTORE re-interns them. An admin
        statement: the state reaches the host in one copy, its one sync.
        ``count`` is the live rows saved, ``value`` the directory."""
        t = self._table(stmt.table)
        if t.lanes is None:
            state = CK.host_copy(t.state)
        else:   # one copy to the host a device, stacked there
            blocks = CK.host_copy({str(k): b for k, b in
                                   enumerate(self._caught_up_blocks(t))})
            state = SH.gather_lanes([blocks[str(k)] for k in
                                     range(len(blocks))], "cpu")
        live = int(state["valid"].sum())
        meta = {"table": stmt.table, "shards": t.schema.shards,
                "capacity": t.schema.capacity, "live_rows": live,
                "strings": list(self.interner._rev)}
        CK.save(stmt.path, 0, state, meta=meta)
        return Result(count=live, value=stmt.path)

    def _do_restore(self, stmt: S.Restore) -> Result:
        """RESTORE t FROM 'dir': replace the table's contents with a
        CHECKPOINT snapshot, written by this package or by the reference
        (the replica bootstrap of the cluster tier). The table exists with
        a matching schema; the snapshot may have any shard count (its meta
        says which): it is loaded in ITS layout, each saved string is
        re-interned here (id 0 stays 0) and a lut rewrites every TEXT
        column, then :func:`shards.reshard` re-splits every live row into
        the table's layout and rebuilds its indexes (an equal count too,
        as the reference does: rows come out in (shard, slot) order). A
        skew that overflows a shard is refused before the table is
        touched. The new tensors are installed as RESHARD installs them
        (:meth:`_install`: every plan retired). ``count`` is the rows
        restored, ``value`` the directory."""
        t = self._table(stmt.table)
        try:
            raw = json.loads((pathlib.Path(stmt.path) / "step_0" /
                              "meta.json").read_text())
        except FileNotFoundError as e:
            raise S.SQLError(f"RESTORE: no checkpoint at {stmt.path!r} "
                             f"({e})") from e
        saved_n = int(raw.get("meta", {}).get("shards", t.schema.shards))
        try:
            saved_sch = (t.schema if saved_n == t.schema.shards
                         else dataclasses.replace(t.schema, shards=saved_n))
            like = self._layout(saved_sch)[0].init_state(saved_sch, "meta")
            state, info = CK.restore(stmt.path, 0, like, device=self.device)
        except FileNotFoundError as e:
            raise S.SQLError(f"RESTORE: no checkpoint at {stmt.path!r} "
                             f"({e})") from e
        except (KeyError, ValueError) as e:
            raise S.SQLError(
                f"RESTORE: checkpoint at {stmt.path!r} does not match "
                f"table {stmt.table!r}'s schema ({e})") from e
        strings = info.get("meta", {}).get("strings") or [""]
        text_cols = t.schema.text_columns()
        if text_cols:
            lut = np.zeros(len(strings), np.int32)
            for i, s in enumerate(strings):
                if i:   # id 0 is the empty / NULL string on every daemon
                    lut[i] = self.interner.intern(s)
            lut = T.to_device(lut, self.device)
            cols = dict(state["cols"])
            for c in text_cols:
                cols[c] = lut[cols[c].clamp(0, lut.shape[0] - 1).long()]
            state = dict(state, cols=cols)
        new_state, counts = SH.reshard(saved_sch, t.schema, state)
        counts = counts.cpu().numpy()   # an admin statement: the sync is fine
        n = t.schema.shards
        cap = SH.shard_capacity(t.schema) if n > 1 else t.schema.capacity
        if int(counts.max()) > cap:
            raise S.SQLError(
                f"RESTORE: {int(counts.max())} restored rows hash to one "
                f"shard but a shard holds only {cap}")
        self._install(t, t.schema, new_state)
        return Result(count=int(counts.sum()), value=stmt.path)

    # -------------------------------------------------- executor warm-up
    def _prunable(self, t: _Table, stmt) -> bool:
        """Can this statement take a lane route? (INSERTs route row by
        row; a WHERE prunes on a partition-key equality.)"""
        if isinstance(stmt, S.Insert):
            return True
        if not isinstance(stmt, (S.Select, S.Update, S.Delete)):
            return False
        route = PL.plan_shards(t.schema, self._intern_ast(stmt.where))
        return route.key is not None

    def _warm_modes(self, t: _Table, stmt) -> list:
        """The (mode, sid) dispatch shapes to pre-plan for ``stmt``: a
        prunable statement on a sharded table plans every lane (a graph
        binds its lane's views), anything else the one whole-table
        shape."""
        if t.lanes is None:
            return [("mono", None)]
        if self.lane_exec and self._prunable(t, stmt):
            return [("lane", i) for i in range(t.schema.shards)]
        return [("mesh" if t.mesh is not None else "stacked", None)]

    def _warm_statement(self, t: _Table, stmt) -> int:
        """Pre-plan one statement's executors for every dispatch shape it
        can take. Returns the number of newly planned executables."""
        new = 0
        for warm in self._warm_modes(t, stmt):
            if isinstance(stmt, S.Insert):
                new += self._do_insert_batch(stmt, [], None, _warm=warm)
            elif isinstance(stmt, S.Select):
                new += self._do_select(stmt, (), _warm=warm)
            elif isinstance(stmt, S.Update):
                new += self._do_update(stmt, (), _warm=warm)
            elif isinstance(stmt, S.Delete):
                new += self._do_delete(stmt, (), _warm=warm)
            else:
                raise S.SQLError(
                    "WARMUP supports SELECT/INSERT/UPDATE/DELETE shapes")
        return new

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
            prepped = [self._prep_params(p) for p in params_list]
            sid = self._lane_of(t, stmt, prepped)
            mode = ("mono" if t.lanes is None
                    else "lane" if sid is not None
                    else "mesh" if t.mesh is not None else "stacked")
            if kind == "insert":
                b = _bucket(max(n, 1))
                if mode == "mono":
                    b = min(b, t.schema.capacity)
            else:
                b = _bucket(n) if n > 1 else None
            return t.execs.has_sig(self._sig(t, stmt, kind, b, mode, sid))
        except Exception:  # noqa: BLE001 — admission is best effort
            return True

    def _preplanned(self, t: _Table, stmt) -> bool:
        """EXPLAIN's ``preplanned`` bit: every dispatch shape this
        statement can take has a planned executable (host signature set
        only, no device sync)."""
        kind = type(stmt).__name__.lower()
        b = 1 if kind == "insert" else None
        return all(t.execs.has_sig(self._sig(t, stmt, kind, b, mode, sid))
                   for mode, sid in self._warm_modes(t, stmt))

    def _do_explain(self, stmt: S.Statement) -> Result:
        """EXPLAIN <stmt>: report (don't run) the inner statement's plan
        (and a sharded table's shard route) as one VALUE row of JSON."""
        if isinstance(stmt, (S.Select, S.Update, S.Delete)):
            t = self._table(stmt.table)
            where = self._intern_ast(stmt.where)
            ranked = isinstance(stmt, S.Select) and stmt.order_by is not None
            info = PL.explain(t.schema, where, ranked=ranked)
            info["statement"] = type(stmt).__name__.lower()
            info["preplanned"] = self._preplanned(t, stmt)
            if t.mesh is not None:
                # placement from host metadata only (no sync): a
                # const-pruned route names its lane's device, anything
                # else the whole mesh
                route = PL.plan_shards(t.schema, where)
                if route.key is not None and route.key.value[0] == "const":
                    sid = SH.shard_of_host(int(route.key.value[1]),
                                           t.schema.shards)
                    info["device"] = SH.lane_devices(
                        t.mesh, t.schema.shards)[sid].index or 0
                else:
                    info["devices"] = len(t.mesh)
            if info["plan"] == "index-probe":
                # stale > 0: every probe currently takes the scan fallback
                # (a sharded table reports the total over its shards)
                info["stale"] = self._stale(t, info["index"])
            return Result(count=1, value=json.dumps(info, sort_keys=True))
        info = {"statement": type(stmt).__name__.lower(),
                "plan": "insert" if isinstance(stmt, S.Insert) else "admin"}
        table = getattr(stmt, "table", None)
        if table is not None:
            info["table"] = table
            t = self.tables.get(table)
            if t is not None and isinstance(stmt, S.Insert):
                info["preplanned"] = self._preplanned(t, stmt)
                if SH.is_sharded(t.schema):
                    # inserts hash-route row by row (one device split)
                    info["shards"] = t.schema.shards
                    info["shard_route"] = f"split x {t.schema.shards}"
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
                         per_statement: bool = False, _warm=None
                         ) -> "Result | list[Result] | int":
        """The INSERT arm of :meth:`executemany` (single INSERTs come here
        as a batch of one). ``_warm=(mode, sid)`` pre-plans the b=1
        executor of that dispatch shape from placeholder values instead of
        running (no clock tick, no op count; returns the number of new
        plans)."""
        t = self._table(stmt.table)
        schema = t.schema
        cols = stmt.columns or schema.column_names[: len(stmt.values)]
        if len(cols) != len(stmt.values):
            raise S.SQLError("INSERT column/value count mismatch")
        n_params = max((P.collect_params(v) for v in stmt.values), default=0)
        if stmt.ttl is not None:
            n_params = max(n_params, P.collect_params(stmt.ttl))
        if _warm is not None:
            n = 1
            params_list = [(0,) * n_params]
        else:
            n = len(params_list)
            if n == 0:
                return [] if per_statement else Result(count=0)
        if n > schema.capacity:
            raise S.SQLError(f"INSERT of {n} rows exceeds CAPACITY "
                             f"{schema.capacity}")
        pvals = None
        if _warm is not None:
            mode, sid = _warm
            eng, xsch = self._warm_env(t, mode)
        else:
            if t.lanes is not None:
                # ONE partition-value extraction: the lane route and the
                # inserted_rows counter both read it
                pvals = self._insert_pvals(
                    t, stmt, [self._prep_params(p) for p in params_list])
            mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, params_list,
                                                         n, pvals=pvals)
        # the padded batch takes one slot a row, so on a monolithic table
        # it never outgrows the table (padding rows are masked off); the
        # stacked insert chunks a batch wider than a shard
        b = _bucket(n) if mode == "stacked" else min(_bucket(n),
                                                     xsch.capacity)
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
        key = (mode, sid, "insert", xsch, values_ast, ttl_ast, tuple(cols), b,
               tuple(sorted(pl_args)))
        dev = self.device
        off = self._lane_offset(t, mode, sid)

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
                state, slots, ev = eng.insert(xsch, state, values, pl_args,
                                              row_mask, ttl)
                return state, slots + off, ev

            return self._build_exec(xsch, base, mode, eng)

        fn = self._executor(t, key, build, sid=sid, merge=SH.merge_sum)
        args = (param_cols, pl_args, row_mask)
        if _warm is not None:
            return self._finish_warm(t, fn, stmt, "insert", b, mode, sid,
                                     args)
        slots, evicted = self._run_state(t, fn, mode, sid, flag, 1, args)
        self._note_sig(t, stmt, "insert", b, mode, sid)
        self._note_route(t, sid, n, True,
                         rows_in=self._insert_sids(t, pvals, n))
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
        Single-column equality DELETEs take ONE pass over the table (or
        lane) (``delete_many_eq``); other DELETEs one [W, rows] mask
        (deletes commute, so the union count equals the sequential total;
        ``per_statement`` credits a row to the earliest statement). UPDATEs
        run one after another so later statements see earlier SETs."""
        t = self._table(stmt.table)
        n = len(params_list)
        if n == 0:
            return [] if per_statement else Result(count=0)
        is_delete = isinstance(stmt, S.Delete)
        if not is_delete:
            self._check_partition_update(t, (c for c, _ in stmt.sets))
        mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, params_list, n)
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
        fused = eng._fused_plan(xsch, where) if is_delete else None
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
            idx_rebuild = tuple(c for c in xsch.indexes if c in set_cols)
            update_plan = eng.plan_for(xsch, where)
            if isinstance(update_plan, PL.IndexProbe) and (
                    idx_rebuild
                    or not _np_terms_int(
                        (update_plan.key,) + update_plan.residual,
                        host_cols)):
                # rewriting the key column mid-batch would strand the
                # index entries later statements probe: scan, and rebuild
                # once after the batch
                update_plan = update_plan.fallback
        key = (mode, sid, "dml", xsch, is_delete, where, sets, b, eq_term,
               update_plan, per_statement)
        dev = self.device

        def build():
            if eq_term is not None:
                kind, v = eq_term.value

                def base(state, param_cols, active):
                    vals = (param_cols[v].to(torch.int32) if kind == "param"
                            else torch.full((b,), v, dtype=torch.int32,
                                            device=dev))
                    return eng.delete_many_eq(xsch, state, eq_term.col,
                                              vals, active,
                                              per_statement=per_statement)

                return self._build_exec(xsch, base, mode, eng)

            def base(state, param_cols, active):
                if is_delete:
                    # [b, rows]: the rows of a table, a lane or the whole
                    # flattened stack; the union / claim math is the same
                    m = (self._match_rows(eng, xsch, state, where,
                                          param_cols, b) & active[:, None])
                    hit = m.any(dim=0)
                    n_hit = hit.sum(dtype=torch.int32)
                    # a row hit by several statements counts for the
                    # EARLIEST one (later ones find it gone)
                    mi = m.to(torch.int32)
                    claimed = (torch.cumsum(mi, dim=0) - mi) > 0
                    ns = (m & ~claimed).sum(dim=1, dtype=torch.int32)
                    nact = active.sum(dtype=torch.int32)
                    valid = state["valid"] & ~hit.reshape(
                        state["valid"].shape)
                    state = T._tick(dict(state, valid=valid), nact)
                    return state, n_hit, ns

                def run(route):
                    # every lane of the bucket runs; a padding lane matches
                    # no row, and the clock then takes back its tick, so
                    # one executor serves any count in the bucket
                    st, parts = state, []
                    for i in range(b):
                        pr = tuple(c[i] for c in param_cols)
                        st, k = eng.update(xsch, st, where, dict(sets), pr,
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
                        eng.index_fresh(state, update_plan.column),
                        run(update_plan), run(update_plan.fallback))
                else:
                    st, ns = run(update_plan)
                for c in idx_rebuild:  # deferred: ONE rebuild per dispatch
                    st = eng.build_index(xsch, st, c)
                return st, ns.sum(dtype=torch.int32), ns

            return self._build_exec(xsch, base, mode, eng)

        fn = self._executor(t, key, build, sid=sid, merge=SH.merge_sum)
        kind = "delete" if is_delete else "update"
        outs = self._run_state(t, fn, mode, sid, flag, n, (host_cols, active))
        self._note_sig(t, stmt, kind, b, mode, sid)
        self._note_route(t, sid, n, True)
        if per_statement:
            stack = _HostStack({"count": outs[1]})
            return [Result(ctx={"stack": stack, "index": i})
                    for i in range(n)]
        return Result(dev={"count": outs[0]})

    @staticmethod
    def _match_rows(eng, xsch, state, where, param_cols, w: int):
        """GenericScan mask of ``w`` statements over every row of the
        dispatch's state: [w, cap] (a table or lane) or [w, shards *
        shard_capacity] (the flattened stack)."""
        if eng is T:
            return T._match_mask(xsch, state, where, param_cols, w)
        flat = dict(state, cols=SH.flat_cols(state),
                    valid=state["valid"].reshape(-1))
        return T._match_mask(dataclasses.replace(
            xsch, capacity=flat["valid"].shape[0], shards=1,
            partition_by=None), flat, where, param_cols, w)

    def _do_batch_select(self, stmt: S.Select,
                         params_list: Sequence[Sequence[Any]]
                         ) -> list[Result]:
        """W same-statement SELECTs in ONE dispatch: each kernel launches
        once for all W (``select_many``; on a sharded table once for all
        W statements on all their shards). Reads in a batch don't
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
        mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, params_list, n)
        b = _bucket(n)
        where = self._intern_ast(stmt.where)
        columns = stmt.columns or schema.column_names
        limit = stmt.limit if stmt.limit is not None else schema.max_select
        n_params = P.collect_params(where)
        param_cols = self._param_cols(params_list, n, b, n_params)
        active = np.arange(b) < n
        key = (mode, sid, "select_batch", xsch, where, tuple(columns),
               stmt.payloads, stmt.order_by, stmt.descending, limit, b,
               self._probes(eng, xsch, where, param_cols,
                            stmt.order_by is not None))
        off = self._lane_offset(t, mode, sid)
        mesh = mode == "mesh"

        def build():
            def base(state, param_cols, active):
                _, res = eng.select_many(
                    xsch, state, where, param_cols, b, columns=columns,
                    order_by=stmt.order_by, descending=stmt.descending,
                    limit=limit, with_payloads=stmt.payloads, active=active,
                    touch=False)
                if mesh:   # the touch waits for the merge (post, below)
                    return state, res
                # one epilogue for the batch: touch the returned rows and
                # advance the clock by the REAL statement count
                state = eng.batch_touch(xsch, state, res, active)
                if mode == "lane":
                    res = dict(res, row_ids=torch.where(
                        res["present"], res["row_ids"] + off, 0))
                return state, res

            return self._build_exec(xsch, base, mode, eng)

        def touch(state, flag, active, present, row_ids):
            # a placed table's epilogue, a block at a time: the rows the
            # merge returned, then the expiry this dispatch fires
            state = SH.batch_touch(xsch, state, {"present": present,
                                                 "row_ids": row_ids}, active)
            if flag and xsch.expiry.ops_interval > 0:
                state = SH.expire(xsch, state)[0]
            return (state,)

        fn = self._executor(
            t, key, build, sid=sid,
            merge=lambda outs: (SH.merge_select(
                [o[0] for o in outs], limit, stmt.order_by is not None),),
            post=(touch, lambda rest, merged: (
                rest[1], merged[0]["present"], merged[0]["row_ids"])))
        res, = self._run_state(t, fn, mode, sid, flag, n,
                               (param_cols, active))
        self._note_sig(t, stmt, "select", b, mode, sid)
        self._note_route(t, sid, n, False)
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
    def _probes(eng, xsch: TableSchema, where, host_cols,
                ranked: bool = False) -> bool:
        """Does a batch take the IndexProbe route (part of its executor's
        key, as in the reference): every probe term bound to an integer."""
        plan = eng.plan_for(xsch, where, ranked)
        return (isinstance(plan, PL.IndexProbe)
                and _np_terms_int((plan.key,) + plan.residual, host_cols))

    def _do_batch_agg(self, stmt: S.Select,
                      params_list: Sequence[Sequence[Any]]) -> list[Result]:
        """W same-shape aggregate SELECTs in ONE dispatch; the clock
        advances by the number of ACTIVE statements."""
        t = self._table(stmt.table)
        n = len(params_list)
        if n == 0:
            return []
        mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, params_list, n)
        b = _bucket(n)
        agg, col = stmt.agg
        where = self._intern_ast(stmt.where)
        n_params = P.collect_params(where)
        param_cols = self._param_cols(params_list, n, b, n_params)
        active = np.arange(b) < n
        key = (mode, sid, "agg_batch", xsch, agg, col, where, b,
               self._probes(eng, xsch, where, param_cols))

        def build():
            def base(state, param_cols, active):
                # a placed table's blocks give partials, merged at home
                _, vals = (SH.aggregate_parts if mode == "mesh"
                           else eng.aggregate_many)(xsch, state, agg, col,
                                                    where, param_cols, b)
                return T._tick(state, active.sum(dtype=torch.int32)), vals

            return self._build_exec(xsch, base, mode, eng)

        count_only = agg.upper() == "COUNT" or col is None
        fn = self._executor(
            t, key, build, sid=sid,
            merge=lambda outs: (SH.merge_aggregate(
                [o[0] for o in outs], agg, count_only),))
        vals, = self._run_state(t, fn, mode, sid, flag, n,
                                (param_cols, active))
        self._note_sig(t, stmt, "select", b, mode, sid)
        self._note_route(t, sid, n, False)
        stack = _HostStack({"value": vals})
        return [Result(ctx={"stack": stack, "index": i}) for i in range(n)]

    def _do_select(self, stmt: S.Select, params: tuple,
                   _warm=None) -> "Result | int":
        """One SELECT. ``_warm=(mode, sid)`` pre-plans its executor from
        placeholder values (one int 0 per ``?``: the plan is keyed by the
        values' types, not the values) instead of running."""
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        if _warm is None:
            mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, [params], 1)
        else:
            mode, sid = _warm
            eng, xsch = self._warm_env(t, mode)
            params = (0,) * P.collect_params(where)
        args = (self._host_params(params),)
        if stmt.agg is not None:
            agg, col = stmt.agg
            key = (mode, sid, "agg", xsch, agg, col, where)

            def agg_one(st, pr):
                if mode != "mesh":
                    return eng.aggregate(xsch, st, agg, col, where, pr)
                # a placed table's blocks give partials, merged at home
                return SH.aggregate_parts(xsch, st, agg, col, where,
                                          T._one(pr, st["valid"].device), 1)

            fn = self._executor(
                t, key,
                lambda: self._build_exec(xsch, agg_one, mode, eng),
                sid=sid,
                merge=lambda outs: (SH.merge_aggregate(
                    [o[0] for o in outs], agg,
                    agg.upper() == "COUNT" or col is None, batched=False),))
            if _warm is not None:
                return self._finish_warm(t, fn, stmt, "select", None, mode,
                                         sid, args)
            val, = self._run_state(t, fn, mode, sid, flag, 1, args)
            self._note_sig(t, stmt, "select", None, mode, sid)
            self._note_route(t, sid, 1, False)
            return Result(dev={"value": val})
        columns = stmt.columns or schema.column_names
        limit = stmt.limit if stmt.limit is not None else schema.max_select
        key = (mode, sid, "select", xsch, where, tuple(columns),
               stmt.payloads, stmt.order_by, stmt.descending, limit)
        off = self._lane_offset(t, mode, sid)

        def build():
            def base(st, pr):
                st, res = eng.select(xsch, st, where, pr, columns=columns,
                                     order_by=stmt.order_by,
                                     descending=stmt.descending, limit=limit,
                                     with_payloads=stmt.payloads)
                if mode == "lane":
                    res = dict(res, row_ids=torch.where(
                        res["present"], res["row_ids"] + off, 0))
                return st, res

            return self._build_exec(xsch, base, mode, eng)

        fn = self._executor(
            t, key, build, sid=sid,
            merge=lambda outs: (SH.merge_select(
                [o[0] for o in outs], limit, stmt.order_by is not None,
                batched=False),))
        if _warm is not None:
            return self._finish_warm(t, fn, stmt, "select", None, mode, sid,
                                     args)
        res, = self._run_state(t, fn, mode, sid, flag, 1, args)
        self._note_sig(t, stmt, "select", None, mode, sid)
        self._note_route(t, sid, 1, False)
        return Result(
            payloads=dict(res["payloads"]),
            dev={"count": res["count"], "rows": res["rows"],
                 "present": res["present"], "row_ids": res["row_ids"]},
            ctx={"columns": tuple(columns), "limit": limit,
                 "text_cols": set(schema.text_columns()),
                 "interner": self.interner},
        )

    def _do_update(self, stmt: S.Update, params: tuple,
                   _warm=None) -> "Result | int":
        t = self._table(stmt.table)
        where = self._intern_ast(stmt.where)
        sets = tuple((c, self._intern_ast(e)) for c, e in stmt.sets)
        self._check_partition_update(t, (c for c, _ in sets))
        if _warm is None:
            mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, [params], 1)
        else:
            mode, sid = _warm
            eng, xsch = self._warm_env(t, mode)
            n_params = P.collect_params(where)
            for _, e in sets:
                n_params = max(n_params, P.collect_params(e))
            params = (0,) * n_params
        args = (self._host_params(params),)
        key = (mode, sid, "update", xsch, where, sets)
        fn = self._executor(
            t, key, lambda: self._build_exec(
                xsch,
                lambda st, pr: eng.update(xsch, st, where, dict(sets), pr),
                mode, eng),
            sid=sid, merge=SH.merge_sum)
        if _warm is not None:
            return self._finish_warm(t, fn, stmt, "update", None, mode, sid,
                                     args)
        n, = self._run_state(t, fn, mode, sid, flag, 1, args)
        self._note_sig(t, stmt, "update", None, mode, sid)
        self._note_route(t, sid, 1, True)
        return Result(dev={"count": n})

    def _do_delete(self, stmt: S.Delete, params: tuple,
                   _warm=None) -> "Result | int":
        t = self._table(stmt.table)
        schema = t.schema
        where = self._intern_ast(stmt.where)
        if _warm is None:
            mode, eng, xsch, sid, flag = self._exec_mode(t, stmt, [params], 1)
        else:
            mode, sid = _warm
            eng, xsch = self._warm_env(t, mode)
            params = (0,) * P.collect_params(where)
        args = (self._host_params(params),)
        # fusable deletes on payload-bearing tables also report WHICH rows
        # went (row ids feed incremental index maintenance); scalar tables
        # keep the mask-only path. Sharded tables report global row ids.
        fused_sch = (SH.shard_schema(schema) if t.lanes is not None
                     else schema)
        returning = (T._fused_plan(fused_sch, where) is not None
                     and bool(schema.payloads))
        key = (mode, sid, "delete", xsch, where, returning)
        off = self._lane_offset(t, mode, sid)

        def build():
            def base(st, pr):
                if returning:
                    st, n, ids, present = eng.delete_returning(xsch, st,
                                                               where, pr)
                    if mode == "lane":
                        ids = torch.where(present, ids + off, 0)
                    return st, n, ids, present
                return eng.delete(xsch, st, where, pr)

            return self._build_exec(xsch, base, mode, eng)

        fn = self._executor(
            t, key, build, sid=sid,
            merge=((lambda outs: SH.merge_delete_returning(
                outs, schema.max_select)) if returning else SH.merge_sum))
        if _warm is not None:
            return self._finish_warm(t, fn, stmt, "delete", None, mode, sid,
                                     args)
        outs = self._run_state(t, fn, mode, sid, flag, 1, args)
        self._note_sig(t, stmt, "delete", None, mode, sid)
        self._note_route(t, sid, 1, True)
        if returning:
            n, ids, present = outs
            return Result(dev={"count": n, "row_ids": ids,
                               "present": present},
                          ctx={"limit": schema.max_select})
        return Result(dev={"count": outs[0]})

    # ----------------------------------------------------- serving-plane API
    def table_state(self, name: str) -> dict:
        """The table's device state. A monolithic table returns its live
        dict of tensors, which every later statement updates in place
        (their addresses stay until the table is dropped); a caller reads
        it on the daemon's stream right after the statement it follows (the
        serving engine's page-table upkeep). A sharded table returns a
        stacked snapshot at the table's logical time (clocks caught up,
        deferred expiries applied), as the reference does."""
        t = self._table(name)
        if t.lanes is None:
            return t.state
        return self._caught_up(t)

    def swap_table_state(self, name: str, state: dict) -> None:
        """Install a state (``convert.state_from_numpy`` turns the
        reference's pytree into one) by copying it into the table's own
        tensors. Its tensors must lie on this daemon's device and match
        the table's layout (the stacked one for a sharded table, whose
        clocks it then takes as caught up)."""
        t = self._table(name)
        want = self._layout(t.schema)[0].init_state(t.schema, "meta")
        _check_layout(want, state, self.device, name)
        if t.mesh is None:
            _copy_into(t.state, state)
        else:
            per = t.schema.shards // len(t.mesh)
            for k, blk in enumerate(t.blocks):
                _copy_into(blk, SH._tree(
                    lambda x, k=k: x[k * per:(k + 1) * per], state))
        if t.lanes is not None:
            with t.lock:
                t.lane_ticks = [t.ticks_total] * t.schema.shards

    def schema(self, name: str) -> TableSchema:
        return self._table(name).schema

    def live_rows(self, name: str) -> int:
        t = self._table(name)
        if t.lanes is None:
            return int(T.live_count(t.state))
        return int(SH.live_count(self._caught_up(t)))

    def advance_clock(self, ticks: int, table: str | None = None) -> None:
        """Advance the logical clock (tests / wall-time sync); on a
        sharded table every lane's clock and both sides of the catch-up
        bookkeeping, with no dispatch in flight."""
        names = [table] if table else list(self.tables)
        for nm in names:
            t = self._table(nm)
            with t.lock:
                if t.lanes is not None:
                    t.ticks_total += ticks
                    t.lane_ticks = [lt + ticks for lt in t.lane_ticks]
                for st in (t.blocks if t.mesh is not None else [t.state]):
                    st["clock"].add_(ticks)


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
