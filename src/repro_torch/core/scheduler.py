"""Port copy of ``repro.core.scheduler`` (host Python) with its imports
redirected to ``repro_torch``. The port's daemon reports execution lanes
for sharded tables (``group_lane`` / ``item_lanes`` / ``group_shard_ids``),
so the per-shard lock paths below run as in the reference. Where a table
is placed over a lane mesh (``launch/mesh.py``), a lane's statements run
on its block's device under that device's lock (``core/execache.py``), so
groups on lanes of disjoint devices dispatch concurrently on the device
side too; on one card (a mesh repeating it) lanes overlap their host-side
dispatch and their device work runs on one stream. ``lane_locks=False``
keeps the single table lock either way.

Cross-connection batch scheduler — the daemon's admission queue.

The paper's daemon multiplexes every web-app connection into a single
execution stream (§3). PR 1 made that stream cheap to batch
(``SQLCached.executemany`` dispatches W same-shape statements in ONE
jitted call); this module is the piece that *fills* those batches from
the network: an admission queue collects in-flight statements across ALL
connections, groups them by (table, statement shape) via the daemon's
:meth:`~repro_torch.core.daemon.SQLCached.shape_key` hook, and dispatches each
group through ``executemany`` (``per_statement=True``, so every client
still gets its own COUNT/ROW/VALUE response). Singleton and unbatchable
groups fall back to plain ``execute``. Together with the protocol
layer's per-connection response flushing this replaces the old global
``_exec_lock``.

Ordering contract
-----------------
Admission order is preserved wherever it is observable. Fencing is at
COLUMN granularity, reusing the plan's table/column footprint that
``shape_key`` stamps on each statement (``reads``/``writes``; ``None`` =
whole table — INSERT/DELETE churn validity, admin is a hard barrier):

* a READ joins its shape's open group iff no group that WRITES a column
  it reads opened after that group (reads commute with reads, and with
  writes to columns they never look at);
* a WRITE joins its shape's open group iff no group that touches its
  write set — or writes its read set — opened after it (same-shape
  writes batch through ``executemany``, whose executors keep sequential
  semantics among themselves);
* admin statements (CREATE/DROP/EXPIRE/FLUSH) and unparseable SQL are
  barriers — they never merge and nothing reorders across them; EXPLAIN
  (no reads, no writes) merges with nothing but fences nothing.

Groups whose footprints conflict dispatch strictly in open order, so
per-connection orderings and every column-level data dependency hold;
reordering that no client can observe through the wire protocol
(cross-table, or across writes to disjoint columns) is allowed.
Auto-expiry cadence is per-statement (PR 2), so regrouping does not
change TTL semantics beyond the already documented batch-boundary
flexibility. Results are lazy, so a dispatch returns as soon as the
device work is enqueued — the response flushers materialize rows off the
event loop.

Concurrent waves
----------------
Groups are dispatched in *waves*: a wave is the longest prefix of
consecutive groups that pairwise COMMUTE — different tables, same table
with disjoint column footprints, or same (sharded) table with provably
disjoint shard-route sets (``SQLCached.group_shard_ids``: every
statement in each group prunes to a known shard set and the sets don't
intersect — independent-shard traffic from different connections
overlaps even when the column footprints collide). A wave's groups run
concurrently (``asyncio.gather`` over worker threads — jax device work
is enqueued asynchronously, so this overlaps the host-side dispatch
cost that dominates small statements); a conflicting group ends the
wave and waits. Admin statements and unparseable SQL stay hard
barriers: they are always a wave of one. Shard-pruned statements on one
table may observe a logical clock that differs by the wave's statement
count from strict admission order (clock ticks commute; same TTL
batch-boundary flexibility as above).

Execution lanes
---------------
Locking inside a wave is per SHARD, not per table (PR 5): a sharded
table's state lives in per-shard lane handles at the daemon
(``daemon._Table.lanes``), and a group whose shard route is provably
ONE shard (``SQLCached.group_shard_ids`` returns a singleton) acquires
only that lane's asyncio lock — so same-table groups on different
lanes hold disjoint locks and truly overlap, and the daemon executes
each against its own lane's buffers. A MULTI-shard group whose
statements each provably route to one lane splits into per-lane
sub-batches (``_split_group``, via ``SQLCached.item_lanes``) that
dispatch concurrently under their own lane locks — and since PR 7
places lanes on mesh devices, disjoint-lane overlap is real
multi-DEVICE overlap. Remaining fan-out / unknown-route groups take
the table's base lock plus every lane (whole-table exclusion),
unsharded tables keep their single lock, and acquisition follows one
global order (base, then lanes ascending) so concurrent groups cannot
deadlock. ``lane_locks=False`` restores the PR-4 single-lock regime
(the lane-bench baseline).

Admission window
----------------
``max_wait_us > 0`` holds the batch cut open while the OLDEST admitted
statement is younger than the window, letting groupmates arrive from
other connections; the deadline is per-statement, so a lone statement is
never held past ``max_wait_us`` and the default (0) dispatches every
tick exactly as before. The clock (``_now``) and the wait primitive
(``_wait_for_arrivals``) are injectable for deterministic tests.
"""
from __future__ import annotations

import asyncio
import os
import time
from collections import deque
from typing import Any, Sequence

from repro_torch.core import telemetry as TEL
from repro_torch.core.daemon import SQLCached, StatementShape
from repro_torch.lint import lockorder as LK


class _Item:
    __slots__ = ("sql", "params", "future", "shape", "admitted_at", "trace")

    def __init__(self, sql: str, params: tuple, future: asyncio.Future,
                 shape: StatementShape | None, admitted_at: float = 0.0,
                 trace: "TEL.Trace | None" = None):
        self.sql = sql
        self.params = params
        self.future = future
        self.shape = shape
        self.admitted_at = admitted_at
        self.trace = trace


class _Group:
    __slots__ = ("seq", "shape", "items", "_shard_ids", "_lane")

    _UNSET = object()

    def __init__(self, seq: int, shape: StatementShape | None, items: list):
        self.seq = seq
        self.shape = shape
        self.items = items
        self._shard_ids = _Group._UNSET  # lazily computed, then cached
        self._lane = _Group._UNSET

    def shard_ids(self, db: SQLCached) -> frozenset | None:
        """The provable shard-id set of this group's statements (None =
        unknown / fan-out / unsharded table). Computed lazily at
        wave-build time — i.e. after every preceding wave (including
        CREATE/DROP barriers) has executed — and cached."""
        if self._shard_ids is _Group._UNSET:
            try:
                self._shard_ids = db.group_shard_ids(
                    self.shape, [it.params for it in self.items])
            except Exception:  # noqa: BLE001 — routing is best effort
                self._shard_ids = None
        return self._shard_ids

    def lane(self, db: SQLCached) -> int | None:
        """The execution lane the DAEMON will run this group on (None =
        the dispatch takes the whole table). This is ``db.group_lane``
        — the exact predicate ``_exec_mode`` uses — so the lock set
        below always covers what the dispatch actually touches (a
        single-shard group can still need a whole-table dispatch, e.g.
        an INSERT batch wider than one shard)."""
        if self._lane is _Group._UNSET:
            try:
                self._lane = db.group_lane(
                    self.shape, [it.params for it in self.items])
            except Exception:  # noqa: BLE001 — routing is best effort
                self._lane = None
        return self._lane


class _TableFences:
    """Per-table column-granular fence bookkeeping for one planning pass.

    Tracks, per column, the latest group that WROTE it and the latest
    group that TOUCHED it (read or wrote); ``*_all`` carry the groups
    whose footprint was unknown (None = whole table)."""

    __slots__ = ("write_col", "touch_col", "write_all", "touch_all",
                 "write_any")

    def __init__(self):
        self.write_col: dict[str, int] = {}
        self.touch_col: dict[str, int] = {}
        self.write_all = -1   # latest whole-table write
        self.touch_all = -1   # latest whole-table read-or-write
        self.write_any = -1   # latest write of ANY column

    def read_fence(self, reads) -> int:
        """Latest group a read with footprint ``reads`` must not precede."""
        if reads is None:
            return max(self.write_all, self.write_any)
        f = self.write_all
        for c in reads:
            f = max(f, self.write_col.get(c, -1))
        return f

    def write_fence(self, reads, writes) -> int:
        """Latest group a write (reads/writes footprints) must not
        precede: anything touching its write set, any write to its read
        set, and every whole-table group."""
        if reads is None or writes is None:
            f = self.touch_all
            for c in self.touch_col:
                f = max(f, self.touch_col[c])
            return max(f, self.write_any)
        f = max(self.write_all, self.touch_all)
        for c in writes:
            f = max(f, self.touch_col.get(c, -1))
        for c in reads:
            f = max(f, self.write_col.get(c, -1))
        return f

    def record(self, seq: int, reads, writes, is_write: bool) -> None:
        for fp, isw in ((reads, False), (writes, True)):
            if fp is None:
                self.touch_all = max(self.touch_all, seq)
                if isw or is_write:
                    self.write_all = max(self.write_all, seq)
                    self.write_any = max(self.write_any, seq)
                continue
            for c in fp:
                self.touch_col[c] = max(self.touch_col.get(c, -1), seq)
                if isw:
                    self.write_col[c] = max(self.write_col.get(c, -1), seq)
                    self.write_any = max(self.write_any, seq)


class BatchScheduler:
    """Admission queue + shape-grouping dispatcher over one SQLCached.

    ``batching=False`` degrades to a per-statement serial executor (every
    statement its own group) — the wire protocol stays pipelined, but no
    cross-connection fusion happens; benchmarks use this to separate the
    two effects. ``max_batch`` bounds group size (and therefore the
    executor bucket sizes that get compiled). ``max_wait_us`` bounds how
    long an admitted statement may wait for groupmates (0 = never)."""

    def __init__(self, db: SQLCached, *, batching: bool = True,
                 max_batch: int = 64, max_admit: int = 4096,
                 max_wait_us: int = 0, concurrency: bool | None = None,
                 lane_locks: bool = True):
        self.db = db
        self.batching = batching
        self.max_batch = max_batch
        self.max_admit = max_admit
        self.max_wait_us = max_wait_us
        if concurrency is None:  # env override so CI can run both regimes
            concurrency = os.environ.get(
                "REPRO_SCHED_CONCURRENCY", "1") != "0"
        self.concurrency = concurrency  # overlap commuting groups (waves)
        # lane_locks=False restores the PR-4 regime: one lock per table,
        # so same-table groups serialize even inside a wave (the
        # lane-bench baseline)
        self.lane_locks = lane_locks
        self._now = time.monotonic  # injectable (fake clocks in tests)
        self._q: deque[_Item] = deque()
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        # per table: {"base": Lock, "lanes": {shard_id: Lock}} — see
        # _locks_for
        self._table_locks: dict[str, dict] = {}
        # Atomic counters (telemetry.Counters): waves dispatch groups
        # concurrently and render threads read these live, so plain
        # ``+=`` read-modify-writes would lose increments.
        self.stats = TEL.Counters(
            {"admitted": 0, "batches": 0, "grouped_statements": 0,
             "singles": 0, "max_group": 0, "window_waits": 0,
             "waves": 0, "overlapped_groups": 0, "max_wave": 0,
             "lane_dispatches": 0, "lane_splits": 0,
             "cold_solo": 0, "errors": 0})

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._task is None:
            self._closed = False
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task is not None:
            try:
                await self._task
            finally:
                self._task = None
        while self._q:
            it = self._q.popleft()
            if not it.future.done():
                it.future.set_exception(
                    ConnectionError("scheduler stopped"))

    # ------------------------------------------------------------ admission
    def submit(self, sql: str, params: Sequence[Any] = (),
               trace: "TEL.Trace | None" = None) -> asyncio.Future:
        """Enqueue one statement; returns a future resolving to its lazy
        :class:`~repro_torch.core.daemon.Result` (or raising the statement's
        error). Must be called from the scheduler's event loop."""
        fut = asyncio.get_running_loop().create_future()
        if self._closed:
            fut.set_exception(ConnectionError("scheduler stopped"))
            return fut
        if trace is not None:
            trace.mark("wire")   # EXEC receipt -> admission
            trace.sql = sql
        try:
            shape = self.db.shape_key(sql)
        except Exception:
            shape = None  # unparseable: barrier; execute() re-raises for us
        if trace is not None:
            trace.mark("parse")
            if shape is not None:
                trace.table, trace.kind = shape.table, shape.kind
        self._q.append(_Item(sql, tuple(params), fut, shape, self._now(),
                             trace))
        self.stats.add("admitted")
        self._wake.set()
        return fut

    # ------------------------------------------------------------- planning
    def _plan(self, items: list[_Item]) -> list[_Group]:
        groups: list[_Group] = []
        open_by_key: dict[tuple, _Group] = {}
        fences: dict[str, _TableFences] = {}
        barrier = -1
        for it in items:
            sh = it.shape
            if sh is None or not sh.batchable or not self.batching:
                seq = len(groups)
                groups.append(_Group(seq, sh, [it]))
                if sh is None:
                    barrier = seq
                elif sh.is_write or sh.reads is None or sh.reads:
                    # a statement with nothing to read or write (EXPLAIN)
                    # fences nothing; everything else unbatchable is a
                    # whole-table barrier
                    fences.setdefault(sh.table, _TableFences()).record(
                        seq, None, None, True)
                continue
            tf = fences.setdefault(sh.table, _TableFences())
            g = open_by_key.get(sh.key)
            fence = (tf.write_fence(sh.reads, sh.writes) if sh.is_write
                     else tf.read_fence(sh.reads))
            if (g is not None and len(g.items) < self.max_batch
                    and g.seq >= barrier and g.seq >= fence):
                g.items.append(it)
                tf.record(g.seq, sh.reads, sh.writes, sh.is_write)
            else:
                seq = len(groups)
                g = _Group(seq, sh, [it])
                groups.append(g)
                open_by_key[sh.key] = g
                tf.record(seq, sh.reads, sh.writes, sh.is_write)
        return groups

    # ------------------------------------------------------------- dispatch
    @staticmethod
    def _call_traced(fn, traces, *args, **kwargs):
        """Run ``fn`` in the worker thread with ``traces`` installed as
        the ambient dispatch context (so daemon/execache attribute
        exec_mode and cache events into them) and stamp the "execute"
        span on each trace when it returns."""
        if not traces:
            return fn(*args, **kwargs)
        with TEL.dispatch_span(traces):
            try:
                return fn(*args, **kwargs)
            finally:
                for tr in traces:
                    tr.mark("execute")

    async def _run_single(self, it: _Item) -> None:
        traces = [it.trace] if it.trace is not None else ()
        try:
            res = await asyncio.to_thread(
                self._call_traced, self.db.execute, traces, it.sql, it.params)
        except Exception as e:  # noqa: BLE001 — statement error, not ours
            self.stats.add("errors")
            if not it.future.done():
                it.future.set_exception(e)
        else:
            if not it.future.done():
                it.future.set_result(res)

    def _locks_for(self, g: _Group) -> list:
        """The ordered lock set one group must hold (per-shard execution
        lanes): a group that provably routes to ONE shard takes only that
        lane's lock — so same-table groups on different lanes run truly
        concurrently inside a wave; everything else on a sharded table
        takes the base lock plus every lane (whole-table exclusion); an
        unsharded table keeps its single base lock. Acquisition order is
        global (base, then lanes ascending), so concurrent groups can
        never deadlock."""
        table = g.shape.table if g.shape is not None else None
        if table is None:
            return []
        ent = self._table_locks.setdefault(
            table, {"base": LK.make_async_lock(f"sched:{table}:base"),
                    "lanes": {}})
        t = self.db.tables.get(table)
        n = t.schema.shards if t is not None else 1
        if n <= 1 or not self.lane_locks:
            return [ent["base"]]
        lanes = ent["lanes"]
        lane = g.lane(self.db)
        if lane is not None:
            # single-lane group: the daemon will execute it on exactly
            # this lane's state handle (db.group_lane IS the dispatch
            # decision _exec_mode reads, so lock and dispatch agree)
            self.stats.add("lane_dispatches")
            return [lanes.setdefault(
                lane, LK.make_async_lock(f"sched:{table}:lane{lane}"))]
        return [ent["base"]] + [
            lanes.setdefault(i, LK.make_async_lock(f"sched:{table}:lane{i}"))
            for i in range(n)]

    def _split_group(self, g: _Group) -> "list[_Group] | None":
        """Split a multi-shard group whose statements EACH provably
        route to one lane into per-lane sub-batches (None = the group
        stays whole). The sub-batches hold disjoint lane locks and
        dispatch concurrently — multi-shard traffic on one shape
        overlaps like singleton lane groups instead of serializing
        under base + every lane (on a mesh-placed table that means the
        sub-batches run on different DEVICES at once). Statements on
        different lanes touch disjoint shards, so the split preserves
        per-statement semantics; within a lane, admission order holds.
        Every sub-batch is re-verified through the daemon's own route
        predicate (``_Group.lane`` = ``db.group_lane``): a sub-batch
        the daemon would still dispatch whole-table (e.g. a padded
        INSERT wider than one shard) vetoes the split, so the lock set
        always covers the dispatch."""
        if (not self.concurrency or not self.lane_locks
                or g.shape is None or not g.shape.batchable
                or len(g.items) < 2 or g.lane(self.db) is not None):
            return None
        try:
            lanes = self.db.item_lanes(
                g.shape, [it.params for it in g.items])
        except Exception:  # noqa: BLE001 — routing is best effort
            return None
        if (lanes is None or any(ln is None for ln in lanes)
                or len(set(lanes)) < 2):
            return None
        by_lane: dict[int, list] = {}
        for it, ln in zip(g.items, lanes):
            by_lane.setdefault(ln, []).append(it)
        subs = []
        for ln, items in by_lane.items():
            sub = _Group(g.seq, g.shape, items)
            if sub.lane(self.db) != ln:
                return None
            subs.append(sub)
        return subs

    async def _dispatch(self, g: _Group) -> None:
        """Run one group — split into per-lane sub-batches when its
        statements provably land on disjoint lanes, whole otherwise."""
        subs = self._split_group(g)
        if subs is None:
            await self._dispatch_one(g)
            return
        self.stats.add("lane_splits")
        await asyncio.gather(*(self._dispatch_one(s) for s in subs))

    async def _dispatch_one(self, g: _Group) -> None:
        """Run one (sub-)group under its lane/table locks. Commuting
        makes the order inside a wave free; the locks keep each state
        handle's read-modify-write atomic — and disjoint-lane groups
        hold disjoint locks, so they truly overlap."""
        locks = self._locks_for(g)
        for it in g.items:
            if it.trace is not None:
                it.trace.mark("queue")   # admission -> lock acquisition
        for lk in locks:
            await lk.acquire()
        for it in g.items:
            if it.trace is not None:
                it.trace.mark("lock")    # lane/table lock wait
        try:
            await self._dispatch_inner(g)
        finally:
            for lk in reversed(locks):
                lk.release()

    async def _dispatch_inner(self, g: _Group) -> None:
        items = g.items
        self.stats.add("batches")
        self.stats.max("max_group", len(items))
        for it in items:
            if it.trace is not None:
                it.trace.group = len(items)
        if len(items) == 1:
            self.stats.add("singles")
            await self._run_single(items[0])
            return
        self.stats.add("grouped_statements", len(items))
        traces = [it.trace for it in items if it.trace is not None]
        try:
            params_list = [it.params for it in items]
            results = await asyncio.to_thread(
                self._call_traced, self.db.executemany, traces,
                items[0].sql, params_list, per_statement=True)
        except Exception:  # noqa: BLE001
            # one member's bad binding (wrong arity, bad type) must not
            # fail its groupmates: the batch raised before any state
            # mutation, so replay each statement alone — only the
            # offenders error (rare slow path)
            for it in items:
                await self._run_single(it)
            return
        for it, res in zip(items, results):
            if not it.future.done():
                it.future.set_result(res)

    # ------------------------------------------------------------- waves
    @staticmethod
    def _footprints_disjoint(a: StatementShape, b: StatementShape) -> bool:
        """Column-level commutation on one table: neither side's writes
        may touch what the other reads or writes (None = whole table)."""

        def touch(s):  # columns a shape touches at all; None = whole table
            if s.reads is None or s.writes is None:
                return None
            return s.reads | s.writes

        def conflicts(w, t):  # one side's writes vs the other's touches
            if w is not None and not w:
                return False   # writes nothing (reads commute with reads)
            if t is not None and not t:
                return False   # other side touches nothing (EXPLAIN)
            if w is None or t is None:
                return True    # whole-table on either side
            return bool(w & t)

        return not (conflicts(a.writes, touch(b))
                    or conflicts(b.writes, touch(a)))

    def _compatible(self, g: _Group, h: _Group) -> bool:
        """May ``g`` run concurrently with ``h``? Barriers never overlap;
        different tables always do; same-table groups need disjoint
        column footprints or provably disjoint shard routes."""
        for x in (g, h):
            if x.shape is None or x.shape.kind == "admin":
                return False
        if g.shape.table != h.shape.table:
            return True
        if self._footprints_disjoint(g.shape, h.shape):
            return True
        gs, hs = g.shard_ids(self.db), h.shard_ids(self.db)
        return gs is not None and hs is not None and not (gs & hs)

    def _is_cold(self, g) -> bool:
        """True when dispatching ``g`` would compile a new executor
        (its shape x placement is not pre-planned — execache.sigs). Cold
        groups dispatch in cold-only waves: a compile takes orders of
        magnitude longer than a replay, and under lane locks it would
        stall every warm groupmate sharing its wave. Best effort — stub
        dbs without ``group_warm`` and routing errors count as warm
        (old behavior)."""
        gw = getattr(self.db, "group_warm", None)
        if gw is None or g.shape is None or g.shape.kind == "admin":
            return False
        try:
            cold = not gw(g.shape, [it.params for it in g.items])
        except Exception:  # noqa: BLE001 — admission hints are best effort
            return False
        if cold:
            self.stats.add("cold_solo")
        return cold

    async def _dispatch_wave(self, wave: list) -> None:
        self.stats.add("waves")
        self.stats.max("max_wave", len(wave))
        if len(wave) > 1:
            for g in wave:
                for it in g.items:
                    if it.trace is not None:
                        it.trace.wave = len(wave)
        if len(wave) == 1:
            await self._dispatch(wave[0])
            return
        self.stats.add("overlapped_groups", len(wave))
        await asyncio.gather(*(self._dispatch(g) for g in wave))

    # ------------------------------------------------------------- windowing
    async def _wait_for_arrivals(self, timeout: float) -> None:
        """Park until new admissions or the window deadline (injectable —
        the fake-clock tests replace this and ``_now``)."""
        try:
            await asyncio.wait_for(self._wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    async def _hold_window(self) -> None:
        """Latency-bounded admission: keep the cut open while the OLDEST
        waiter is younger than ``max_wait_us`` and the queue is not full.
        The deadline belongs to the oldest statement, so nobody — least
        of all a lone statement — waits past the window."""
        while (self._q and not self._closed
               and len(self._q) < self.max_admit):
            deadline = self._q[0].admitted_at + self.max_wait_us / 1e6
            remain = deadline - self._now()
            if remain <= 0:
                break
            self.stats.add("window_waits")
            self._wake.clear()
            await self._wait_for_arrivals(remain)
            # let every runnable connection handler drain its read buffer
            await asyncio.sleep(0)

    async def _loop(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            if self._closed:
                return
            # one scheduling tick: let every runnable connection handler
            # drain its read buffer into the queue before cutting batches
            await asyncio.sleep(0)
            if self.max_wait_us > 0:
                await self._hold_window()
                if self._closed:
                    return
            items: list[_Item] = []
            while self._q and len(items) < self.max_admit:
                items.append(self._q.popleft())
            if self._q:
                self._wake.set()  # leftovers past max_admit: next tick
            groups = self._plan(items)
            if not self.concurrency:
                for g in groups:
                    await self._dispatch(g)
                continue
            # wave dispatch: run the longest prefix of pairwise-commuting
            # groups concurrently; a conflicting group ends the wave and
            # waits. Compatibility (including shard routes, which read
            # the live schema) is evaluated AFTER the preceding wave has
            # fully executed, so admin barriers can't be read around.
            # A COLD group (executor not pre-planned -> dispatch would
            # compile) never shares a wave with WARM groups: its compile
            # would hold the wave barrier (and under lane locks, its
            # lock) for orders of magnitude longer than a replay. Cold
            # groups may still overlap EACH OTHER — their compiles run
            # concurrently and nobody warm is stalled. One flag check
            # per group, memoized upfront.
            cold = [self._is_cold(g) for g in groups]
            i = 0
            while i < len(groups):
                wave = [groups[i]]
                wave_cold = cold[i]
                i += 1
                while (i < len(groups) and cold[i] == wave_cold
                       and all(self._compatible(groups[i], h)
                               for h in wave)):
                    wave.append(groups[i])
                    i += 1
                await self._dispatch_wave(wave)
