"""Port copy of ``repro.core.protocol`` (host Python) with its imports
redirected to ``repro_torch``; the wire grammar is byte for byte the
reference's. Sharding, WARMUP, CHECKPOINT/RESTORE and the cluster tier
described below are not in the port yet: the port's daemon answers those
statements with ERR.

The "web-enabling" layer: a memcached-style text protocol carrying SQL.

Faithful to the paper's §3: a daemon reachable over TCP *and* unix
sockets, line-based text protocol (in the spirit of early TCP protocols),
asynchronous connection handling with a **single execution stream** —
the cross-connection :class:`~repro_torch.core.scheduler.BatchScheduler`
admits statements from every connection into one ordered stream and
dispatches same-shape runs as fused ``executemany`` batches (SQLcached
used poll(); we use asyncio, the modern POSIX equivalent).

Wire format (CRLF or LF tolerated; every verb optionally carries a
``#<tag>`` suffix — an opaque client token that pipelines statements):

    client:  EXEC <sql>                 -- start a statement
             EXEC#<id> <sql>            -- start a TAGGED statement
             ARG I <int>                -- bind next `?` of the most
             ARG F <float>                 recent EXEC (integer/float)
             ARG S <base64(utf-8)>      --   (text)
             ARG#<id> ...               -- bind an explicit statement
             GO / GO#<id>               -- submit for execution
             PING                       -- liveness probe
             QUIT                       -- close the connection

    server:  COUNT#<id> <n>             -- rows affected / matched
             VALUE#<id> <v>             -- aggregate result (if any; for
                                           INSERT it is the eviction count
                                           of the DISPATCH that carried
                                           the statement — a fused group
                                           reports the group total)
             ROW#<id> <json>            -- one line per returned row
             END#<id>                   -- statement finished
             ERR#<id> <message>         -- statement failed
             PONG / BYE                 -- control replies
             (untagged statements get untagged COUNT/ROW/.../ERR lines —
              the original one-round-trip-per-statement dialect)

Pipelining: a client may stream any number of tagged EXEC…GO frames
without reading; the server replies **strictly in GO-submission order**
on each connection (control replies included), so responses match up
positionally as well as by tag. Statements from all connections meet in
the batch scheduler, which fuses same-shape runs into single jitted
dispatches — this is how network clients reach the micro-batched engine.

Sharded tables ride the same wire verbatim — a client declares the
partitioning at CREATE time and every later statement is routed
transparently (core/shards.py):

    EXEC CREATE TABLE pages (site INT, id INT, hits INT, INDEX(id))
         CAPACITY 1048576 SHARDS 8 PARTITION BY site
    GO
    EXEC#1 SELECT hits FROM pages WHERE site = ? AND id = ?
    ARG#1 I 7
    ARG#1 I 123
    GO#1                      -- eq on `site` prunes to ONE shard
    EXEC#2 SELECT COUNT(*) FROM pages WHERE hits > ?
    ARG#2 I 100
    GO#2                      -- fans out, partials merge server-side
    EXEC#3 EXPLAIN SELECT hits FROM pages WHERE site = 7
    GO#3                      -- VALUE row includes "shard_route":
                              --   "pruned -> shard k" / "fan-out x 8"

Two admin statements manage the partitioning live over the same wire
(both answer with one COUNT + one VALUE line):

    EXEC SHOW STATS pages
    GO                        -- VALUE is a JSON skew report: per-shard
                              --   live_rows + statements/writes/
                              --   inserted_rows counters (a hot shard
                              --   shows up as one lane running away);
                              --   EXPLAIN pages is the same report
    EXEC ALTER TABLE pages RESHARD 16
    GO                        -- live re-partition: one bulk device-side
                              --   re-split of every live row + one
                              --   index rebuild per new shard; COUNT is
                              --   the rows moved, VALUE the new shard
                              --   count. TTL stamps ride along, so
                              --   contents round-trip exactly.
                              --   RESHARD 1 converts to monolithic.
    EXEC WARMUP pages
    GO                        -- pre-plan (AOT compile) the table's
                              --   canonical hot shapes for every placed
                              --   lane device BEFORE traffic lands;
                              --   COUNT is the executables newly
                              --   compiled, VALUE the executor-cache
                              --   epoch. WARMUP t LIKE 'SELECT ...'
                              --   pre-plans exactly the quoted shape.

Observability statements (PR 9, core/telemetry.py — all one COUNT +
one VALUE line; none ever syncs a device handle):

    EXEC SHOW METRICS pages
    GO                        -- VALUE is the JSON telemetry report:
                              --   per-(table, kind) log2 latency
                              --   histograms, p50/p99/p999, per-stage
                              --   (wire/parse/queue/lock/execute/
                              --   render) breakdowns, exec-mode and
                              --   executor-cache attribution. Omit the
                              --   table for every shape; FORMAT 'prom'
                              --   returns a Prometheus text exposition
                              --   (JSON-string-encoded: one wire line)
    EXEC EXPLAIN ANALYZE SELECT hits FROM pages WHERE site = 7
    GO                        -- executes the statement and reports its
                              --   MEASURED per-stage spans next to the
                              --   plan (admin barrier: it materializes
                              --   the inner result)
    EXEC SHOW SLOW
    GO                        -- bounded ring of span trees from
                              --   statements that crossed slow_ms
                              --   (SQLCached(slow_ms=..) /REPRO_SLOW_MS)
    EXEC SHOW STATS
    GO                        -- daemon-wide roll-up: tables, scheduler
                              --   stats, executor-cache totals, uptime

The batch scheduler additionally overlaps groups whose footprints
provably commute — different tables, disjoint columns, or pruned
statements on disjoint shard sets. Since PR 5 a sharded table's state
lives in per-shard EXECUTION LANES at the daemon: a statement group
that provably routes to one shard locks and executes only that lane,
so same-table traffic on different shards no longer queues behind one
dispatch — a hot table stops being a concurrency barrier.

Cluster tier (core/cluster.py) — the same wire, N daemons:

    EXEC CREATE TABLE pages (...) SHARDS 8 PARTITION BY site REPLICAS 2
    GO                        -- REPLICAS r is stored by every daemon and
                              --   reported by SHOW STATS; the MIRRORING
                              --   is the cluster client's job: each
                              --   write goes to the table's (or
                              --   partition slot's) r ring-successor
                              --   nodes, reads load-balance across them

A :class:`~repro_torch.core.cluster.ClusterClient` consistent-hash-rings
tables (and ``PARTITION BY`` key slots, via ``shards.shard_of_host``)
across daemons and keeps one tagged connection per node. Three protocol
properties make failover safe, and they are guarantees of THIS layer:

- **Replay-safe tags.** A client's tag counter is monotonic across
  reconnects and every statement is fully self-contained (EXEC..ARG..GO
  frame), so an in-flight statement can be resent verbatim — to the same
  node after a reconnect or to a surviving replica — and answers match
  up by tag, never by guesswork. Writes are mirrored to every replica
  under the SAME tag, which is what makes the replay idempotent: the
  survivor already executed tag t, and its response stands in for the
  dead primary's.
- **Acknowledged = answered.** A write counts as acknowledged only once
  a COUNT/…/END (or ERR) block for its tag has been READ back — not
  when the frame was written. The cluster client acks only after every
  live replica of the statement's group has answered, so a SIGKILL of
  any one node loses zero acknowledged writes.
- **PING deadlines.** PING/PONG rides the same ordered stream, so a
  PONG proves the node's event loop is draining its queue (not merely
  that TCP connects). Health probes put a deadline on it
  (``AsyncSQLCachedClient.ping(deadline=...)``); a node that misses the
  deadline is treated exactly like a dead one — marked down, reads fail
  over to a surviving replica, which is promoted.

Connection loss is surfaced, never absorbed: the sync
:class:`Pipeline.collect` turns a dead socket into one clean
``ConnectionError`` per unanswered tag (no hangs, no silently empty
results), the async FIFO matcher fails every pending future the same
way, and both clients offer ``reconnect()`` plus configurable connect
retries with capped exponential backoff + jitter (:func:`backoff_delays`).

Tensor payloads never cross this socket — they live on the accelerator;
the protocol is the management/metadata plane (DESIGN.md §2).
"""
from __future__ import annotations

import asyncio
import base64
import itertools
import json
import random
import socket
import threading
import time
from collections import deque
from typing import Any, Sequence

from repro_torch.core import telemetry as TEL
from repro_torch.core.daemon import Result, SQLCached
from repro_torch.core.scheduler import BatchScheduler

_MAX_LINE = 1 << 20
# half-assembled statements (EXEC seen, GO not yet) allowed per connection —
# bounds server memory against clients that stream EXEC#n without ever GOing
_MAX_PENDING = 256


def backoff_delays(retries: int, base: float = 0.05, cap: float = 2.0):
    """``retries`` sleep durations of capped exponential backoff with
    equal jitter: attempt k waits in [d/2, d] for d = min(cap, base*2^k).
    The jitter de-synchronizes a fleet of clients hammering a recovering
    node; the cap bounds worst-case failover latency. Shared by the
    connect paths here and every retry loop in core/cluster.py."""
    for attempt in range(retries):
        d = min(cap, base * (2.0 ** attempt))
        yield d / 2 + random.uniform(0, d / 2)


def _warmup_sql(table: str, like: str | None) -> str:
    """The WARMUP statement text for both clients' ``warmup()`` helpers
    (the quoted LIKE statement escapes ``'`` the SQL way)."""
    if like is None:
        return f"WARMUP {table}"
    return f"WARMUP {table} LIKE '" + like.replace("'", "''") + "'"


def _encode_arg(v: Any) -> str:
    if isinstance(v, bool):
        return f"ARG I {int(v)}"
    if isinstance(v, int):
        return f"ARG I {v}"
    if isinstance(v, float):
        return f"ARG F {v!r}"
    if isinstance(v, str):
        return "ARG S " + base64.b64encode(v.encode()).decode()
    raise TypeError(f"unsupported arg type {type(v)!r}")


def _decode_arg(kind: str, raw: str) -> Any:
    if kind == "I":
        return int(raw)
    if kind == "F":
        return float(raw)
    if kind == "S":
        return base64.b64decode(raw).decode()
    raise ValueError(f"bad ARG kind {kind!r}")


def _line(text: str, tag: str | None) -> bytes:
    """One response line, the verb tagged when the request was."""
    if tag is not None:
        verb, sep, rest = text.partition(" ")
        text = f"{verb}#{tag}{sep}{rest}"
    return text.encode() + b"\r\n"


def _render_result(res: Result, tag: str | None) -> bytes:
    """COUNT/VALUE/ROW.../END block for one Result. Forces the lazy
    device→host sync — call off the event loop."""
    sfx = "" if tag is None else f"#{tag}"
    out = [f"COUNT{sfx} {res.count}".encode()]
    if res.value is not None:
        out.append(f"VALUE{sfx} {res.value}".encode())
    for row in res.rows or []:
        out.append(f"ROW{sfx} ".encode() + json.dumps(row).encode())
    out.append(f"END{sfx}".encode())
    return b"\r\n".join(out) + b"\r\n"


def _render_burst(items: list) -> tuple[bytes, int, int, list]:
    """Render a burst of resolved responses in ONE worker-thread hop:
    ``items`` holds (tag, Result | Exception | str, trace) in response
    order. Returns (wire bytes, n statements ok, n statement errors,
    [trace] for traced items, ``trace.error`` stamped). Sibling Results of one batch
    share a device→host sync here, and each statement's trace gets its
    "render" span stamped at render time — but the histogram fold
    (``Telemetry.finish``) is the CALLER's job, after the bytes are on
    the socket, so recording never adds to the client-visible latency."""
    parts: list[bytes] = []
    stmts = errs = 0
    done: list = []
    for tag, payload, trace in items:
        err = False
        if isinstance(payload, Exception):
            msg = str(payload).replace("\n", " ")[:500]
            parts.append(_line(f"ERR {msg}", tag))
            errs += 1
            err = True
        elif isinstance(payload, str):
            parts.append(_line(payload, tag))
        else:
            try:
                parts.append(_render_result(payload, tag))
                stmts += 1
            except Exception as e:  # noqa: BLE001
                msg = str(e).replace("\n", " ")[:500]
                parts.append(_line(f"ERR {msg}", tag))
                errs += 1
                err = True
        if trace is not None:
            trace.mark("render")
            if err:
                trace.error = True
            done.append(trace)
    return b"".join(parts), stmts, errs, done


class _LineTooLong(Exception):
    """Raised once per oversized line; ``prefix`` preserves the line's
    first bytes so the handler can still identify the verb and tag and
    answer the right statement."""

    def __init__(self, prefix: bytes = b""):
        super().__init__("line too long")
        self.prefix = prefix


class _LineReader:
    """Own line framing on top of ``StreamReader.read``.

    asyncio's ``readline`` raises ``ValueError`` once a line passes the
    stream limit and loses buffered bytes past the separator when you try
    to recover; we keep our own buffer so an oversized line is skipped
    *exactly* (→ one ``ERR line too long``) and the connection survives.
    """

    def __init__(self, reader: asyncio.StreamReader, max_line: int = _MAX_LINE):
        self._r = reader
        self._max = max_line
        self._buf = bytearray()
        self._skip = False

    async def readline(self) -> bytes | None:
        """Next line without its terminator; None on EOF. Raises
        :class:`_LineTooLong` once per oversized line."""
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                skipped, self._skip = self._skip, False
                too_long = i > self._max
                line = b"" if (skipped or too_long) else bytes(self._buf[:i])
                prefix = bytes(self._buf[:128]) if too_long else b""
                del self._buf[: i + 1]
                if skipped:
                    continue  # tail of an already-reported oversized line
                if too_long:
                    raise _LineTooLong(prefix)
                return line.rstrip(b"\r")
            if self._skip:
                del self._buf[:]
            elif len(self._buf) > self._max:
                prefix = bytes(self._buf[:128])
                del self._buf[:]
                self._skip = True
                raise _LineTooLong(prefix)
            chunk = await self._r.read(65536)
            if not chunk:
                if self._buf and not self._skip:
                    line = bytes(self._buf).rstrip(b"\r")
                    del self._buf[:]
                    if len(line) > self._max:
                        raise _LineTooLong(line[:128])
                    return line
                return None
            self._buf += chunk


class _ResponseQueue:
    """Per-connection ordered response flusher.

    Every reply — immediate control replies and lazy statement futures
    alike — enters ONE FIFO and is written strictly in submission order,
    so pipelined clients can match responses positionally. Statement
    rendering (which syncs the lazy Result) runs in a worker thread, off
    the event loop. This per-connection ordering is what replaced the old
    global ``_exec_lock``."""

    def __init__(self, writer: asyncio.StreamWriter, server: "SQLCachedServer"):
        self._writer = writer
        self._server = server
        self._telemetry = server.db.telemetry
        self._ring = self._telemetry.ring()  # per-connection trace ring
        self._q: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self._task = asyncio.create_task(self._run())

    async def put_raw(self, tag: str | None, text: str) -> None:
        if text.startswith("ERR"):
            self._server.stats.add("errors")
        await self._q.put((tag, text, None))

    async def put_future(self, tag: str | None, fut: asyncio.Future,
                         trace: "TEL.Trace | None" = None) -> None:
        await self._q.put((tag, fut, trace))

    async def _run(self) -> None:
        closing = False
        while not closing:
            burst = [await self._q.get()]
            while not self._q.empty() and len(burst) < 64:
                burst.append(self._q.get_nowait())
            # resolve in order (responses must flush in submission order,
            # so waiting on the head future never reorders anything)
            items: list[tuple[str | None, Any, Any]] = []
            for entry in burst:
                if entry is None:
                    closing = True
                    break
                tag, payload, trace = entry
                if isinstance(payload, asyncio.Future):
                    try:
                        items.append((tag, await payload, trace))
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001
                        items.append((tag, e, trace))
                else:
                    items.append((tag, payload, trace))
            if not items:
                continue
            try:
                data, stmts, errs, done = await asyncio.to_thread(
                    _render_burst, items)
                self._server.stats.add("statements", stmts)
                self._server.stats.add("errors", errs)
                self._writer.write(data)
                await self._writer.drain()
                # trace hand-off AFTER the response is on the wire:
                # finish() is an O(1) enqueue — the histogram fold runs
                # in telemetry's background folder thread, never here
                for trace in done:
                    self._telemetry.finish(trace, ring=self._ring,
                                           error=trace.error)
            except (ConnectionError, OSError):
                # peer went away mid-write. Keep CONSUMING until the close
                # sentinel — the handler may be parked on the bounded
                # put() and must not deadlock — and retrieve future
                # exceptions so they don't surface as asyncio warnings.
                while True:
                    item = await self._q.get()
                    if item is None:
                        return
                    payload = item[1]
                    if isinstance(payload, asyncio.Future):
                        try:
                            await payload
                        except Exception:  # noqa: BLE001
                            pass

    async def close(self) -> None:
        await self._q.put(None)
        try:
            await self._task
        except asyncio.CancelledError:
            pass


class SQLCachedServer:
    """Asyncio daemon wrapping one SQLCached store.

    ``serve_forever`` listens on TCP and/or a unix socket. Connection
    handling is async; statements from every connection are admitted
    into the :class:`~repro_torch.core.scheduler.BatchScheduler`, which fuses
    same-shape runs into single ``executemany`` dispatches while per-
    connection response queues flush the lazy Results in submission
    order. ``batching=False`` keeps the single execution stream strictly
    per-statement (the paper's original regime)."""

    def __init__(self, db: SQLCached | None = None, *, batching: bool = True,
                 max_batch: int = 64, max_wait_us: int = 0):
        self.db = db or SQLCached()
        self.scheduler = BatchScheduler(self.db, batching=batching,
                                        max_batch=max_batch,
                                        max_wait_us=max_wait_us)
        self._servers: list[asyncio.AbstractServer] = []
        self._conn_tasks: set[asyncio.Task] = set()
        # atomic (telemetry.Counters): render worker threads and the
        # event loop both increment these
        self.stats = TEL.Counters({"connections": 0, "statements": 0,
                                   "errors": 0})
        # register live stats for the SHOW STATS daemon-wide roll-up
        self.db.telemetry.attach("scheduler", self.scheduler.stats)
        self.db.telemetry.attach("server", self.stats)

    # ------------------------------------------------------------ lifecycle
    async def start(
        self,
        host: str | None = "127.0.0.1",
        port: int | None = 0,
        unix_path: str | None = None,
    ) -> tuple[str, int] | None:
        await self.scheduler.start()
        addr = None
        if host is not None and port is not None:
            srv = await asyncio.start_server(self._handle, host, port,
                                             limit=_MAX_LINE)
            self._servers.append(srv)
            addr = srv.sockets[0].getsockname()[:2]
        if unix_path is not None:
            srv = await asyncio.start_unix_server(self._handle, unix_path,
                                                  limit=_MAX_LINE)
            self._servers.append(srv)
        return addr

    async def stop(self) -> None:
        for srv in self._servers:
            srv.close()
            await srv.wait_closed()
        self._servers.clear()
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await self.scheduler.stop()

    # ------------------------------------------------------------- protocol
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.stats.add("connections")
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        resp = _ResponseQueue(writer, self)
        lines = _LineReader(reader)
        # statements being assembled, keyed by tag (None = untagged);
        # `cur` is the most recent EXEC's tag — untagged ARG/GO bind to
        # it. Each entry carries the trace stamped at EXEC receipt.
        pending: dict[str | None, tuple[str, list, Any]] = {}
        cur: str | None = None
        # response invariant: every submitted statement gets EXACTLY ONE
        # response block, or pipelined clients desync. A statement that
        # already drew its ERR (too-long line, bad ARG, pending-cap
        # rejection) must have its remaining ARG/GO lines swallowed:
        # `dropped` covers the known-tag cases; `poisoned` covers an
        # untagged dropped line and swallows only UNTAGGED ARG/GO (tagged
        # lines always belong to an identifiable statement).
        poisoned = False
        dropped: set[str | None] = set()

        def _mark_dropped(key: str | None) -> bool:
            """False when the drop-tracking budget is exhausted (protocol
            abuse) — the caller must close the connection rather than
            risk emitting a second response for a statement."""
            if len(dropped) >= _MAX_PENDING:
                return False
            dropped.add(key)
            return True

        try:
            while True:
                try:
                    line = await lines.readline()
                except _LineTooLong as tl:
                    head = tl.prefix.decode("utf-8", "replace")
                    hverb, _, _ = head.partition(" ")
                    hverb, _, htag = hverb.partition("#")
                    hverb = hverb.upper()
                    htag = htag or None
                    if hverb in ("EXEC", "ARG", "GO"):
                        # the oversized line's statement is identifiable
                        # (its tag, or — for an untagged ARG/GO — the most
                        # recent EXEC): answer THAT statement once and
                        # retire it; cur moves onto the dropped key so its
                        # remaining untagged ARG/GO lines are swallowed
                        key = htag if htag is not None else (
                            None if hverb == "EXEC" else cur)
                        pending.pop(key, None)
                        if hverb != "GO":
                            if not _mark_dropped(key):
                                await resp.put_raw(None,
                                                   "ERR pipeline abuse")
                                break
                            cur = key
                        await resp.put_raw(key, "ERR line too long")
                    else:
                        await resp.put_raw(None, "ERR line too long")
                        poisoned = True
                    continue
                if line is None:
                    break
                text = line.decode("utf-8", "replace")
                if not text:
                    continue
                verb, _, rest = text.partition(" ")
                verb, _, tag = verb.partition("#")
                verb = verb.upper()
                tag = tag or None
                if verb == "EXEC":
                    poisoned = False
                    dropped.discard(tag)
                    if tag not in pending and len(pending) >= _MAX_PENDING:
                        await resp.put_raw(
                            tag, "ERR too many in-flight statements")
                        if not _mark_dropped(tag):
                            await resp.put_raw(None, "ERR pipeline abuse")
                            break
                        cur = tag
                        continue
                    pending[tag] = (rest, [], self.db.telemetry.trace())
                    cur = tag
                elif verb == "ARG":
                    if poisoned and tag is None:
                        continue
                    key = tag if tag is not None else cur
                    if key in dropped:
                        continue  # statement already answered with ERR
                    st = pending.get(key)
                    if st is None:
                        await resp.put_raw(key, "ERR ARG without EXEC")
                        continue
                    kind, _, raw = rest.partition(" ")
                    try:
                        st[1].append(_decode_arg(kind, raw))
                    except Exception as e:  # noqa: BLE001
                        # drop the whole half-bound statement — its later
                        # ARGs and its GO are swallowed, so the ONE error
                        # response keeps the pipeline in sync
                        pending.pop(key, None)
                        if not _mark_dropped(key):
                            await resp.put_raw(None, "ERR pipeline abuse")
                            break
                        await resp.put_raw(key, f"ERR bad arg: {e}")
                elif verb == "GO":
                    if poisoned and tag is None:
                        poisoned = False
                        continue
                    key = tag if tag is not None else cur
                    if key in dropped:
                        dropped.discard(key)
                        continue  # statement already answered with ERR
                    st = pending.pop(key, None)
                    if st is None or not st[0]:
                        await resp.put_raw(key, "ERR no statement")
                        continue
                    fut = self.scheduler.submit(st[0], st[1], trace=st[2])
                    await resp.put_future(key, fut, st[2])
                elif verb == "PING":
                    await resp.put_raw(tag, "PONG")
                elif verb == "QUIT":
                    await resp.put_raw(tag, "BYE")
                    break
                else:
                    await resp.put_raw(tag, f"ERR unknown verb {verb!r}")
        finally:
            try:
                await resp.close()
            except asyncio.CancelledError:
                resp._task.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except BaseException:  # noqa: BLE001 — incl. CancelledError
                pass
            if task is not None:
                self._conn_tasks.discard(task)


class SQLCachedClient:
    """Small synchronous client (what a web app's cache layer would embed).

    ``execute`` keeps the original one-round-trip-per-statement dialect;
    :meth:`pipeline` opens a tagged pipeline that streams statements
    without waiting and collects all responses at once."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 unix_path: str | None = None, timeout: float = 10.0,
                 connect_retries: int = 0, retry_base: float = 0.05,
                 retry_cap: float = 2.0):
        self._host, self._port = host, port
        self._unix_path = unix_path
        self._timeout = timeout
        self._connect_retries = connect_retries
        self._retry_base, self._retry_cap = retry_base, retry_cap
        self._sock = self._connect()
        self._buf = b""
        self._tag = 0

    def _connect(self) -> socket.socket:
        """Dial with up to ``connect_retries`` retries (capped exponential
        backoff + jitter) — a daemon that is still booting, or restarting
        after a crash, stops being the caller's race to lose."""
        last: Exception | None = None
        for delay in itertools.chain(
                [None], backoff_delays(self._connect_retries,
                                       self._retry_base, self._retry_cap)):
            if delay is not None:
                time.sleep(delay)
            try:
                if self._unix_path is not None:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.settimeout(self._timeout)
                    s.connect(self._unix_path)
                else:
                    s = socket.create_connection(
                        (self._host, self._port), timeout=self._timeout)
                s.settimeout(self._timeout)
                return s
            except OSError as e:
                last = e
        where = (self._unix_path if self._unix_path is not None
                 else f"{self._host}:{self._port}")
        raise ConnectionError(
            f"could not connect to {where} after "
            f"{self._connect_retries + 1} attempt(s): {last}")

    def reconnect(self) -> None:
        """Re-establish a dropped connection IN PLACE: fresh socket, empty
        read buffer, same client object — callers keep their handle
        instead of rebuilding. Responses in flight on the old socket are
        gone (resend their statements); the tag counter keeps rising so
        replayed statements stay distinguishable from new ones."""
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = self._connect()
        self._buf = b""

    def _next_tag(self) -> str:
        self._tag += 1
        return str(self._tag)

    def _readline(self) -> str:
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed connection")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return line.decode().rstrip("\r")

    def _read_result(self, tag: str | None = None) -> dict:
        """Read one COUNT/VALUE/ROW.../END response block. ``tag`` is the
        expected response tag (None = untagged). Stray control lines
        (PONG/BYE), mismatched tags and unknown verbs raise — a desynced
        connection must never masquerade as a successful empty result."""
        result: dict = {"count": 0, "value": None, "rows": []}
        while True:
            line = self._readline()
            verb, _, rest = line.partition(" ")
            verb, _, rtag = verb.partition("#")
            rtag = rtag or None
            if verb in ("COUNT", "VALUE", "ROW", "END", "ERR") and rtag != tag:
                raise RuntimeError(
                    f"protocol desync: expected tag {tag!r}, got {line!r}")
            if verb == "COUNT":
                result["count"] = int(rest)
            elif verb == "VALUE":
                try:
                    result["value"] = json.loads(rest)
                except json.JSONDecodeError:
                    result["value"] = rest
            elif verb == "ROW":
                result["rows"].append(json.loads(rest))
            elif verb == "END":
                return result
            elif verb == "ERR":
                raise RuntimeError(f"server error: {rest}")
            else:
                raise RuntimeError(f"protocol desync: unexpected {line!r}")

    def execute(self, sql: str, params: Sequence[Any] = ()) -> dict:
        out = [f"EXEC {sql}"]
        out += [_encode_arg(p) for p in params]
        out.append("GO")
        self._sock.sendall(("\r\n".join(out) + "\r\n").encode())
        return self._read_result(None)

    def warmup(self, table: str, like: str | None = None) -> dict:
        """Pre-plan ``table``'s executors server-side (``WARMUP t [LIKE
        '<stmt>']``): count = newly compiled executables."""
        return self.execute(_warmup_sql(table, like))

    def pipeline(self) -> "Pipeline":
        """Open a client-side pipeline (usable as a context manager —
        leaving the ``with`` block collects into ``.results``)."""
        return Pipeline(self)

    def ping(self) -> bool:
        self._sock.sendall(b"PING\r\n")
        return self._readline() == "PONG"

    def close(self) -> None:
        try:
            self._sock.sendall(b"QUIT\r\n")
        except OSError:
            pass
        self._sock.close()


class Pipeline:
    """Client-side pipelining over the tagged dialect: queue statements
    without waiting, flush them in one write, then :meth:`collect` all
    responses in submission order (the server guarantees that order)."""

    def __init__(self, client: SQLCachedClient):
        self._c = client
        self._out: list[str] = []
        self._tags: list[str] = []
        self.results: list = []

    def __len__(self) -> int:
        return len(self._tags)

    def execute(self, sql: str, params: Sequence[Any] = ()) -> int:
        """Queue one statement; returns its index into :meth:`collect`'s
        result list."""
        tag = self._c._next_tag()
        self._out.append(f"EXEC#{tag} {sql}")
        self._out += [_encode_arg(p) for p in params]
        self._out.append(f"GO#{tag}")
        self._tags.append(tag)
        return len(self._tags) - 1

    def flush(self) -> None:
        """Stream every queued frame to the server without reading."""
        if self._out:
            self._c._sock.sendall(("\r\n".join(self._out) + "\r\n").encode())
            self._out.clear()

    def collect(self, return_exceptions: bool = False) -> list:
        """Flush, then read one response per queued statement, in order.
        Statement errors become RuntimeError entries (``return_exceptions=
        True``) or raise after the whole pipeline has drained. A dying
        server becomes one clean ``ConnectionError`` PER unanswered tag —
        never a hang, never a silently short result list: the result list
        always has exactly one entry per queued statement."""
        self.flush()
        out: list = []
        errs: list[Exception] = []
        for i, tag in enumerate(self._tags):
            try:
                out.append(self._c._read_result(tag))
            except RuntimeError as e:
                out.append(e)
                errs.append(e)
            except OSError as e:  # incl. ConnectionError / socket.timeout
                # dead socket: no later tag can be answered either — fail
                # this one and every still-queued statement, each with its
                # own entry, so positional matching survives the crash
                for t2 in self._tags[i:]:
                    ce = ConnectionError(
                        f"connection lost before response for tag {t2}: {e}")
                    out.append(ce)
                    errs.append(ce)
                break
        self._tags.clear()
        self.results = out
        if errs and not return_exceptions:
            raise errs[0]
        return out

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.collect(return_exceptions=True)


class AsyncSQLCachedClient:
    """Asyncio client speaking the tagged dialect.

    ``execute`` coroutines may be issued concurrently (``gather``) — each
    statement streams out immediately and its future resolves when the
    tagged response arrives, so N outstanding statements cost one round
    trip instead of N. Responses arrive in per-connection submission
    order; a background reader task matches them to the FIFO of pending
    futures (tags are verified, desync fails every pending call)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._r = reader
        self._w = writer
        self._tag = 0
        self._fifo: deque[tuple[str | None, asyncio.Future]] = deque()
        self._reader_task = asyncio.create_task(self._read_loop())
        # set by connect(); reconnect() needs it to re-dial
        self._dial: tuple[str, int, str | None] | None = None

    @classmethod
    async def connect(cls, host: str = "127.0.0.1", port: int = 0,
                      unix_path: str | None = None,
                      connect_retries: int = 0, retry_base: float = 0.05,
                      retry_cap: float = 2.0) -> "AsyncSQLCachedClient":
        """Dial with up to ``connect_retries`` retries (capped exponential
        backoff + jitter, like the sync client's)."""
        r, w = await cls._dial_streams(host, port, unix_path,
                                       connect_retries, retry_base,
                                       retry_cap)
        c = cls(r, w)
        c._dial = (host, port, unix_path)
        return c

    @staticmethod
    async def _dial_streams(host, port, unix_path, connect_retries,
                            retry_base, retry_cap):
        last: Exception | None = None
        for delay in itertools.chain(
                [None],
                backoff_delays(connect_retries, retry_base, retry_cap)):
            if delay is not None:
                await asyncio.sleep(delay)
            try:
                if unix_path is not None:
                    return await asyncio.open_unix_connection(unix_path)
                return await asyncio.open_connection(host, port)
            except OSError as e:
                last = e
        where = unix_path if unix_path is not None else f"{host}:{port}"
        raise ConnectionError(
            f"could not connect to {where} after "
            f"{connect_retries + 1} attempt(s): {last}")

    async def reconnect(self, connect_retries: int = 0,
                        retry_base: float = 0.05,
                        retry_cap: float = 2.0) -> None:
        """Re-establish a dropped connection IN PLACE (clients built via
        :meth:`connect` only). Every still-pending future fails with
        ``ConnectionError`` first — their responses died with the old
        socket; resend those statements. The tag counter keeps rising so
        replays stay distinguishable."""
        if self._dial is None:
            raise RuntimeError("reconnect() needs a client built by "
                               "AsyncSQLCachedClient.connect()")
        self._reader_task.cancel()
        try:
            await self._reader_task
        except asyncio.CancelledError:
            pass
        self._w.close()
        try:
            await self._w.wait_closed()
        except Exception:  # noqa: BLE001
            pass
        host, port, unix_path = self._dial
        self._r, self._w = await self._dial_streams(
            host, port, unix_path, connect_retries, retry_base, retry_cap)
        self._reader_task = asyncio.create_task(self._read_loop())

    async def execute(self, sql: str, params: Sequence[Any] = ()) -> dict:
        self._check_alive()
        self._tag += 1
        tag = str(self._tag)
        lines = [f"EXEC#{tag} {sql}"]
        lines += [_encode_arg(p) for p in params]
        lines.append(f"GO#{tag}")
        fut = asyncio.get_running_loop().create_future()
        self._fifo.append((tag, fut))
        self._w.write(("\r\n".join(lines) + "\r\n").encode())
        await self._w.drain()
        return await fut

    async def warmup(self, table: str, like: str | None = None) -> dict:
        """Pre-plan ``table``'s executors server-side (``WARMUP t [LIKE
        '<stmt>']``): count = newly compiled executables."""
        return await self.execute(_warmup_sql(table, like))

    async def ping(self, deadline: float | None = None) -> bool:
        """Liveness probe. With ``deadline`` (seconds) a late PONG raises
        ``TimeoutError`` — the health-check contract: the PONG rides the
        ordered response stream, so meeting the deadline proves the
        node's event loop is draining its queue, not merely that TCP
        still connects. A node that misses its deadline is treated by
        the cluster tier exactly like a dead one."""
        self._check_alive()
        fut = asyncio.get_running_loop().create_future()
        self._fifo.append((None, fut))
        self._w.write(b"PING\r\n")
        await self._w.drain()
        if deadline is None:
            return await fut
        return await asyncio.wait_for(fut, deadline)

    def _check_alive(self) -> None:
        """Fail fast once the read loop has exited: a half-closed peer
        (FIN received, our write side still open) would otherwise accept
        the statement bytes and leave the response future pending
        forever. No await between this check and the fifo append, so the
        read loop's drain-on-exit can never miss the new entry."""
        if self._reader_task.done():
            raise ConnectionError(
                "connection lost (reader exited); reconnect() to resume")

    async def _read_loop(self) -> None:
        cur: dict | None = None
        err: Exception = ConnectionError("server closed connection")
        try:
            while True:
                raw = await self._r.readline()
                if not raw:
                    break
                text = raw.decode("utf-8", "replace").rstrip("\r\n")
                if not text:
                    continue
                verb, _, rest = text.partition(" ")
                verb, _, rtag = verb.partition("#")
                rtag = rtag or None
                if verb == "BYE":
                    break
                head = self._fifo[0] if self._fifo else None
                if verb == "PONG":
                    if head is None or head[0] is not None:
                        raise RuntimeError(f"protocol desync: stray {text!r}")
                    self._fifo.popleft()
                    if not head[1].done():
                        head[1].set_result(True)
                    continue
                if head is None or head[0] != rtag:
                    raise RuntimeError(
                        f"protocol desync: unexpected {text!r}")
                if cur is None:
                    cur = {"count": 0, "value": None, "rows": []}
                if verb == "COUNT":
                    cur["count"] = int(rest)
                elif verb == "VALUE":
                    try:
                        cur["value"] = json.loads(rest)
                    except json.JSONDecodeError:
                        cur["value"] = rest
                elif verb == "ROW":
                    cur["rows"].append(json.loads(rest))
                elif verb == "END":
                    self._fifo.popleft()
                    if not head[1].done():
                        head[1].set_result(cur)
                    cur = None
                elif verb == "ERR":
                    self._fifo.popleft()
                    if not head[1].done():
                        head[1].set_exception(
                            RuntimeError(f"server error: {rest}"))
                    cur = None
                else:
                    raise RuntimeError(f"protocol desync: unexpected {text!r}")
        except Exception as e:  # noqa: BLE001
            err = e
        finally:
            while self._fifo:
                _, fut = self._fifo.popleft()
                if not fut.done():
                    fut.set_exception(err)

    async def close(self) -> None:
        try:
            self._w.write(b"QUIT\r\n")
            await self._w.drain()
        except (ConnectionError, OSError):
            pass
        try:
            await asyncio.wait_for(self._reader_task, timeout=5)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            self._reader_task.cancel()
        self._w.close()
        try:
            await self._w.wait_closed()
        except Exception:  # noqa: BLE001
            pass


class ThreadedServer:
    """Run an :class:`SQLCachedServer` on its own event-loop thread —
    for synchronous tests, benchmarks and embedding in non-async apps.
    Usable as a context manager; ``addr`` is the TCP (host, port)."""

    def __init__(self, unix_path: str | None = None, host: str = "127.0.0.1",
                 port: int = 0, db: SQLCached | None = None, **server_kw):
        self.unix_path = unix_path
        self.addr: tuple[str, int] | None = None
        self.server: SQLCachedServer | None = None
        self._host, self._port = host, port
        self._db, self._server_kw = db, server_kw
        self._loop: asyncio.AbstractEventLoop | None = None
        self._boot_error: BaseException | None = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("server thread did not start in 10 s")
        if self._boot_error is not None:
            self._thread.join(5)
            raise self._boot_error

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self.server = SQLCachedServer(self._db, **self._server_kw)

        async def boot():
            try:
                self.addr = await self.server.start(
                    self._host, self._port, unix_path=self.unix_path)
            except BaseException as e:  # noqa: BLE001 — rethrown in __init__
                self._boot_error = e
            finally:
                self._started.set()

        self._loop.run_until_complete(boot())
        if self._boot_error is None:
            self._loop.run_forever()

    def stop(self) -> None:
        async def down():
            await self.server.stop()

        asyncio.run_coroutine_threadsafe(down(), self._loop).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)

    def __enter__(self) -> "ThreadedServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def run_server_forever(host: str, port: int, unix_path: str | None = None,
                       db: SQLCached | None = None) -> None:
    """Blocking entry point (used by `python -m repro_torch.core.protocol`)."""

    async def main():
        server = SQLCachedServer(db)
        addr = await server.start(host, port, unix_path)
        # machine-readable + flushed: the cluster launcher and the chaos
        # harness spawn daemons with --port 0 and parse the bound port
        if addr is not None:
            # reprolint: disable=REP005(startup handshake: cluster_up and the chaos harness parse the bound port from stdout)
            print(f"SQLCACHED READY {addr[0]} {addr[1]}", flush=True)
        else:
            # reprolint: disable=REP005(startup handshake: cluster_up and the chaos harness parse the socket path from stdout)
            print(f"SQLCACHED READY unix {unix_path}", flush=True)
        # reprolint: disable=REP005(one-shot operator banner at startup, not on the serving path)
        print(f"sqlcached listening on {addr} unix={unix_path}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=11222)
    ap.add_argument("--unix", default=None)
    a = ap.parse_args()
    run_server_forever(a.host, a.port, a.unix)
