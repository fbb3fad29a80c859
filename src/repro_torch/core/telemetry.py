"""Port copy of ``repro.core.telemetry`` (host Python) with its imports
redirected to ``repro_torch``.

Host-side serving telemetry: trace spans, histograms, slow log (PR 9).

Observability layer for the serving path.  Everything here is *host only*
— no jax import, no device handle is ever touched — so recording a span
or reading a report can never force a device sync or a
``.block_until_ready()`` on the serving path.

Pieces
------
``Trace``
    Per-statement trace context, stamped at wire receipt
    (``protocol._handle`` on EXEC) and carried through the scheduler to
    the render flush.  ``mark(stage)`` accumulates a monotonic-clock span
    delta into the stage's fixed slot (a clock read plus a float store —
    no allocation); stages on the batched wire path are::

        wire    EXEC receipt -> scheduler admission (frame reassembly, GO wait)
        parse   statement shape derivation at admission
        queue   admission -> start of lane-lock acquisition
        lock    lane/table lock wait
        execute the db.execute/executemany call (includes compile on miss)
        render  response render + lazy-result materialisation at flush

    Attribution fields (``mode``, ``cache``, ``compile_ms``, ``group``,
    ``wave``) are filled in by the dispatch layers via the thread-local
    dispatch context below.

``Counters``
    Lock-guarded counter map with dict-style reads.  This is the atomic
    increment helper the scheduler / server / executor-cache stats use:
    plain ``d[k] += 1`` is a read-modify-write that loses increments
    under concurrent waves; ``Counters.add`` takes a lock per increment
    so totals are exact.

``Histogram``
    Fixed log2-bucketed latency histogram (bucket i counts samples in
    [2^i, 2^(i+1)) microseconds).  Per-bucket increments are plain list
    stores — lock-free — and merging two histograms sums raw buckets,
    so cluster-wide percentiles are computed from merged buckets, never
    percentile-of-percentile.

``Telemetry``
    Per-``SQLCached`` aggregator: per-(table, kind) histograms + stage /
    mode / cache attribution, per-connection rings, and the bounded
    slow-statement ring (``SQLCached(slow_ms=...)`` / ``REPRO_SLOW_MS``).
    Disabled entirely with ``REPRO_TELEMETRY=0`` (``trace()`` returns
    None and the serving path pays nothing but a None check).
    ``finish`` is an O(1) enqueue: the per-shape histogram fold runs in
    a lazy background folder thread (with a fold-on-read backstop at
    report time), keeping even that host work off the serving path.

Dispatch context
----------------
The scheduler runs db calls in worker threads via ``asyncio.to_thread``.
``dispatch_span(traces)`` installs the live traces in a thread-local so
code deep inside the dispatch — ``daemon._run_state`` (exec_mode) and
``execache.ExecEntry`` (hit/miss/compile) — can attribute into them with
``note_mode`` / ``note_exec`` without any plumbing through call
signatures.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

from repro_torch.lint import lockorder as LK

__all__ = [
    "Counters",
    "Histogram",
    "Telemetry",
    "Trace",
    "bucket_of",
    "bucket_bounds",
    "current_traces",
    "dispatch_span",
    "merge_reports",
    "note_exec",
    "note_mode",
    "prom",
]

# 2^0 .. 2^(N_BUCKETS-1) microseconds; the last bucket absorbs the tail
# (2^39 us ~ 6.4 days — nothing legitimate lands there).
N_BUCKETS = 40


def bucket_of(us: float) -> int:
    """Log2 bucket index for a latency in microseconds."""
    u = int(us)
    if u < 1:
        return 0
    b = u.bit_length() - 1
    return b if b < N_BUCKETS else N_BUCKETS - 1


def bucket_bounds(i: int) -> tuple[int, int]:
    """[lo, hi) microsecond bounds of bucket ``i``."""
    return (1 << i) if i else 0, 1 << (i + 1)


class Counters:
    """Atomic counter map with dict-style reads.

    Writes (``add`` / ``max`` / ``__setitem__``) take an internal lock so
    concurrent increments from scheduler waves and render threads never
    lose updates; reads use the plain dict protocol so existing
    ``stats["key"]`` / ``dict(stats)`` call sites keep working.
    """

    __slots__ = ("_d", "_lock")

    def __init__(self, initial: dict | None = None):
        self._d: dict[str, Any] = dict(initial or {})
        self._lock = LK.make_lock("telemetry.counters")

    def add(self, key: str, n: int | float = 1) -> None:
        with self._lock:
            self._d[key] = self._d.get(key, 0) + n

    def max(self, key: str, value: int | float) -> None:
        with self._lock:
            if value > self._d.get(key, 0):
                self._d[key] = value

    def bulk(self, pairs) -> None:
        """Apply many (key, delta) increments under ONE lock acquisition
        — keeps per-statement stage attribution off the latency profile."""
        with self._lock:
            d = self._d
            for key, n in pairs:
                d[key] = d.get(key, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._d)

    # dict-read protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._d[key]

    def __setitem__(self, key: str, value: Any) -> None:
        with self._lock:
            self._d[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Counters):
            return self._d == other._d
        if isinstance(other, dict):
            return self._d == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Counters({self._d!r})"


class Histogram:
    """Fixed log2-bucketed microsecond histogram.

    ``record`` is a single list-element increment — lock-free and
    sync-free.  Under free-threading two racing increments on the *same*
    bucket may drop one (best effort); exactness guarantees live in
    ``Counters``.  Merging sums raw buckets, which IS exact.
    """

    __slots__ = ("counts",)

    def __init__(self, counts: list[int] | None = None):
        self.counts = list(counts) if counts else [0] * N_BUCKETS

    def record(self, us: float) -> None:
        self.counts[bucket_of(us)] += 1

    @property
    def n(self) -> int:
        return sum(self.counts)

    def percentile(self, q: float) -> float | None:
        """q in [0, 1] -> geometric-midpoint latency of the q-th bucket."""
        n = self.n
        if n == 0:
            return None
        rank = q * n
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                lo, hi = bucket_bounds(i)
                return math.sqrt(max(lo, 1) * hi)
        return None

    def merge(self, counts: dict[str, int] | list[int]) -> None:
        """Sum another histogram's raw buckets into this one (exact)."""
        if isinstance(counts, dict):
            for k, c in counts.items():
                self.counts[int(k)] += c
        else:
            for i, c in enumerate(counts):
                self.counts[i] += c

    def sparse(self) -> dict[str, int]:
        """JSON-friendly {bucket-index: count} with empty buckets elided."""
        return {str(i): c for i, c in enumerate(self.counts) if c}


class _ShapeStats:
    """Aggregates for one (table, kind) statement shape."""

    __slots__ = ("hist", "stages", "modes", "cache")

    def __init__(self):
        self.hist = Histogram()
        self.stages = Counters()   # "<stage>.us" totals + "<stage>.n" counts
        self.modes = Counters()    # lane / stacked / mesh / mono
        self.cache = Counters()    # hit / miss / compile / fallback / compile_ms

    def to_dict(self) -> dict:
        h = self.hist
        stages = {}
        for key, val in sorted(self.stages.snapshot().items()):
            stage, _, what = key.rpartition(".")
            ent = stages.setdefault(stage, {})
            if what == "us":
                ent["total_us"] = round(val, 1)
            else:
                ent["count"] = val
        for ent in stages.values():
            if ent.get("count"):
                ent["mean_us"] = round(ent.get("total_us", 0.0) / ent["count"], 1)
        out = {
            "count": h.n,
            "buckets": h.sparse(),
            "stages": stages,
            "modes": self.modes.snapshot(),
            "cache": {k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in self.cache.snapshot().items()},
        }
        for name, q in (("p50_us", 0.50), ("p99_us", 0.99), ("p999_us", 0.999)):
            p = h.percentile(q)
            if p is not None:
                out[name] = round(p, 1)
        return out


# The serving-path stages, in pipeline order.  Spans live in fixed float
# slots (one per stage) rather than an append-only list: marking a span
# is then a clock read plus a float store — ZERO container allocations —
# which keeps telemetry from raising the GC collection rate (gen2 scans
# of a daemon's object graph are milliseconds, and they land on whatever
# statement is in flight).
STAGES = ("wire", "parse", "queue", "lock", "execute", "render")
_SLOT = {s: "s_" + s for s in STAGES}
_STAGE_KEYS = tuple((s, "s_" + s, s + ".us", s + ".n") for s in STAGES)


class Trace:
    """Per-statement trace context; spans are per-stage delta_us slots."""

    __slots__ = ("t0", "last", "s_wire", "s_parse", "s_queue", "s_lock",
                 "s_execute", "s_render", "sql", "table", "kind",
                 "mode", "cache", "compile_ms", "group", "wave", "error")

    def __init__(self, sql: str | None = None):
        self.t0 = self.last = time.perf_counter()
        self.s_wire = self.s_parse = self.s_queue = 0.0
        self.s_lock = self.s_execute = self.s_render = 0.0
        self.sql = sql
        self.table: str | None = None
        self.kind: str | None = None
        self.mode: str | None = None
        self.cache: str | None = None
        self.compile_ms = 0.0
        self.group: int | None = None
        self.wave: int | None = None
        self.error = False

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        slot = _SLOT[stage]
        setattr(self, slot, getattr(self, slot) + (now - self.last) * 1e6)
        self.last = now

    @property
    def spans(self) -> list[tuple[str, float]]:
        """(stage, delta_us) pairs for the stages that were marked, in
        pipeline order (built on read — never on the serving path)."""
        return [(s, v) for s, slot, _, _ in _STAGE_KEYS
                if (v := getattr(self, slot))]

    def stage_totals(self) -> dict[str, float]:
        return dict(self.spans)

    def to_dict(self) -> dict:
        d = {
            "sql": self.sql,
            "table": self.table,
            "kind": self.kind,
            "total_us": round((self.last - self.t0) * 1e6, 1),
            "stages": {k: round(v, 1) for k, v in self.stage_totals().items()},
        }
        if self.mode is not None:
            d["mode"] = self.mode
        if self.cache is not None:
            d["cache"] = self.cache
        if self.compile_ms:
            d["compile_ms"] = round(self.compile_ms, 3)
        if self.group is not None:
            d["group"] = self.group
        if self.wave is not None:
            d["wave"] = self.wave
        return d


# ---------------------------------------------------------------------------
# Thread-local dispatch context: lets daemon._run_state / execache attribute
# exec_mode and cache events into the live traces without signature plumbing.

_TLS = threading.local()


class dispatch_span:
    """Install ``traces`` as the ambient dispatch context for this thread.

    A plain class-based context manager (not ``@contextmanager``): it
    sits on the per-statement dispatch path, where the generator
    machinery is measurable overhead.
    """

    __slots__ = ("_traces", "_prev")

    def __init__(self, traces):
        self._traces = [t for t in traces if t is not None] or None

    def __enter__(self):
        self._prev = getattr(_TLS, "traces", None)
        _TLS.traces = self._traces
        return self._traces

    def __exit__(self, exc_type, exc, tb):
        _TLS.traces = self._prev
        return False


def current_traces() -> tuple[Trace, ...] | list[Trace]:
    return getattr(_TLS, "traces", None) or ()


def note_mode(mode: str) -> None:
    """Record the exec_mode (lane/stacked/mesh/mono) on the live traces."""
    for tr in current_traces():
        tr.mode = mode


def note_exec(event: str, compile_ms: float = 0.0) -> None:
    """Record an executor-cache event (hit/compile/fallback) on live traces."""
    for tr in current_traces():
        tr.cache = event
        tr.compile_ms += compile_ms


class Telemetry:
    """Per-daemon telemetry aggregator (one per ``SQLCached``)."""

    RING_SIZE = 256
    SLOW_SIZE = 128
    FOLD_INTERVAL_S = 0.05     # background folder poll period
    FOLD_IDLE_EXIT = 40        # idle polls (~2s) before the folder exits

    def __init__(self, slow_ms: float | None = None,
                 enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_TELEMETRY", "1") != "0"
        if slow_ms is None:
            env = os.environ.get("REPRO_SLOW_MS")
            slow_ms = float(env) if env not in (None, "") else None
        self.enabled = enabled
        self.slow_ms = slow_ms
        self.started = time.monotonic()
        self._shapes: dict[tuple[str, str], _ShapeStats] = {}
        self._shapes_lock = LK.make_lock("telemetry.shapes")  # dict insertion only
        self.slow: deque[Trace] = deque(maxlen=self.SLOW_SIZE)
        self._sources: dict[str, Any] = {}     # name -> Counters/dict views
        # finished traces waiting to be folded into the histograms: the
        # serving path only ever pays one deque append; aggregation runs
        # in the background folder thread or at SHOW/report time
        self._pending: deque[Trace] = deque()
        self._fold_lock = LK.make_lock("telemetry.fold")  # one folder at a time
        self._folder: threading.Thread | None = None

    # -- serving path ----------------------------------------------------
    def trace(self, sql: str | None = None) -> Trace | None:
        if not self.enabled:
            return None
        return Trace(sql)

    def ring(self) -> deque:
        """Fresh per-connection ring of finished :class:`Trace` objects
        (rendered to dicts only when read, never on the serving path)."""
        return deque(maxlen=self.RING_SIZE)

    def finish(self, trace: Trace, ring: deque | None = None,
               error: bool = False) -> float:
        """Record a finished trace; returns its total latency in us.

        O(1) on purpose: two deque appends and a thread-liveness check.
        Folding the trace into per-shape histograms/counters costs a few
        microseconds of pure-python work, but doing it inline — even
        after the response bytes are on the wire — showed up as tens of
        microseconds of round-trip p50 on the batched wire path (GIL /
        thread-handoff amplification on the event loop).  So the trace
        is queued and folded OFF the serving path, by a lazy background
        folder thread (started on first use, exits when idle) with a
        fold-on-read backstop in :meth:`report` / :meth:`slow_entries`.
        """
        total_us = (trace.last - trace.t0) * 1e6
        # rings hold the Trace objects themselves; dict rendering happens
        # at SHOW time, never on the serving path
        if ring is not None:
            ring.append(trace)
        if error:
            trace.error = True
        self._pending.append(trace)
        if self._folder is None:
            self._ensure_folder()
        return total_us

    # -- deferred fold ---------------------------------------------------
    def fold(self) -> None:
        """Drain the pending queue into the per-shape aggregates.

        Serialized by ``_fold_lock`` so histogram bucket increments stay
        single-writer (exact), wherever the fold is triggered from.
        """
        if not self._pending:
            return
        with self._fold_lock:
            pending = self._pending
            while pending:
                try:
                    trace = pending.popleft()
                except IndexError:
                    break
                self._fold_one(trace)

    def _fold_one(self, trace: Trace) -> None:
        error = trace.error
        total_us = (trace.last - trace.t0) * 1e6
        key = (trace.table or "-", trace.kind or ("error" if error else "other"))
        ss = self._shapes.get(key)
        if ss is None:
            with self._shapes_lock:
                ss = self._shapes.setdefault(key, _ShapeStats())
        ss.hist.record(total_us)
        stages = ss.stages
        with stages._lock:   # one acquisition for all stage keys
            d = stages._d
            for _, slot, kus, kn in _STAGE_KEYS:
                v = getattr(trace, slot)
                if v:
                    d[kus] = d.get(kus, 0) + v
                    d[kn] = d.get(kn, 0) + 1
        if trace.mode is not None:
            ss.modes.add(trace.mode)
        if trace.cache is not None:
            if trace.compile_ms:
                ss.cache.bulk(((trace.cache, 1),
                               ("compile_ms", trace.compile_ms)))
            else:
                ss.cache.add(trace.cache)
        if error:
            ss.cache.add("errors")
        if self.slow_ms is not None and total_us >= self.slow_ms * 1e3:
            self.slow.append(trace)

    def _ensure_folder(self) -> None:
        with self._shapes_lock:
            if self._folder is None:
                t = threading.Thread(target=self._fold_loop,
                                     name="telemetry-fold", daemon=True)
                self._folder = t
                t.start()

    def _fold_loop(self) -> None:
        idle = 0
        while idle < self.FOLD_IDLE_EXIT:
            time.sleep(self.FOLD_INTERVAL_S)
            if self._pending:
                idle = 0
                self.fold()
            else:
                idle += 1
        # gone quiet: exit and let the next finish() respawn us.  Clear
        # the liveness flag FIRST, then drain once more so a trace that
        # raced in during shutdown is not stranded until the next read.
        self._folder = None
        self.fold()

    def slow_entries(self) -> list[Trace]:
        """Snapshot of the slow-statement ring (folds pending first)."""
        self.fold()
        return list(self.slow)

    # -- daemon-wide roll-up sources (scheduler / server stats) ----------
    def attach(self, name: str, stats) -> None:
        """Register a live stats mapping for the SHOW STATS roll-up."""
        self._sources[name] = stats

    def sources(self) -> dict[str, dict]:
        out = {}
        for name, stats in self._sources.items():
            out[name] = stats.snapshot() if isinstance(stats, Counters) else dict(stats)
        return out

    # -- reporting -------------------------------------------------------
    def uptime_s(self) -> float:
        return round(time.monotonic() - self.started, 3)

    def report(self, table: str | None = None) -> dict:
        self.fold()
        shapes = {}
        for (tbl, kind), ss in sorted(self._shapes.items()):
            if table is not None and tbl != table:
                continue
            shapes[f"{tbl}.{kind}"] = ss.to_dict()
        return {
            "enabled": self.enabled,
            "uptime_s": self.uptime_s(),
            "bucket_base": 2,
            "bucket_unit": "us",
            "shapes": shapes,
            "slow": len(self.slow),
        }


def merge_reports(reports: list[dict]) -> dict:
    """Merge ``Telemetry.report`` dicts from several nodes.

    Buckets, stage totals, mode and cache counts sum exactly; percentiles
    are recomputed from the merged buckets — never averaged.
    """
    shapes: dict[str, dict] = {}
    for rep in reports:
        for name, sd in (rep.get("shapes") or {}).items():
            agg = shapes.get(name)
            if agg is None:
                agg = shapes[name] = {
                    "count": 0, "buckets": {}, "stages": {},
                    "modes": {}, "cache": {},
                }
            agg["count"] += sd.get("count", 0)
            for b, c in (sd.get("buckets") or {}).items():
                agg["buckets"][b] = agg["buckets"].get(b, 0) + c
            for stage, ent in (sd.get("stages") or {}).items():
                tgt = agg["stages"].setdefault(stage, {"total_us": 0.0, "count": 0})
                tgt["total_us"] = round(tgt["total_us"] + ent.get("total_us", 0.0), 1)
                tgt["count"] += ent.get("count", 0)
            for k in ("modes", "cache"):
                for mk, mv in (sd.get(k) or {}).items():
                    agg[k][mk] = round(agg[k].get(mk, 0) + mv, 3) \
                        if isinstance(mv, float) else agg[k].get(mk, 0) + mv
    for agg in shapes.values():
        h = Histogram()
        h.merge(agg["buckets"])
        for name, q in (("p50_us", 0.50), ("p99_us", 0.99), ("p999_us", 0.999)):
            p = h.percentile(q)
            if p is not None:
                agg[name] = round(p, 1)
        for ent in agg["stages"].values():
            if ent["count"]:
                ent["mean_us"] = round(ent["total_us"] / ent["count"], 1)
    return {"nodes": len(reports), "shapes": shapes}


def prom(report: dict, prefix: str = "sqlcached") -> str:
    """Prometheus-style text exposition of a ``Telemetry.report`` dict.

    Buckets are emitted cumulatively with ``le`` upper bounds, matching
    the Prometheus histogram convention; shape and stage become labels.
    """
    lines = [
        f"# HELP {prefix}_uptime_seconds daemon uptime",
        f"# TYPE {prefix}_uptime_seconds gauge",
        f"{prefix}_uptime_seconds {report.get('uptime_s', 0)}",
        f"# TYPE {prefix}_statement_latency_us histogram",
    ]
    for name, sd in sorted((report.get("shapes") or {}).items()):
        lab = f'shape="{name}"'
        buckets = {int(k): v for k, v in (sd.get("buckets") or {}).items()}
        cum = 0
        for i in sorted(buckets):
            cum += buckets[i]
            le = 1 << (i + 1)
            lines.append(
                f'{prefix}_statement_latency_us_bucket{{{lab},le="{le}"}} {cum}')
        lines.append(
            f'{prefix}_statement_latency_us_bucket{{{lab},le="+Inf"}} '
            f'{sd.get("count", 0)}')
        lines.append(f'{prefix}_statement_latency_us_count{{{lab}}} '
                     f'{sd.get("count", 0)}')
        for stage, ent in sorted((sd.get("stages") or {}).items()):
            lines.append(
                f'{prefix}_stage_us_total{{{lab},stage="{stage}"}} '
                f'{ent.get("total_us", 0)}')
        for mode, n in sorted((sd.get("modes") or {}).items()):
            lines.append(f'{prefix}_exec_mode_total{{{lab},mode="{mode}"}} {n}')
    return "\n".join(lines) + "\n"
