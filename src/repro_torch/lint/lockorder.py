"""Port copy of ``repro.lint.lockorder`` (host Python, no tensor code): the
port's daemon, scheduler and telemetry build their locks through it.

Runtime lock-order sanitizer (the dynamic half of reprolint).

The static rule REP003 keeps *new* lock acquisitions on the blessed
paths (the scheduler's ``_locks_for`` ordered helper, single leaf
locks); this module checks the property those paths are supposed to
guarantee — **one global acquisition order, no cycles** — on a live
daemon under real concurrency.

Armed with ``REPRO_LOCKCHECK=1``, every lock the daemon/scheduler
creates through :func:`make_lock` / :func:`make_async_lock` becomes an
instrumented proxy. Each acquisition records, for the acquiring holder
(thread, or asyncio task for the scheduler's lane locks), an edge from
every lock it already holds to the one it just took. The edges form the
observed acquisition-order graph; a cycle in that graph is a potential
deadlock (two holders that ever interleave those acquisitions can
block each other forever), reported even if the run itself never
deadlocked — that is the whole point: the chaos suite can pass by luck,
the order graph cannot.

Unarmed (the default), :func:`make_lock` returns a plain
``threading.Lock`` and the serving path pays nothing.

Teardown reporting: the first armed lock installs an ``atexit`` hook
that prints the cycle report to stderr; ``tests/conftest.py``
additionally fails the pytest session if any cycle was observed while
armed, and ``SHOW STATS`` (daemon-wide roll-up) carries a ``lockcheck``
field with the armed bit + live edge/cycle counts so chaos runs are
auditable from the wire.

Naming: lock names are stable identities (``table:<name>``,
``sched:<table>:lane<i>``, ``telemetry.fold``, ...). Two *instances*
sharing one name merge into one graph node; acquiring a name while
already holding the same name is therefore NOT recorded as an edge
(leaf-lock classes like ``telemetry.counters`` have many instances and
never nest with themselves).
"""
from __future__ import annotations

import asyncio
import atexit
import os
import sys
import threading

__all__ = [
    "Graph",
    "LockProxy",
    "AsyncLockProxy",
    "armed",
    "cycles",
    "global_graph",
    "make_lock",
    "make_async_lock",
    "report",
    "reset",
    "summary",
]


def armed() -> bool:
    """True when the sanitizer is switched on (``REPRO_LOCKCHECK=1``)."""
    return os.environ.get("REPRO_LOCKCHECK", "0") == "1"


class Graph:
    """Observed lock-acquisition-order graph.

    Thread-safe; one global instance backs the armed daemon, tests may
    build private instances and bind proxies to them explicitly.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # holder key -> list of lock names currently held (acquisition order)
        self._held: dict[tuple, list[str]] = {}
        # src name -> {dst name -> times observed}
        self.edges: dict[str, dict[str, int]] = {}
        self.names: set[str] = set()
        self.acquisitions = 0

    # -- proxy callbacks -------------------------------------------------
    def on_acquire(self, key: tuple, name: str) -> None:
        with self._lock:
            self.acquisitions += 1
            self.names.add(name)
            held = self._held.setdefault(key, [])
            for h in held:
                if h != name:  # same-name reentrancy/instances: no edge
                    dsts = self.edges.setdefault(h, {})
                    dsts[name] = dsts.get(name, 0) + 1
            held.append(name)

    def on_release(self, key: tuple, name: str) -> None:
        with self._lock:
            held = self._held.get(key)
            if held is None:
                return
            # remove the most recent acquisition of this name (release
            # order need not be LIFO)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break
            if not held:
                del self._held[key]

    # -- analysis --------------------------------------------------------
    def n_edges(self) -> int:
        with self._lock:
            return sum(len(d) for d in self.edges.values())

    def cycles(self) -> list[list[str]]:
        """Cycles in the observed order graph (each as a node list, the
        smallest member first). Tarjan SCC: every SCC with more than one
        node — or a self-edge — is a potential-deadlock cycle."""
        with self._lock:
            edges = {s: dict(d) for s, d in self.edges.items()}
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        out: list[list[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            # iterative Tarjan (the graph is tiny, but recursion depth
            # must not depend on lock count)
            work = [(v, iter(edges.get(v, ())))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(edges.get(w, ()))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1 or node in edges.get(node, ()):
                        out.append(sorted(scc))

        for v in list(edges):
            if v not in index:
                strongconnect(v)
        return sorted(out)

    def report(self) -> dict:
        cyc = self.cycles()
        return {
            "armed": armed(),
            "locks": len(self.names),
            "edges": self.n_edges(),
            "acquisitions": self.acquisitions,
            "cycles": cyc,
        }

    def reset(self) -> None:
        with self._lock:
            self._held.clear()
            self.edges.clear()
            self.names.clear()
            self.acquisitions = 0


_GLOBAL = Graph()


def global_graph() -> Graph:
    return _GLOBAL


def _thread_key() -> tuple:
    return ("t", threading.get_ident())


def _task_key() -> tuple:
    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    if task is not None:
        return ("a", id(task))
    return _thread_key()


class LockProxy:
    """``threading.Lock`` wrapper recording acquisition order per thread."""

    __slots__ = ("_lk", "name", "_graph")

    def __init__(self, name: str, graph: Graph | None = None,
                 lock=None):
        self._lk = lock if lock is not None else threading.Lock()
        self.name = name
        self._graph = graph if graph is not None else _GLOBAL

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._graph.on_acquire(_thread_key(), self.name)
        return ok

    def release(self) -> None:
        self._graph.on_release(_thread_key(), self.name)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"LockProxy({self.name!r})"


class AsyncLockProxy:
    """``asyncio.Lock`` wrapper recording acquisition order per task.

    Only the surface the scheduler uses (``await acquire()`` /
    ``release()`` / ``locked()``) plus ``async with``.
    """

    __slots__ = ("_lk", "name", "_graph")

    def __init__(self, name: str, graph: Graph | None = None):
        self._lk = asyncio.Lock()
        self.name = name
        self._graph = graph if graph is not None else _GLOBAL

    async def acquire(self) -> bool:
        ok = await self._lk.acquire()
        self._graph.on_acquire(_task_key(), self.name)
        return ok

    def release(self) -> None:
        self._graph.on_release(_task_key(), self.name)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    async def __aenter__(self) -> "AsyncLockProxy":
        await self.acquire()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"AsyncLockProxy({self.name!r})"


# ---------------------------------------------------------------------------
# Factories the daemon/scheduler call at lock-construction sites. Unarmed
# they return the plain primitive — zero serving-path overhead.

_ATEXIT_INSTALLED = False


def _install_atexit() -> None:
    global _ATEXIT_INSTALLED
    if _ATEXIT_INSTALLED:
        return
    _ATEXIT_INSTALLED = True

    def _report_at_exit() -> None:
        cyc = _GLOBAL.cycles()
        if cyc:
            print(f"[reprolint.lockorder] LOCK-ORDER CYCLE(S) observed: "
                  f"{cyc} (edges={_GLOBAL.n_edges()}, "
                  f"acquisitions={_GLOBAL.acquisitions})", file=sys.stderr)

    atexit.register(_report_at_exit)


def make_lock(name: str):
    """A named ``threading.Lock`` — instrumented when armed."""
    if armed():
        _install_atexit()
        return LockProxy(name)
    return threading.Lock()


def make_async_lock(name: str):
    """A named ``asyncio.Lock`` — instrumented when armed."""
    if armed():
        _install_atexit()
        return AsyncLockProxy(name)
    return asyncio.Lock()


# -- module-level conveniences over the global graph ------------------------

def cycles() -> list[list[str]]:
    return _GLOBAL.cycles()


def report() -> dict:
    return _GLOBAL.report()


def summary() -> dict:
    """The compact ``lockcheck`` block SHOW STATS reports."""
    return {"armed": armed(), "edges": _GLOBAL.n_edges(),
            "cycles": len(_GLOBAL.cycles())}


def reset() -> None:
    _GLOBAL.reset()
