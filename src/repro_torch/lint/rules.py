"""reprolint rules REP001-REP006 of the port.

Each rule is a class with an ``ID``, a one-line ``TITLE`` and a
``check(ctx) -> list[Finding]`` method over one
:class:`~repro_torch.lint.engine.ModuleContext`. Project knowledge (which
modules/functions are the serving path, which attributes hold device
state, which bodies a graph captures, ...) comes from ``config.py`` — the
analyses here are generic. The IDs, titles and intent are the reference's
(``repro.lint.rules``); REP002, REP003 and REP005 are its analyses as they
are (they know no framework), REP001 and REP004 read torch's and CUDA
graphs' terms, and REP006 guards the port's counterpart of a donated
buffer: a CUDA graph's own output buffer read after the entry ran again.

Shared machinery:

``_chain``
    Dotted-name text of a Name/Attribute expression (``"t.state"``,
    ``"torch.cuda.synchronize"``), or None for anything more complex.

``_FuncIndex``
    Maps every (async) function def to its enclosing-def stack so rules
    can ask "is this node inside a serving function?" — nested defs
    (executor bodies, closures) inherit the serving property of their
    enclosing function.

``_taint``
    Flow-insensitive device-taint fixpoint over one function: a local
    name is tainted when it is ever assigned from a ``torch.`` call (minus
    the host-returning allowlist) or from an expression reaching a
    device-state attribute (``.state``, ``.lanes``, ``._dev`` ...).
    Over-approximate on purpose: a false positive costs one pragma with a
    written reason; a false negative costs a silent device sync on the
    serving path.
"""
from __future__ import annotations

import ast

from repro_torch.lint import config as C
from repro_torch.lint.engine import Finding, ModuleContext

__all__ = ["ALL_RULES", "RULE_DOCS"]

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _chain(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_chain(call: ast.Call) -> str | None:
    return _chain(call.func)


class _FuncIndex:
    """Enclosing-function stacks for every node in a module."""

    def __init__(self, tree: ast.Module):
        self.parents: dict[ast.AST, list] = {}   # funcdef -> enclosing defs
        self.defs_by_name: dict[str, list] = {}

        def walk(node: ast.AST, stack: list) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_NODES):
                    self.parents[child] = list(stack)
                    self.defs_by_name.setdefault(child.name, []).append(child)
                    walk(child, stack + [child])
                else:
                    walk(child, stack)

        walk(tree, [])

    def funcs(self):
        return self.parents.keys()

    def outermost_name(self, fn) -> str:
        stack = self.parents.get(fn, [])
        return (stack[0] if stack else fn).name

    def is_serving(self, fn, serving_names: frozenset) -> bool:
        """A def is serving when itself OR any enclosing def is named in
        the serving set (nested executor bodies inherit)."""
        if fn.name in serving_names:
            return True
        return any(p.name in serving_names for p in self.parents.get(fn, []))


def _direct_body_nodes(fn) -> list[ast.AST]:
    """Every AST node lexically in ``fn`` but not in a nested def."""
    out: list[ast.AST] = []
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                continue
            stack.append(child)
    return out


# ---------------------------------------------------------------------------
# device taint

def _is_device_call(chain: str) -> bool:
    return (chain.split(".", 1)[0] == "torch"
            and chain not in C.HOST_TORCH_CALLS)


def _taint(fn):
    """(tainted-name set, expression classifier) for ``fn`` — a
    fixpoint over its assignments, nested defs included (closures share
    the namespace approximation)."""
    assigns: list[tuple[list[str], ast.AST]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            names = []
            for t in node.targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        names.append(sub.id)
            assigns.append((names, node.value))
        elif isinstance(node, ast.AugAssign) and isinstance(node.target,
                                                            ast.Name):
            assigns.append(([node.target.id], node.value))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            names = [s.id for s in ast.walk(node.target)
                     if isinstance(s, ast.Name)]
            assigns.append((names, node.iter))
        elif isinstance(node, ast.withitem) and node.optional_vars:
            names = [s.id for s in ast.walk(node.optional_vars)
                     if isinstance(s, ast.Name)]
            assigns.append((names, node.context_expr))

    tainted: set[str] = set()

    def expr_tainted(e: ast.AST) -> bool:
        if isinstance(e, ast.Call):
            ch = _call_chain(e)
            if ch is not None and _is_device_call(ch):
                return True
            # a call ON a tainted value (x.sum(), x.to(torch.int64))
            if isinstance(e.func, ast.Attribute) and \
                    expr_tainted(e.func.value):
                return True
            return any(expr_tainted(a) for a in e.args)
        if isinstance(e, ast.Attribute):
            if e.attr in C.DEVICE_ATTRS:
                return True
            return expr_tainted(e.value)
        if isinstance(e, ast.Name):
            return e.id in tainted
        if isinstance(e, ast.Subscript):
            return expr_tainted(e.value)
        if isinstance(e, (ast.BinOp,)):
            return expr_tainted(e.left) or expr_tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return expr_tainted(e.operand)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(expr_tainted(x) for x in e.elts)
        if isinstance(e, ast.Starred):
            return expr_tainted(e.value)
        if isinstance(e, ast.IfExp):
            return expr_tainted(e.body) or expr_tainted(e.orelse)
        if isinstance(e, ast.NamedExpr):
            return expr_tainted(e.value)
        return False

    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if not names or all(n in tainted for n in names):
                continue
            if expr_tainted(value):
                for n in names:
                    if n not in tainted:
                        tainted.add(n)
                        changed = True
    # stash the evaluator so rules can classify arbitrary expressions
    # against this function's final taint set
    return tainted, expr_tainted  # type: ignore[return-value]


# ---------------------------------------------------------------------------


class Rule:
    ID = "REP000"
    TITLE = ""

    def check(self, ctx: ModuleContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


class DeviceSyncOnServingPath(Rule):
    """REP001: a device sync (``.synchronize()``, ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
    ``int()/float()/bool()/np.asarray`` over a device value) inside a
    serving function of a serving module. The engine's whole latency story
    rests on the serving path never blocking on the device; the one
    sanctioned sync is lazy ``Result`` materialization at render time."""

    ID = "REP001"
    TITLE = "device sync on the serving path"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if ctx.module_key not in C.SERVING_MODULES:
            return []
        serving = C.SERVING_FUNCS.get(ctx.module_key, frozenset())
        idx = _FuncIndex(ctx.tree)
        out: list[Finding] = []
        seen: set[int] = set()
        for fn in idx.funcs():
            if not idx.is_serving(fn, serving):
                continue
            tainted, expr_tainted = _taint(fn)  # type: ignore[misc]
            for node in _direct_body_nodes(fn):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                hit = self._classify(node, expr_tainted)
                if hit:
                    seen.add(id(node))
                    out.append(ctx.make_finding(
                        self.ID, node,
                        f"{hit} in serving function {fn.name!r} "
                        f"(zero-device-sync contract; move it off the "
                        f"serving path or pragma with a reason)"))
        return out

    @staticmethod
    def _to_host(call: ast.Call) -> bool:
        """``x.to("cpu")`` / ``x.to(device="cpu")`` /
        ``x.to(torch.device("cpu"))``."""
        args = list(call.args[:1]) + [k.value for k in call.keywords
                                       if k.arg == "device"]
        for a in args:
            if isinstance(a, ast.Call) and _call_chain(a) == "torch.device":
                a = a.args[0] if a.args else None
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and a.value.split(":")[0] in C.HOST_DEVICE_NAMES:
                return True
        return False

    @classmethod
    def _classify(cls, call: ast.Call, expr_tainted) -> str | None:
        ch = _call_chain(call)
        if ch in C.SYNC_CALL_ALWAYS:
            return f"blocking device call {ch}()"
        if isinstance(call.func, ast.Attribute):
            meth = call.func.attr
            if meth in C.SYNC_METHOD_ALWAYS:
                return f".{meth}() device sync"
            if meth in C.SYNC_METHOD_TAINTED and \
                    expr_tainted(call.func.value):
                return f".{meth}() on a device value"
            if meth == "to" and cls._to_host(call) and \
                    expr_tainted(call.func.value):
                return ".to('cpu') of a device value"
        if ch in C.SYNC_FN_TAINTED and call.args and \
                expr_tainted(call.args[0]):
            return f"{ch}() applied to a device value"
        return None


_AUG_OPS = {"Add": "+", "Sub": "-", "Mult": "*", "Div": "/",
            "FloorDiv": "//", "Mod": "%", "BitOr": "|", "BitAnd": "&",
            "BitXor": "^", "LShift": "<<", "RShift": ">>", "Pow": "**"}


class BareSharedCounter(Rule):
    """REP002: read-modify-write on a shared counter map
    (``stats[k] += 1``) outside ``telemetry.Counters``. Concurrent
    scheduler waves and render threads lose increments through plain
    ``+=``; every shared counter goes through ``Counters.add``."""

    ID = "REP002"
    TITLE = "bare shared-counter mutation (use telemetry.Counters)"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if (not ctx.module_key.startswith(C.COUNTER_MODULES_PREFIX)
                or ctx.module_key in C.COUNTER_MODULES_EXEMPT):
            return []
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AugAssign):
                tgt = node.target
                if isinstance(tgt, ast.Subscript) and \
                        self._counter_base(tgt.value):
                    op = _AUG_OPS.get(type(node.op).__name__,
                                      type(node.op).__name__)
                    out.append(ctx.make_finding(
                        self.ID, node,
                        f"bare '{self._counter_base(tgt.value)}[...] "
                        f"{op}=' is a lossy "
                        f"read-modify-write under concurrent dispatch; "
                        f"use telemetry.Counters.add"))
            elif isinstance(node, ast.Assign):
                # stats[k] = stats.get(k, 0) + 1  (same race, spelled out)
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Subscript)
                            and self._counter_base(tgt.value)):
                        continue
                    base = self._counter_base(tgt.value)
                    reads_self = any(
                        self._counter_base(sub) == base
                        or (isinstance(sub, ast.Attribute)
                            and sub.attr == "get"
                            and self._counter_base(sub.value) == base)
                        for sub in ast.walk(node.value))
                    if reads_self:
                        out.append(ctx.make_finding(
                            self.ID, node,
                            f"read-modify-write of shared counter map "
                            f"{base!r}; use telemetry.Counters.add"))
        return out

    @staticmethod
    def _counter_base(expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Name) and C.COUNTER_NAME_RE.search(expr.id):
            return expr.id
        if isinstance(expr, ast.Attribute) and \
                C.COUNTER_NAME_RE.search(expr.attr):
            return _chain(expr) or expr.attr
        return None


class UnorderedLockAcquisition(Rule):
    """REP003: lock construction/acquisition that bypasses the
    scheduler's ordered-acquisition discipline — the lane-lock deadlock
    class. Three shapes:

    * constructing ``asyncio.Lock``/``threading.Lock`` inside
      ``core/scheduler.py`` anywhere but the ``_locks_for`` helper
      (lane/base locks must come from the one place that orders them);
    * acquiring two locks with nested ``with`` blocks in one function;
    * looping/multiple ``.acquire()`` calls in one function —
      multi-lock acquisition belongs in the allowlisted consumer of the
      ordered helper (``_dispatch_one``)."""

    ID = "REP003"
    TITLE = "lock acquisition outside the ordered-acquisition helper"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if not ctx.module_key.startswith(C.LOCK_MODULES_PREFIX):
            return []
        idx = _FuncIndex(ctx.tree)
        out: list[Finding] = []
        is_sched = ctx.module_key == "core/scheduler.py"
        for fn in idx.funcs():
            exempt = (ctx.module_key, idx.outermost_name(fn)) \
                in C.MULTI_ACQUIRE_ALLOWED or fn.name in C.LOCK_HELPER_FUNCS
            body = _direct_body_nodes(fn)
            if is_sched and fn.name not in C.LOCK_HELPER_FUNCS:
                for node in body:
                    if isinstance(node, ast.Call) and _call_chain(node) in (
                            "asyncio.Lock", "threading.Lock",
                            "threading.RLock"):
                        out.append(ctx.make_finding(
                            self.ID, node,
                            f"scheduler locks must be created by the "
                            f"ordered helper _locks_for, not inline in "
                            f"{fn.name!r}"))
            if exempt:
                continue
            out.extend(self._nested_withs(ctx, fn))
            # any .acquire() counts — the lock API is distinctive, and
            # loop variables ("for lk in locks") defeat name matching
            acquires = [n for n in body
                        if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "acquire"]
            if len(acquires) >= 2 or any(
                    self._in_loop(fn, a) for a in acquires):
                for a in acquires:
                    out.append(ctx.make_finding(
                        self.ID, a,
                        f"multiple/looped direct .acquire() in "
                        f"{fn.name!r}: acquire ordered lock sets via the "
                        f"scheduler's _locks_for/_dispatch_one helpers"))
        return out

    @staticmethod
    def _lockish(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return bool(C.LOCK_NAME_RE.search(expr.id))
        if isinstance(expr, ast.Attribute):
            return bool(C.LOCK_NAME_RE.search(expr.attr))
        if isinstance(expr, ast.Subscript):
            return UnorderedLockAcquisition._lockish(expr.value)
        return False

    def _nested_withs(self, ctx: ModuleContext, fn) -> list[Finding]:
        out: list[Finding] = []

        def walk(node: ast.AST, held: int) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_NODES):
                    continue
                h = held
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    n_locks = sum(
                        1 for item in child.items
                        if self._lockish(item.context_expr))
                    if n_locks and held:
                        out.append(ctx.make_finding(
                            self.ID, child,
                            f"nested lock acquisition in {fn.name!r} "
                            f"(holding {held} lock(s) already): order "
                            f"through the scheduler's helper or flatten "
                            f"to one lock"))
                    h = held + n_locks
                walk(child, h)

        walk(ast.Module(body=fn.body, type_ignores=[]), 0)
        return out

    @staticmethod
    def _in_loop(fn, node: ast.AST) -> bool:
        target_line = node.lineno

        def contains(loop) -> bool:
            return any(getattr(n, "lineno", -1) == target_line
                       and isinstance(n, ast.Call)
                       for n in ast.walk(loop))

        for sub in ast.walk(fn):
            if isinstance(sub, (ast.For, ast.AsyncFor, ast.While)) \
                    and contains(sub):
                return True
        return False


class HostClockInJit(Rule):
    """REP004: host clock/randomness called inside a body that a CUDA
    graph captures (or ``torch.compile`` compiles). Such a call runs once,
    while the graph is recorded, and its value is baked into the graph —
    every replay then serves a stale timestamp / the same "random" number.
    Captured: the code between ``capture_begin()`` and ``capture_end()``,
    the block of ``with torch.cuda.graph(...)``, a function handed to (or
    decorated with) ``torch.cuda.make_graphed_callables`` /
    ``torch.compile``, and the config-declared bodies a capture runs by
    reference (``_Plan._body``, ``ServeGraph._body``)."""

    ID = "REP004"
    TITLE = "host clock/random captured inside a CUDA graph / compiled body"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        idx = _FuncIndex(ctx.tree)
        compiled: set = set()
        regions: list[list[ast.AST]] = []
        for fn in idx.funcs():
            # (a) decorated defs
            if any(self._wrapperish(dec) for dec in fn.decorator_list):
                compiled.add(fn)
            # (b) config-declared captured bodies
            if (ctx.module_key, fn.name) in C.CAPTURED_BODIES:
                compiled.add(fn)
            # (c) capture_begin() ... capture_end() in one function
            regions.append(self._between(fn))
        for node in ast.walk(ctx.tree):
            # (d) defs / lambdas handed to a capturing or compiling call
            if isinstance(node, ast.Call) and \
                    _call_chain(node) in C.CAPTURE_WRAPPER_CHAINS:
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Name):
                        compiled.update(idx.defs_by_name.get(arg.id, ()))
                    elif isinstance(arg, ast.Lambda):
                        compiled.add(arg)
            # (e) with torch.cuda.graph(...): the block
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and _call_chain(it.context_expr)
                    in C.CAPTURE_CONTEXT_CHAINS for it in node.items):
                regions.append([n for stmt in node.body
                                for n in ast.walk(stmt)])
        nodes: dict[int, ast.AST] = {}
        for fn in compiled:
            nodes.update((id(n), n) for n in ast.walk(fn))
        for region in regions:
            nodes.update((id(n), n) for n in region)
        out: list[Finding] = []
        for node in sorted(nodes.values(),
                           key=lambda n: (getattr(n, "lineno", 0),
                                          getattr(n, "col_offset", 0))):
            if isinstance(node, ast.Call):
                ch = _call_chain(node)
                if ch is not None and self._nondet(ch):
                    out.append(ctx.make_finding(
                        self.ID, node,
                        f"{ch}() inside a captured body runs once, at "
                        f"CAPTURE time (its value is baked into the "
                        f"graph); stage the value in as an input "
                        f"instead"))
        return out

    @staticmethod
    def _between(fn) -> list[ast.AST]:
        """The nodes of ``fn`` (not of nested defs) on the lines after a
        ``.capture_begin()`` call and before the next ``.capture_end()``
        (line-granular, as REP006's scan)."""
        body = _direct_body_nodes(fn)
        marks = sorted(
            (n.lineno, n.func.attr) for n in body
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in (C.CAPTURE_BEGIN, C.CAPTURE_END))
        spans, begin = [], None
        for line, what in marks:
            if what == C.CAPTURE_BEGIN and begin is None:
                begin = line
            elif what == C.CAPTURE_END and begin is not None:
                spans.append((begin, line))
                begin = None
        if begin is not None:   # never ended in this function
            spans.append((begin, 1 << 30))
        return [n for n in body
                if any(a < getattr(n, "lineno", -1) < b for a, b in spans)]

    @staticmethod
    def _wrapperish(dec: ast.AST) -> bool:
        for sub in ast.walk(dec):
            ch = _chain(sub) if isinstance(
                sub, (ast.Name, ast.Attribute)) else None
            if ch in C.CAPTURE_WRAPPER_CHAINS:
                return True
        return False

    @staticmethod
    def _nondet(chain: str) -> bool:
        return any(chain == c.rstrip(".") or chain.startswith(c)
                   for c in C.HOST_NONDET_CHAINS)


class ServingPathPrint(Rule):
    """REP005: leftover ``print`` (or a debug-print chain) in a serving
    module or a kernel wrapper. Debug prints on the serving path cost real
    latency and pollute the wire logs; telemetry spans/counters are the
    sanctioned channel."""

    ID = "REP005"
    TITLE = "print/debug.print on the serving path"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if ctx.module_key not in C.PRINT_MODULES:
            return []
        idx = _FuncIndex(ctx.tree)
        # map call nodes to their enclosing def for the allowlist
        out: list[Finding] = []
        for fn in list(idx.funcs()) + [ctx.tree]:
            if fn is not ctx.tree and (
                    fn.name in C.PRINT_ALLOWED_FUNCS
                    or idx.outermost_name(fn) in C.PRINT_ALLOWED_FUNCS):
                continue
            nodes = _direct_body_nodes(fn) if fn is not ctx.tree else \
                self._module_level(ctx.tree)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                ch = _call_chain(node)
                if ch == "print" or ch in C.PRINT_CHAINS:
                    out.append(ctx.make_finding(
                        self.ID, node,
                        f"{ch}() left on the serving path; use "
                        f"telemetry spans/counters (or guard under a "
                        f"main/repl entry point)"))
        return out

    @staticmethod
    def _module_level(tree: ast.Module) -> list[ast.AST]:
        out: list[ast.AST] = []
        stack: list[ast.AST] = []
        for node in tree.body:
            # skip `if __name__ == "__main__":` blocks entirely, and
            # defs (they are scanned as functions, not module level)
            if isinstance(node, _FUNC_NODES):
                continue
            if isinstance(node, ast.If) and "__name__" in ast.dump(node.test):
                continue
            stack.append(node)
        while stack:
            node = stack.pop()
            out.append(node)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_NODES):
                    continue
                stack.append(child)
        return out


class UseAfterDonation(Rule):
    """REP006: reading a CUDA graph's raw output buffer after its entry
    ran again (the port's counterpart of the reference's use after
    donation: the port donates nothing). ``ExecEntry.call_locked(...,
    raw=True)`` / ``_Plan.run(..., raw=True)`` return the packed outputs
    uncopied — on the card the graph's own static buffer, which the next
    replay of the same entry overwrites, so a later read returns the newer
    call's bytes, but only on the card, which is what makes the class
    vicious. Detected: a name bound to a raw call (or a comprehension of
    them), then another call of the same entry object (``call_locked``,
    ``run`` or the entry itself), then a read of the name; and the
    config-declared sites (``RAW_SITES``: ``call_locked``'s ``plan.run``,
    which takes its ``raw`` flag by position)."""

    ID = "REP006"
    TITLE = "use of a graph's raw output after its entry ran again"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        idx = _FuncIndex(ctx.tree)
        out: list[Finding] = []
        for fn in idx.funcs():
            sites = C.RAW_SITES.get((ctx.module_key, fn.name), frozenset())
            body = _direct_body_nodes(fn)
            for node in body:
                if not isinstance(node, ast.Assign):
                    continue
                entry = self._raw_entry(node.value, sites)
                if entry is None:
                    continue
                names = [s.id for t in node.targets for s in ast.walk(t)
                         if isinstance(s, ast.Name)]
                again = [n.lineno for n in body if isinstance(n, ast.Call)
                         and n.lineno > node.lineno
                         and self._calls_entry(n, entry)]
                if not again:
                    continue
                for name in names:
                    out.extend(self._reads_after(ctx, body, name,
                                                 node.lineno, min(again),
                                                 entry))
        return out

    @staticmethod
    def _raw_entry(value: ast.AST, sites) -> str | None:
        """The entry chain of a raw call (or of the call a list / generator
        comprehension makes), else None."""
        if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
            value = value.elt
        if not isinstance(value, ast.Call) or \
                not isinstance(value.func, ast.Attribute):
            return None
        ch = _call_chain(value)
        meth = value.func.attr
        raw = ch in sites
        kw = C.RAW_CALLS.get(meth)
        if kw is not None:
            raw = raw or any(
                k.arg == kw and isinstance(k.value, ast.Constant)
                and k.value.value is True for k in value.keywords)
        return _chain(value.func.value) if raw else None

    @staticmethod
    def _calls_entry(call: ast.Call, entry: str) -> bool:
        if _call_chain(call) == entry:      # the entry called itself
            return True
        return (isinstance(call.func, ast.Attribute)
                and (call.func.attr in C.RAW_CALLS
                     or call.func.attr == "__call__")
                and _chain(call.func.value) == entry)

    def _reads_after(self, ctx: ModuleContext, body, name: str, bound: int,
                     again: int, entry: str) -> list[Finding]:
        """Loads of ``name`` on lines after ``again`` (the entry's next
        call), unless a store to it comes first (line-granular forward
        scan, as the reference's)."""
        events = sorted(
            (n.lineno, isinstance(n.ctx, ast.Store), n) for n in body
            if isinstance(n, ast.Name) and n.id == name
            and n.lineno > bound)
        out: list[Finding] = []
        for line, store, node in events:
            if store:
                break
            if line <= again:
                continue
            out.append(ctx.make_finding(
                self.ID, node,
                f"{name!r} holds {entry}'s raw graph output (line "
                f"{bound}), read after {entry} ran again at line {again}; "
                f"the replay overwrote it: copy it before the next call"))
        return out


ALL_RULES = (DeviceSyncOnServingPath, BareSharedCounter,
             UnorderedLockAcquisition, HostClockInJit, ServingPathPrint,
             UseAfterDonation)

RULE_DOCS = {r.ID: (r.TITLE, (r.__doc__ or "").strip()) for r in ALL_RULES}
