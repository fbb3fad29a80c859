"""Predicate / expression AST and its vectorized PyTorch evaluator (port
of ``repro.core.predicate``: the same AST classes and plan helpers).

This is the query-execution core of the cache: a ``WHERE`` clause is parsed
once into this AST and *compiled once* into a jitted masked-scan over the
table's columns (the TPU-native replacement for SQLite's B-tree walks —
see DESIGN.md §2). ``Param`` nodes (`?` placeholders) keep the compiled
executor reusable across calls, mirroring SQLcached's prepared-statement
cache with jit's compilation cache.

Evaluation contract: ``eval_expr(node, cols, params) -> array[capacity]``
broadcast over rows; predicates return bool masks. The caller ANDs the
mask with the table's validity bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


class Node:
    """Base AST node."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Col(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class Const(Node):
    value: Any  # python scalar (str consts are interned before eval)


@dataclasses.dataclass(frozen=True)
class Param(Node):
    index: int  # position of the `?` in the statement


@dataclasses.dataclass(frozen=True)
class BinOp(Node):
    op: str  # = != < <= > >= + - * / %
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class And(Node):
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class Or(Node):
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class Not(Node):
    child: Node


@dataclasses.dataclass(frozen=True)
class Between(Node):
    expr: Node
    low: Node
    high: Node


@dataclasses.dataclass(frozen=True)
class InList(Node):
    expr: Node
    items: tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Func(Node):
    """Scalar function call: ABS, MIN, MAX (2-arg scalar forms), UPPER is
    host-side only (text) and rejected at compile time on device."""

    name: str
    args: tuple[Node, ...]


_CMP = {
    "=": lambda a, b: a == b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
}

def _minimum(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.where(a <= b, a, b)
    return min(a, b)


def _maximum(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.where(a >= b, a, b)
    return max(a, b)


_FUNCS = {
    "ABS": lambda args: abs(args[0]),
    "MIN2": lambda args: _minimum(args[0], args[1]),
    "MAX2": lambda args: _maximum(args[0], args[1]),
}


def eval_expr(node: Node, cols: dict, params: Sequence[Any]):
    """Evaluate an expression AST over column tensors. Returns a tensor
    broadcastable to [capacity] (or a Python scalar for const-only
    expressions). ``params`` hold Python scalars or tensors; the caller
    shapes them: 0-d for one statement, [w, 1] for w statements at once
    (every result then broadcasts to [w, capacity])."""
    if isinstance(node, Col):
        if node.name not in cols:
            raise KeyError(f"unknown column {node.name!r}")
        return cols[node.name]
    if isinstance(node, Const):
        return node.value
    if isinstance(node, Param):
        return params[node.index]
    if isinstance(node, BinOp):
        a = eval_expr(node.left, cols, params)
        b = eval_expr(node.right, cols, params)
        if node.op in _CMP:
            return _CMP[node.op](a, b)
        if node.op in _ARITH:
            return _ARITH[node.op](a, b)
        raise ValueError(f"unknown operator {node.op!r}")
    if isinstance(node, And):
        return eval_expr(node.left, cols, params) & eval_expr(node.right, cols, params)
    if isinstance(node, Or):
        return eval_expr(node.left, cols, params) | eval_expr(node.right, cols, params)
    if isinstance(node, Not):
        x = eval_expr(node.child, cols, params)
        return (not x) if isinstance(x, bool) else ~x
    if isinstance(node, Between):
        x = eval_expr(node.expr, cols, params)
        lo = eval_expr(node.low, cols, params)
        hi = eval_expr(node.high, cols, params)
        return (x >= lo) & (x <= hi)
    if isinstance(node, InList):
        x = eval_expr(node.expr, cols, params)
        mask = None
        for item in node.items:
            m = x == eval_expr(item, cols, params)
            mask = m if mask is None else (mask | m)
        if mask is None:  # IN () is false
            return (torch.zeros_like(x, dtype=torch.bool)
                    if isinstance(x, torch.Tensor) else False)
        return mask
    if isinstance(node, Func):
        fname = node.name.upper()
        if fname in ("MIN", "MAX") and len(node.args) == 2:
            fname += "2"
        if fname not in _FUNCS:
            raise ValueError(f"function {node.name!r} not supported on device")
        return _FUNCS[fname]([eval_expr(a, cols, params) for a in node.args])
    raise TypeError(f"unknown AST node {node!r}")


def eval_predicate(node: Node | None, cols: dict, params: Sequence[Any],
                   capacity: int, lead: tuple = ()):
    """Evaluate a WHERE clause to a bool mask of shape ``lead +
    (capacity,)`` (None = all rows). ``lead`` is ``(w,)`` when the params
    are [w, 1] tensors of w statements."""
    device = next(iter(cols.values())).device
    shape = tuple(lead) + (capacity,)
    if node is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    mask = eval_expr(node, cols, params)
    if not isinstance(mask, torch.Tensor):  # a const-only WHERE: no upload
        mask = torch.full((), mask, device=device)
    if mask.dtype != torch.bool:
        mask = mask != 0
    return torch.broadcast_to(mask, shape)


# ------------------------------------------------------- fusable WHERE plans
#
# The daemon's hot predicates are conjunctions of equality/range terms over
# integer metadata columns (``seq_id = ?``, ``slot = ? AND pos_block = ?``,
# ``ts BETWEEN ? AND ?``). These lower to the fused relscan kernel
# (kernels/relscan.py) instead of the generic masked scan: one pass over
# the table evaluates every term, the validity bitmap, per-tile counts, and
# the compaction to row ids. ``classify_fusable`` recognizes that shape;
# anything else falls back to :func:`eval_predicate`.

FUSABLE_OPS = ("==", "!=", "<", "<=", ">", ">=")

_OP_NORM = {"=": "==", "==": "==", "!=": "!=", "<>": "!=",
            "<": "<", "<=": "<=", ">": ">", ">=": ">="}
_OP_FLIP = {"==": "==", "!=": "!=", "<": ">", "<=": ">=", ">": "<",
            ">=": "<="}


@dataclasses.dataclass(frozen=True)
class FusedTerm:
    """One ``col OP value`` conjunct. ``value`` is either ("const", v) for a
    literal int or ("param", i) for the i-th `?` placeholder."""

    col: str
    op: str  # one of FUSABLE_OPS
    value: tuple[str, Any]

    def resolve(self, params: Sequence[Any]):
        kind, v = self.value
        return params[v] if kind == "param" else v


@dataclasses.dataclass(frozen=True)
class FusedScan:
    """Conjunction of up to ``max_terms`` FusedTerms over int32 columns."""

    terms: tuple[FusedTerm, ...]

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(t.col for t in self.terms)

    @property
    def ops(self) -> tuple[str, ...]:
        return tuple(t.op for t in self.terms)


def _as_term(node: BinOp, int_columns) -> FusedTerm | None:
    op = _OP_NORM.get(node.op)
    if op is None:
        return None
    left, right = node.left, node.right
    if isinstance(right, Col) and not isinstance(left, Col):
        left, right = right, left
        op = _OP_FLIP[op]
    if not isinstance(left, Col) or left.name not in int_columns:
        return None
    if isinstance(right, Const):
        v = right.value
        if isinstance(v, bool) or not isinstance(v, int):
            return None
        return FusedTerm(left.name, op, ("const", v))
    if isinstance(right, Param):
        return FusedTerm(left.name, op, ("param", right.index))
    return None


def classify_fusable(
    node: Node | None, int_columns, max_terms: int = 4
) -> FusedScan | None:
    """Return a FusedScan plan if ``node`` is a conjunction of <= max_terms
    equality/range terms over columns in ``int_columns``; None otherwise.
    ``None`` input (no WHERE) is not fusable — the match-all path is already
    a single tensor op."""
    if node is None:
        return None
    terms: list[FusedTerm] = []

    def walk(n) -> bool:
        if isinstance(n, And):
            return walk(n.left) and walk(n.right)
        if isinstance(n, BinOp):
            t = _as_term(n, int_columns)
            if t is None:
                return False
            terms.append(t)
            return True
        if isinstance(n, Between):
            if not isinstance(n.expr, Col) or n.expr.name not in int_columns:
                return False
            for bound, op in ((n.low, ">="), (n.high, "<=")):
                if isinstance(bound, Const) and isinstance(bound.value, int) \
                        and not isinstance(bound.value, bool):
                    terms.append(FusedTerm(n.expr.name, op,
                                           ("const", int(bound.value))))
                elif isinstance(bound, Param):
                    terms.append(FusedTerm(n.expr.name, op,
                                           ("param", bound.index)))
                else:
                    return False
            return True
        return False

    if not walk(node) or not terms or len(terms) > max_terms:
        return None
    return FusedScan(tuple(terms))


def collect_params(node: Node | None) -> int:
    """Number of `?` placeholders in an AST (max index + 1)."""
    mx = -1

    def walk(n):
        nonlocal mx
        if n is None:
            return
        if isinstance(n, Param):
            mx = max(mx, n.index)
        elif isinstance(n, (BinOp, And, Or)):
            walk(n.left), walk(n.right)
        elif isinstance(n, Not):
            walk(n.child)
        elif isinstance(n, Between):
            walk(n.expr), walk(n.low), walk(n.high)
        elif isinstance(n, InList):
            walk(n.expr)
            for i in n.items:
                walk(i)
        elif isinstance(n, Func):
            for a in n.args:
                walk(a)

    walk(node)
    return mx + 1


def collect_text_consts(node: Node | None) -> list[Const]:
    """All string-valued Const nodes (to be interned before compilation)."""
    out: list[Const] = []

    def walk(n):
        if n is None:
            return
        if isinstance(n, Const) and isinstance(n.value, str):
            out.append(n)
        elif isinstance(n, (BinOp, And, Or)):
            walk(n.left), walk(n.right)
        elif isinstance(n, Not):
            walk(n.child)
        elif isinstance(n, Between):
            walk(n.expr), walk(n.low), walk(n.high)
        elif isinstance(n, InList):
            walk(n.expr)
            for i in n.items:
                walk(i)
        elif isinstance(n, Func):
            for a in n.args:
                walk(a)

    walk(node)
    return out


def map_consts(node: Node | None, fn) -> Node | None:
    """Return a copy of the AST with every Const passed through ``fn``."""
    if node is None:
        return None
    if isinstance(node, Const):
        return Const(fn(node.value))
    if isinstance(node, (Col, Param)):
        return node
    if isinstance(node, BinOp):
        return BinOp(node.op, map_consts(node.left, fn), map_consts(node.right, fn))
    if isinstance(node, And):
        return And(map_consts(node.left, fn), map_consts(node.right, fn))
    if isinstance(node, Or):
        return Or(map_consts(node.left, fn), map_consts(node.right, fn))
    if isinstance(node, Not):
        return Not(map_consts(node.child, fn))
    if isinstance(node, Between):
        return Between(
            map_consts(node.expr, fn), map_consts(node.low, fn), map_consts(node.high, fn)
        )
    if isinstance(node, InList):
        return InList(
            map_consts(node.expr, fn), tuple(map_consts(i, fn) for i in node.items)
        )
    if isinstance(node, Func):
        return Func(node.name, tuple(map_consts(a, fn) for a in node.args))
    raise TypeError(f"unknown AST node {node!r}")
