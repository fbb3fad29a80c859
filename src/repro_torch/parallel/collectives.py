"""Collectives over a device mesh driven by one process (the port's
counterpart of what GSPMD inserts into the reference's programs).

A value spread over a ``launch/mesh.Mesh`` is a :class:`Shards`: one
tensor per mesh coordinate, keyed by the coordinate's index tuple (mesh
axis order), each on that coordinate's device. A collective over some mesh
axes works group by group: a group is the coordinates that differ only in
those axes, in row-major order (the first axis the major one). Each
group's tensors are copied to the mesh's home entry, combined there in
that fixed order, and the result is copied back to every member as a
tensor of its own. Repeated calls are therefore bit-equal, and a sum of a
16-bit type is taken in fp32 and rounded once.

- :func:`psum` / :func:`pmax`: the sum (max) of the group, at every member
  (``all-reduce``);
- :func:`all_gather`: the members' tensors concatenated along a dimension,
  at every member (``all-gather``);
- :func:`reduce_scatter`: the sum, cut along a dimension, member ``j``
  keeping piece ``j`` (``reduce-scatter``);
- :func:`broadcast`: one tensor on the home entry copied to every
  coordinate.

``psum``, ``all_gather`` and ``reduce_scatter`` are autograd functions:
the gradient of a sum is the sum of the members' gradients (an
``all-reduce``), of a gather a ``reduce-scatter``, and of a
``reduce-scatter`` a gather, so a backward pass issues the transposed
collectives, as the reference's compiler does. ``pmax`` carries no
gradient (it only steadies a log-sum-exp).

**The log.** Every collective that moves data (a group of more than one
member) appends a :class:`Record` to each log opened by :func:`recording`
on the calling thread: its kind under the reference's five names
(``roofline/analysis.py``: ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``; a
:func:`broadcast` is recorded as ``broadcast``, a kind the reference's
compiled programs do not have), the mesh axes, the bytes of one
participant's output (the reference's measure) and an origin such as
``layers.7.attn.wo``. A backward pass records its collectives in the logs
that were open when the forward ran, with ``/grad`` after the origin.
``roofline.analysis.collective_bytes`` sums a log by kind.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


class Shards(dict):
    """One tensor per mesh coordinate: {index tuple (mesh axis order):
    tensor on that coordinate's device}."""

    def layer(self, i: int) -> "Shards":
        """Every shard's ``[i]`` (one layer of a layer-major tensor)."""
        return Shards({c: t[i] for c, t in self.items()})


@dataclasses.dataclass(frozen=True)
class Record:
    kind: str
    axes: tuple
    nbytes: int       # one participant's output
    origin: str


_local = threading.local()


def _open_logs() -> list:
    return list(getattr(_local, "logs", ()))


@contextlib.contextmanager
def recording():
    """Collect the collectives issued on this thread inside the scope:
    yields the list their :class:`Record` s are appended to (scopes nest;
    each open log gets every record)."""
    log: list = []
    prev = getattr(_local, "logs", ())
    _local.logs = tuple(prev) + (log,)
    try:
        yield log
    finally:
        _local.logs = prev


def _record(logs, kind: str, axes: tuple, nbytes: int, origin: str) -> None:
    rec = Record(kind, tuple(axes), int(nbytes), origin)
    for log in logs:
        log.append(rec)


# ------------------------------------------------------------- groups
def mesh_axes(mesh, axes) -> tuple:
    """``axes`` (a name or a tuple) restricted to the mesh's axes of more
    than one entry, in the order given."""
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in mesh.axis_names
                 and int(mesh.shape[a]) > 1)


def groups(mesh, keys, axes: tuple) -> list[list]:
    """The coordinates of ``keys`` grouped by their index outside
    ``axes``, each group in row-major order over ``axes``."""
    pos = [mesh.axis_names.index(a) for a in axes]
    out: dict = {}
    for k in sorted(keys, key=lambda k: tuple(k[p] for p in pos)):
        rest = tuple(v for i, v in enumerate(k) if i not in pos)
        out.setdefault(rest, []).append(k)
    return list(out.values())


def partial_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` where ``b`` holds some of the rows of a product's weight:
    a partial sum that :func:`psum` adds to the other shards'. For 16-bit
    operands it is taken and kept in fp32, so that the whole product is
    rounded once, after the sum."""
    if a.dtype in (torch.float32, torch.float64):
        return a @ b
    return a.float() @ b.float()


def _device(mesh, key) -> torch.device:
    return mesh.devices[key]


def _sum(parts, home) -> torch.Tensor:
    """The fixed-order sum of ``parts`` on ``home``: in fp32 for a
    floating type of fewer bits (and for an integer type), rounded once
    to the parts' dtype."""
    dt = parts[0].dtype
    wide = dt if dt in (torch.float32, torch.float64) else torch.float32
    acc = parts[0].to(home, wide, copy=True)
    for p in parts[1:]:
        acc = acc + p.to(home, wide)
    return acc.to(dt)


def _spread(t, mesh, members) -> list:
    """A copy of ``t`` for every member, on its device."""
    return [t.to(_device(mesh, k), copy=True) for k in members]


class _Meta:
    """What a collective's autograd node keeps: the mesh, its groups, the
    axes, the gather dimension and where to record the backward."""

    def __init__(self, mesh, grps, axes, dim, origin):
        self.mesh, self.groups, self.axes = mesh, grps, axes
        self.dim, self.origin, self.logs = dim, origin, _open_logs()


def _allreduce(meta: _Meta, keys: list, ts: list) -> list:
    by = dict(zip(keys, ts))
    out = {}
    for g in meta.groups:
        s = _sum([by[k] for k in g], meta.mesh.home)
        out.update(zip(g, _spread(s, meta.mesh, g)))
    return [out[k] for k in keys]


def _gather(meta: _Meta, keys: list, ts: list) -> list:
    by = dict(zip(keys, ts))
    out = {}
    for g in meta.groups:
        home = meta.mesh.home
        cat = torch.cat([by[k].to(home) for k in g], dim=meta.dim)
        out.update(zip(g, _spread(cat, meta.mesh, g)))
    return [out[k] for k in keys]


def _scatter(meta: _Meta, keys: list, ts: list) -> list:
    by = dict(zip(keys, ts))
    out = {}
    for g in meta.groups:
        s = _sum([by[k] for k in g], meta.mesh.home)
        if s.shape[meta.dim] % len(g):
            raise ValueError(f"reduce_scatter: dimension {meta.dim} of "
                             f"{tuple(s.shape)} does not split {len(g)} ways")
        for k, piece in zip(g, s.chunk(len(g), dim=meta.dim)):
            out[k] = piece.to(_device(meta.mesh, k), copy=True)
    return [out[k] for k in keys]


def _bytes(t) -> int:
    return t.numel() * t.element_size()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, keys, *ts):
        ctx.meta, ctx.keys = meta, keys
        return tuple(_allreduce(meta, keys, list(ts)))

    @staticmethod
    def backward(ctx, *gs):
        m = ctx.meta
        out = _allreduce(m, ctx.keys, list(gs))
        _record(m.logs, "all-reduce", m.axes, _bytes(out[0]),
                m.origin + "/grad")
        return (None, None, *out)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, keys, *ts):
        ctx.meta, ctx.keys = meta, keys
        return tuple(_gather(meta, keys, list(ts)))

    @staticmethod
    def backward(ctx, *gs):
        m = ctx.meta
        out = _scatter(m, ctx.keys, list(gs))
        _record(m.logs, "reduce-scatter", m.axes, _bytes(out[0]),
                m.origin + "/grad")
        return (None, None, *out)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, keys, *ts):
        ctx.meta, ctx.keys = meta, keys
        return tuple(_scatter(meta, keys, list(ts)))

    @staticmethod
    def backward(ctx, *gs):
        m = ctx.meta
        out = _gather(m, ctx.keys, list(gs))
        _record(m.logs, "all-gather", m.axes, _bytes(out[0]),
                m.origin + "/grad")
        return (None, None, *out)


def _run(fn, kind, sh: Shards, mesh, axes, origin, dim=0) -> Shards:
    axes = mesh_axes(mesh, axes)
    if not axes:
        return sh
    keys = list(sh)
    meta = _Meta(mesh, groups(mesh, keys, axes), axes, dim, origin)
    outs = fn.apply(meta, keys, *(sh[k] for k in keys))
    _record(meta.logs, kind, axes, _bytes(outs[0]), origin)
    return Shards(zip(keys, outs))


def psum(sh: Shards, mesh, axes, origin: str) -> Shards:
    """The sum over ``axes`` at every member of each group."""
    return _run(_PSum, "all-reduce", sh, mesh, axes, origin)


def all_gather(sh: Shards, mesh, axes, dim: int, origin: str) -> Shards:
    """The group's tensors concatenated along ``dim``, at every member."""
    return _run(_Gather, "all-gather", sh, mesh, axes, origin, dim)


def reduce_scatter(sh: Shards, mesh, axes, dim: int, origin: str) -> Shards:
    """The group's sum cut into equal pieces along ``dim``: member ``j``
    (row-major over ``axes``) keeps piece ``j``."""
    return _run(_Scatter, "reduce-scatter", sh, mesh, axes, origin, dim)


@torch.no_grad()
def pmax(sh: Shards, mesh, axes, origin: str) -> Shards:
    """The elementwise max over ``axes`` at every member (no gradient)."""
    axes = mesh_axes(mesh, axes)
    if not axes:
        return Shards({k: t.detach() for k, t in sh.items()})
    out = Shards()
    for g in groups(mesh, list(sh), axes):
        m = sh[g[0]].to(mesh.home, copy=True)
        for k in g[1:]:
            m = torch.maximum(m, sh[k].to(mesh.home))
        out.update(zip(g, _spread(m, mesh, g)))
    first = next(iter(out.values()))
    _record(_open_logs(), "all-reduce", axes, _bytes(first), origin)
    return Shards({k: out[k] for k in sh})


def broadcast(t: torch.Tensor, mesh, origin: str, keys=None) -> Shards:
    """A copy of ``t`` (on the home entry) at every coordinate of
    ``keys`` (None: the whole mesh); recorded as ``broadcast``."""
    if keys is None:
        keys = [tuple(c[a] for a in mesh.axis_names) for c in mesh.coords()]
    out = Shards(zip(keys, _spread(t, mesh, keys)))
    if len(keys) > 1:
        _record(_open_logs(), "broadcast", tuple(mesh.axis_names),
                _bytes(t), origin)
    return out
