"""A step's cost by mesh coordinate (the port's counterpart of XLA's
compiled ``cost_analysis()`` and ``memory_analysis()``, which the
reference's dry run reads).

:class:`CostCounter` is a ``TorchDispatchMode``: every aten op the step
runs inside it passes through it (on ``meta`` tensors in a dry run, on
the card's tensors for the same step run for real), and it keeps four
figures for each mesh coordinate:

- **FLOPs**: the aten products by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ... : twice the multiply-adds), plus each
  hand-written kernel's own reckoning (``kernels/_build.reckon``: the
  flash, paged and Mamba2 wrappers hand it their call's work);
- **bytes moved**: each op's inputs read once and its outputs written
  once, and each kernel's reckoned bytes; a view moves nothing, and an
  ``empty`` writes nothing;
- **peak temporary bytes**: the most bytes of storage alive at once that
  the step allocated (the arguments excluded), tracked storage by storage
  until Python frees it;
- **argument bytes**: what :meth:`CostCounter.arguments` is told (the
  placed parameters, the AdamW moments, the batch shards), tagged to their
  coordinates.

**Attribution.** A tensor's storage carries the coordinate it belongs
to: arguments by their place, an op's outputs by the first tagged storage
among its inputs, an op that reads no tagged tensor by the coordinate of
the loop over ``TP.keys`` it runs in (``sharding.current_coord``), and a
collective's copies by the member that receives them
(``collectives._own``). What none of these reaches counts under ``None``
(reported as ``unattributed``).

**Collectives.** The copies and sums that ``parallel/collectives.py``
makes to stand for a transfer are not counted as FLOPs or bytes (the
collective log counts them); their storage is live memory like any other.

Deliberate differences from XLA's analysis: nothing is fused, so every
intermediate is written and read again (bytes moved are an upper bound of
what a fusing compiler moves); nothing is rematerialised beyond the port's
own ``remat``; and peak memory is what the port's own program holds alive,
op by op, with no allocator rounding.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SHD

_EMPTY = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    return x


_INFO: dict = {}
_MEMO: dict = {}   # meta op signature -> (one tensor?, [(shape, stride, dtype)])


def _info(func) -> tuple:
    """(counted: not a view and not an ``empty``, its FLOP formula or
    None, whether its meta output may be memoized: a functional op)."""
    got = _INFO.get(func)
    if got is None:
        counted = not func.is_view and func not in _EMPTY
        formula = flop_registry.get(func._overloadpacket)
        functional = not func.is_view and not func._schema.is_mutable
        got = _INFO[func] = (counted, formula, functional)
    return got


class CostCounter(TorchDispatchMode):
    """Count a step by mesh coordinate (module docstring). Use as a
    context manager around the step; read :meth:`per_coord` /
    :meth:`summary` after it."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.bytes = collections.Counter()
        self.args = collections.Counter()
        self.live = collections.Counter()
        self.peak = collections.Counter()
        self.live_total = 0
        self.peak_total = 0
        self.kernel_calls = collections.Counter()
        self.ops = 0                # aten ops dispatched
        self._tag: dict = {}      # id(storage) -> coordinate
        self._size: dict = {}     # id(storage) -> bytes, storages allocated here
        self._refs: dict = {}     # id(storage) -> its weakref

    # --------------------------------------------------------- the scope
    def __enter__(self):
        _build._counters.append(self)
        CO.owners.append(self._own)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _build._counters.remove(self)
            CO.owners.remove(self._own)

    # ------------------------------------------------------------ storage
    def _key_of(self, t):
        return self._tag.get(id(t.untyped_storage()))

    def _set(self, st, key) -> None:
        sid = id(st)
        if sid not in self._tag:
            self._refs[sid] = weakref.ref(st, lambda _, sid=sid: self._drop(
                sid))
        old = self._tag.get(sid, key)
        self._tag[sid] = key
        n = self._size.get(sid)
        if n is not None and old != key:
            self.live[old] -= n
            self._bump(key, n)

    def _bump(self, key, n: int) -> None:
        self.live[key] += n
        if self.live[key] > self.peak[key]:
            self.peak[key] = self.live[key]

    def _drop(self, sid) -> None:
        self._refs.pop(sid, None)
        key = self._tag.pop(sid, None)
        n = self._size.pop(sid, None)
        if n is not None:
            self.live[key] -= n
            self.live_total -= n

    def _alloc(self, st, key) -> None:
        sid = id(st)
        if sid in self._size:
            return
        n = st.nbytes()
        self._size[sid] = n
        self._set(st, key)
        self._bump(key, n)
        self.live_total += n
        self.peak_total = max(self.peak_total, self.live_total)

    def _own(self, t, key) -> None:
        self._set(t.untyped_storage(), key)

    def arguments(self, tree, key=None) -> None:
        """Count the tensors of ``tree`` as arguments: a ``Shards`` leaf's
        at their coordinates, any other tensor at ``key``."""
        if isinstance(tree, CO.Shards):
            for k, t in tree.items():
                self._set(t.untyped_storage(), k)
                self.args[k] += _nbytes(t)
        elif isinstance(tree, torch.Tensor):
            self._set(tree.untyped_storage(), key)
            self.args[key] += _nbytes(tree)
        elif isinstance(tree, dict):
            for v in tree.values():
                self.arguments(v, key)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                self.arguments(v, key)

    # ---------------------------------------------------------- counting
    def kernel(self, name: str, flops: float, nbytes: float, like) -> None:
        """A hand-written kernel's call (``_build.reckon``)."""
        key = self._key_of(like)
        if key is None:
            key = SHD.current_coord()
        self.flops[key] += flops
        self.bytes[key] += nbytes
        self.kernel_calls[name] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        kwargs = kwargs or {}
        ins = _tensors(kwargs, _tensors(args, []))
        out = self._run(func, args, kwargs, ins)
        outs = _tensors(out, [])
        in_st = [t.untyped_storage() for t in ins]
        key = None
        for st in in_st:
            key = self._tag.get(id(st))
            if key is not None:
                break
        if key is None:
            key = SHD.current_coord()
        seen = {id(st) for st in in_st}
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in seen:
                self._alloc(st, key)
        info = _info(func)
        if info[0] and _build.counted():
            if info[1] is not None:
                self.flops[key] += info[1](*args, **kwargs, out_val=out)
            self.bytes[key] += (sum(_nbytes(t) for t in ins)
                                + sum(_nbytes(t) for t in outs))
        return out

    def _run(self, func, args, kwargs, ins):
        """``func`` on its arguments; on meta, an op that makes new
        tensors runs once for each signature (shapes, strides, dtypes and
        the other arguments): a repeat gets empty tensors of the recorded
        shapes, strides and dtypes (a walk runs each op at every
        coordinate, on the same shapes)."""
        if not ins or any(t.device.type != "meta" for t in ins) \
                or not _info(func)[2]:
            return func(*args, **kwargs)
        try:
            sig = (func, _sig(args), _sig(kwargs))
            hash(sig)
        except TypeError:
            return func(*args, **kwargs)
        got = _MEMO.get(sig)
        if got is not None:
            made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                    for sh, st, dt in got[1]]
            return made[0] if got[0] else tuple(made)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else list(out) if isinstance(
            out, (tuple, list)) else None
        if outs and all(isinstance(t, torch.Tensor) for t in outs):
            in_st = {id(t.untyped_storage()) for t in ins}
            if not any(id(t.untyped_storage()) in in_st for t in outs):
                _MEMO[sig] = (single, [(tuple(t.shape), t.stride(), t.dtype)
                                       for t in outs])
        return out

    # ----------------------------------------------------------- results
    def per_coord(self) -> dict:
        """{coordinate: {flops, bytes, peak_temp_bytes, argument_bytes}}
        over every coordinate seen (``None``: unattributed)."""
        keys = set(self.flops) | set(self.bytes) | set(self.peak) | set(
            self.args)
        return {k: {"flops": float(self.flops[k]),
                    "bytes": float(self.bytes[k]),
                    "peak_temp_bytes": int(self.peak[k]),
                    "argument_bytes": int(self.args[k])} for k in keys}

    def summary(self, keys) -> dict:
        """One coordinate's figures as the step's per-device figures, with
        the check that every coordinate of ``keys`` counts the same FLOPs,
        bytes and arguments (``uniform``) and what no coordinate took
        (``unattributed``)."""
        pc = self.per_coord()
        k0 = keys[0]
        first = pc.get(k0, {"flops": 0.0, "bytes": 0.0,
                            "peak_temp_bytes": 0, "argument_bytes": 0})
        fields = ("flops", "bytes", "argument_bytes")
        spread = {f: (min(pc.get(k, {}).get(f, 0) for k in keys),
                      max(pc.get(k, {}).get(f, 0) for k in keys))
                  for f in fields + ("peak_temp_bytes",)}
        none = pc.get(None, {})
        return {**first,
                "uniform": all(spread[f][0] == spread[f][1] for f in fields),
                "spread": spread,
                "peak_temp_bytes_sum": sum(pc.get(k, {}).get(
                    "peak_temp_bytes", 0) for k in keys),
                "peak_live_bytes_all": int(self.peak_total),
                "unattributed": {"flops": none.get("flops", 0.0),
                                 "bytes": none.get("bytes", 0.0)},
                "kernel_calls": dict(self.kernel_calls)}
