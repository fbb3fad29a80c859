"""Executor cache: pre-planned statement serving (port of
``repro.core.execache``).

The reference compiles each statement shape ahead of time into one XLA
executable and replays it. On the card the counterpart of a compiled
executable is a captured CUDA graph: an :class:`ExecEntry` holds, per
*type class* of its bound values (the reference's avals: a float bound to
an int column takes another route), one :class:`_Plan` whose graph runs the
whole statement (its kernels, the copy of the new state into the table's
own tensors, and the packing of its outputs) in one ``cudaGraphLaunch``.
A warm dispatch is then

1. one host-to-device copy of the dispatch's bound values, packed into one
   pinned staging slot (``_Staging``), into the plan's static input buffer;
2. one graph replay;
3. one device-to-device copy of the packed outputs, which the lazy
   ``Result`` reads (a graph's outputs are static: the next replay
   overwrites them).

What this asks of the rest of the port:

* **State keeps its addresses.** Between two epoch bumps every tensor of a
  table's state stays where it is: the executors stay functional (they
  return new tensors and never write into the state they are given), and
  the plan copies each new leaf into the table's tensor, inside the graph.
* **Bound values enter from outside the graph.** Executors receive device
  views of the static input buffer, never host values (a value turned into
  a tensor inside the body would be baked into the graph).
* **Capture never syncs.** It runs on a side stream fenced against the
  serving stream with events both ways, through ``CUDAGraph.capture_begin``
  / ``capture_end`` (the ``torch.cuda.graph`` context manager synchronizes
  and empties the cache on entry). Before capturing, the closure runs once
  on a zeroed shadow state of the table's layout (the reference's
  ``_prime``): that loads the kernels, which build at first use, and sizes
  their scratch. A kernel scratch that a graph captured lives as long as
  the graph (``kernels._build.recording``).
* **One device at a time.** Replays, primes and captures of one device
  serialize on one lock: the graphs read the side stream's kernel scratch,
  so no prime may run beside a replay.

The §4.3 op-count expiry flag is the one host branch that depends on data:
when the table has an op interval, a plan captures both variants and
counts as one executable (a runtime argument in the reference).

On the CPU a plan is the eager closure, staged, run and packed the same
way, with identical counting. Nothing falls back: a graph that fails to
capture or replay raises, and no path runs the eager closure on the card
(``fallbacks`` exists for the reference's stats and stays 0).

A cache-wide schema epoch retires every plan at once (REINDEX, RESHARD);
FLUSH keeps it. A sharded table's lane plans are one per statement shape
and lane: a graph binds the addresses of its lane's views. Retired graphs, their pools and buffers are released once the
device has passed the point where they were retired.

Placement (a table placed over a lane mesh, ``core/shards.py``): an entry
lives on one device (a lane's, or a block's), where its plans stage,
prime, capture and replay under that device's lock, on that device's
shadow state (a copy of the table's) and graph pool; the placement is
part of the daemon's key. A mesh fan-out is a :class:`MeshEntry`: one
entry a block, each on its device, then a merge entry on the home device
whose bound values are the blocks' outputs (device tensors, copied into
its static inputs), then, where the statement writes what the merge
decides (a batched SELECT's touch), one entry a block again. A warm
mesh fan-out is so one graph launch a block plus the merge's.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import telemetry as TEL
from repro_torch.kernels import _build
from repro_torch.lint import lockorder as LK

__all__ = ["ExecEntry", "ExecutorCache", "MeshEntry", "device_lock",
           "side_stream", "stage_array"]

_ALIGN = 16

# per device: the lock every replay, prime and capture takes, the side
# stream captures run on, the pinned staging ring, retired objects
_DEVICE_LOCKS: dict[str, Any] = {}
_SIDE: dict[int, Any] = {}
_STAGING: dict[int, "_Staging"] = {}
_GRAVE: list = []


def device_lock(device: torch.device):
    key = str(device)
    lk = _DEVICE_LOCKS.get(key)
    if lk is None:
        lk = _DEVICE_LOCKS.setdefault(key, LK.make_lock("execache.device"))
    return lk


def side_stream(device: torch.device):
    s = _SIDE.get(device.index)
    if s is None:
        s = _SIDE[device.index] = torch.cuda.Stream(device)
    return s


def _retire(device: torch.device, objs) -> None:
    """Drop ``objs`` (plans, shadow states) once the device has run what
    was enqueued so far (caller holds the device lock)."""
    if device.type != "cuda":
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    _GRAVE.append((ev, objs))


def _sweep() -> None:
    _GRAVE[:] = [(ev, o) for ev, o in _GRAVE if not ev.query()]


def _tree_to(tree, device):
    """A copy of a state tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


# --------------------------------------------------------------- layouts

_TORCH_DTYPE: dict = {}


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    td = _TORCH_DTYPE.get(dt)
    if td is None:
        td = _TORCH_DTYPE[dt] = torch.from_numpy(np.empty(0, dt)).dtype
    return td


def _spec(tree):
    """Hashable structure and leaf type classes (dtype, shape) of a host
    argument tree of tuples, dicts and numpy arrays."""
    if isinstance(tree, (tuple, list)):
        return ("t", tuple(_spec(x) for x in tree))
    if isinstance(tree, dict):
        return ("d", tuple((k, _spec(v)) for k, v in tree.items()))
    if isinstance(tree, np.ndarray):
        return (tree.dtype.str, tree.shape)
    if isinstance(tree, torch.Tensor):   # a device value (a merge's input)
        return ("T", str(tree.dtype), tuple(tree.shape))
    raise TypeError(f"executor argument {type(tree).__name__} is not a "
                    f"numpy array or a tensor")


def _host_leaves(tree, out: list) -> list:
    if isinstance(tree, (tuple, list)):
        for x in tree:
            _host_leaves(x, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _host_leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    """``tree`` with each array leaf replaced by the next item of ``it``."""
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(x, it) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def _layout(items) -> tuple[list, int]:
    """(offset, nbytes, torch dtype, shape) of each (torch dtype, shape,
    nbytes) item, every offset 16-byte aligned, and the total bytes."""
    out, off = [], 0
    for dt, shape, nb in items:
        out.append((off, nb, dt, shape))
        off += -(-nb // _ALIGN) * _ALIGN
    return out, off


def _views(buf: torch.Tensor, layout) -> list:
    return [buf[off:off + nb].view(dt).reshape(shape)
            for off, nb, dt, shape in layout]


def _out_skeleton(tree, leaves: list):
    """(skeleton, tensor leaves) of an executor's outputs."""
    if isinstance(tree, (tuple, list)):
        return ("t", tuple(_out_skeleton(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return ("d", tuple((k, _out_skeleton(v, leaves))
                           for k, v in tree.items()))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("x", len(leaves) - 1)
    return ("c", tree)


def _out_sig(outs) -> tuple:
    """(skeleton, layout, total bytes, tensor leaves) of a closure's
    outputs ``outs`` packed into one byte buffer (:func:`_pack`)."""
    leaves: list = []
    skel = _out_skeleton(outs, leaves)
    layout, total = _layout((t.dtype, tuple(t.shape),
                             t.numel() * t.element_size()) for t in leaves)
    return skel, tuple(layout), total, leaves


def _fill(skel, arrs):
    tag, body = skel
    if tag == "t":
        return tuple(_fill(x, arrs) for x in body)
    if tag == "d":
        return {k: _fill(v, arrs) for k, v in body}
    if tag == "x":
        return arrs[body]
    return body


def _pack(leaves: list, layout, total: int, device) -> torch.Tensor:
    """The output tensors' bytes in one uint8 tensor (``layout``'s
    offsets; the gaps hold garbage). One output is its own bytes."""
    if len(leaves) == 1:
        return leaves[0].contiguous().reshape(-1).view(torch.uint8)
    parts, pos = [], 0
    pad = torch.empty((_ALIGN,), dtype=torch.uint8, device=device)
    for t, (off, nb, _, _) in zip(leaves, layout):
        if off > pos:
            parts.append(pad[:off - pos])
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        pos = off + nb
    if total > pos:
        parts.append(pad[:total - pos])
    return torch.cat(parts)


def _write_back(state: dict, new: dict) -> None:
    """Copy every leaf of ``new`` that is not the table's own tensor into
    it: the table's tensors keep their addresses."""
    pairs: list = []

    def walk(dst, src, path):
        if isinstance(dst, dict):
            if not isinstance(src, dict) or set(src) != set(dst):
                raise ValueError(f"executor changed the state's layout at "
                                 f"{path or 'state'}")
            for k in dst:
                walk(dst[k], src[k], f"{path}/{k}")
        elif src is not dst:
            pairs.append((dst, src))

    walk(state, new, "")
    if not pairs:
        return
    own = {d.untyped_storage().data_ptr() for d, _ in pairs}
    # a view of a leaf that another copy overwrites is copied first
    srcs = [src.clone() if src.untyped_storage().data_ptr() in own else src
            for _, src in pairs]
    # one plain copy a leaf, a copy node each on the card: a multi-tensor
    # copy kernel is slower on a column of 131,072 ints (PERF.md §6)
    for (dst, _), src in zip(pairs, srcs):
        dst.copy_(src)


# --------------------------------------------------------------- staging

class _Slot:
    __slots__ = ("buf", "np", "event")

    def __init__(self, nbytes: int):
        self.buf = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
        self.np = self.buf.numpy()
        self.event = None


class _Staging:
    """Ring of pinned host slots for bound values. A slot is rewritten only
    after the copy that read it has run (its event, tested with
    ``query()``); when every slot is busy the ring grows."""

    def __init__(self):
        self.slots: list[_Slot] = []

    def acquire(self, nbytes: int) -> _Slot:
        for i, s in enumerate(self.slots):
            if s.event is None or s.event.query():
                if s.buf.numel() < nbytes:
                    s = self.slots[i] = _Slot(max(nbytes, 2 * s.buf.numel()))
                return s
        s = _Slot(max(nbytes, 4096))
        self.slots.append(s)
        return s


def _stage_np(dst: np.ndarray, layout, leaves) -> None:
    for (off, nb, _, _), a in zip(layout, leaves):
        if nb:
            dst[off:off + nb].view(a.dtype)[...] = a.reshape(-1)


def _stage(buf: torch.Tensor, layout, leaves) -> None:
    """Host arrays into the device byte buffer ``buf`` at ``layout``'s
    offsets: on the card through one pinned slot of the device's ring and
    one non-blocking copy (of the whole buffer: device values are copied
    over their places after it), on the CPU by a plain copy."""
    if buf.device.type != "cuda":
        _stage_np(buf.numpy(), layout, leaves)
        return
    ring = _STAGING.get(buf.device.index)
    if ring is None:
        ring = _STAGING[buf.device.index] = _Staging()
    nbytes = buf.numel()
    slot = ring.acquire(nbytes)
    _stage_np(slot.np, layout, leaves)
    buf.copy_(slot.buf[:nbytes], non_blocking=True)
    if slot.event is None:
        slot.event = torch.cuda.Event()
    slot.event.record(torch.cuda.current_stream(buf.device))


def stage_array(dst: torch.Tensor, host: np.ndarray) -> None:
    """``host`` (the same bytes as the contiguous tensor ``dst``) into
    ``dst`` through one pinned staging slot: one host-to-device copy that
    does not wait for the card."""
    buf = dst.view(torch.uint8).reshape(-1)
    _stage(buf, ((0, buf.numel(), None, None),), [host])


# ----------------------------------------------------------------- plans

class _Plan:
    """One entry at one type class of its bound values: the static input
    buffer and its views, and on the card one captured graph per expiry
    flag with its static packed outputs."""

    __slots__ = ("fn", "device", "in_layout", "in_total", "in_buf", "views",
                 "graphs", "out_layout", "out_total", "out_skel",
                 "kernel_launches", "keep")

    def __init__(self, fn: Callable, device: torch.device, args):
        self.fn = fn
        self.device = device
        leaves = _host_leaves(args, [])
        self.in_layout, self.in_total = _layout(
            (a.dtype, tuple(a.shape), a.numel() * a.element_size())
            if isinstance(a, torch.Tensor)
            else (_torch_dtype(a.dtype), a.shape, a.nbytes) for a in leaves)
        self.in_buf = (torch.empty((self.in_total,), dtype=torch.uint8,
                                   device=device)
                       if self.in_total else None)
        self.views = _rebuild(args, iter(
            _views(self.in_buf, self.in_layout) if self.in_total else ()))
        self.graphs: dict[bool, Any] = {}
        self.out_layout = None
        self.out_total = 0
        self.out_skel = None
        self.kernel_launches: dict[bool, dict] = {}
        self.keep: list = []

    # ---------------------------------------------------------- staging
    def stage(self, leaves) -> None:
        """The dispatch's bound values into the static input buffer: host
        values through one pinned slot and one non-blocking copy (on the
        card), then each device value by one device-to-device copy (from
        any device: stream-ordered on both)."""
        if not self.in_total:
            return
        host = [(lay, a) for lay, a in zip(self.in_layout, leaves)
                if not isinstance(a, torch.Tensor)]
        if host:
            _stage(self.in_buf, [h[0] for h in host], [h[1] for h in host])
        if len(host) < len(leaves):
            views = _views(self.in_buf, self.in_layout)
            for v, a in zip(views, leaves):
                if isinstance(a, torch.Tensor):
                    v.copy_(a, non_blocking=True)

    # ------------------------------------------------------------- body
    def _body(self, state: dict, flag: bool) -> torch.Tensor | None:
        """Run the closure against the table's tensors: outputs packed
        first, then the new state copied into the table's tensors."""
        out = self.fn(state, flag, *self.views)
        skel, layout, total, leaves = _out_sig(tuple(out[1:]))
        if self.out_skel is None:
            self.out_skel, self.out_layout, self.out_total = (skel, layout,
                                                              total)
        packed = (_pack(leaves, self.out_layout, self.out_total, self.device)
                  if self.out_total else None)
        _write_back(state, out[0])
        return packed

    def _outputs(self, packed) -> tuple:
        arrs = _views(packed, self.out_layout) if self.out_total else []
        return _fill(self.out_skel, arrs)

    # --------------------------------------------------------- planning
    def prime(self, shadow: dict, flags) -> None:
        """Run the closure on a zeroed shadow state of the table's layout
        (never the table's): loads and builds the kernels, sizes their
        scratch, and raises on a bad binding before anything is kept."""
        for f in flags:
            self.fn(shadow, f, *self.views)

    def capture(self, state: dict, flags, pool) -> None:
        """One graph per flag against the table's own tensors (nothing
        runs: capturing only records), each with its static packed
        outputs in the table's pool. Caller has primed on this stream."""
        for f in flags:
            g = torch.cuda.CUDAGraph()
            with _build.recording() as rec:
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    packed = self._body(state, f)
                except BaseException:
                    try:
                        g.capture_end()
                    except Exception:  # noqa: BLE001 — the body's error wins
                        pass
                    raise
                g.capture_end()
            self.graphs[f] = (g, packed)
            self.kernel_launches[f] = dict(rec["launches"])
            self.keep.extend(rec["keep"])

    # ----------------------------------------------------------- serving
    def run(self, state: dict, flag: bool, leaves, raw: bool = False):
        """Stage ``leaves`` (None: already staged) and run; on the card one
        replay and one copy of the packed outputs. ``raw``: the packed
        output bytes instead, uncopied (on the card the graph's own
        buffer, which its next replay overwrites)."""
        if leaves is not None:
            self.stage(leaves)
        if self.device.type != "cuda":
            packed = self._body(state, flag)
        else:
            g, packed = self.graphs[flag]
            with torch.cuda.device(self.device):
                g.replay()
            _build.add_launches(self.kernel_launches[flag])
            if not raw and packed is not None:
                packed = packed.clone()
        if raw:
            return (torch.empty((0,), dtype=torch.uint8, device=self.device)
                    if packed is None else packed)
        return self._outputs(packed)


class ExecEntry:
    """One statement shape's executor on one device: the closure ``fn(state,
    flag, *args)`` and its plans, one per type class of its bound values.
    The daemon calls an entry with the state it runs on, the expiry flag
    and a tree of bound values (host numpy arrays, or device tensors for a
    merge); it returns the closure's outputs as fresh tensors and has
    updated the state in place."""

    __slots__ = ("_cache", "fn", "flags", "view", "epoch", "compiled",
                 "device")

    def __init__(self, cache: "ExecutorCache", fn: Callable, flags,
                 view: Callable[[dict], dict] | None = None, epoch: int = 0,
                 device: torch.device | None = None):
        self._cache = cache
        self.fn = fn
        self.flags = flags
        self.view = view
        self.epoch = epoch   # the epoch it was made in
        self.compiled: dict[Any, _Plan] = {}
        self.device = cache.device if device is None else device

    def __call__(self, state: dict, flag: bool, args) -> tuple:
        """Hit: stage and replay the plan of these bound values' type
        class. Miss: plan it (prime and capture on the card), then run."""
        with device_lock(self.device):
            return self.call_locked(state, flag, args)

    def call_locked(self, state: dict, flag: bool, args, raw: bool = False):
        """:meth:`__call__` with the device lock held by the caller.
        ``raw``: (the plan, its packed output bytes uncopied), which the
        caller reads before it lets go of the lock."""
        cache = self._cache
        spec = _spec(args)
        leaves = _host_leaves(args, [])
        plan = self.compiled.get(spec)
        if plan is None:
            cache.counters.add("misses")
            plan, ms = self._plan(state, args, leaves)
            TEL.note_exec("compile", ms)
            self.compiled[spec] = plan
            leaves = None   # _plan staged them
        else:
            cache.counters.add("hits")
            TEL.note_exec("hit")
        out = plan.run(state, bool(flag), leaves, raw)
        return (plan, out) if raw else out

    def warm(self, state: dict, args) -> bool:
        """Pre-plan this entry for ``args``' type class from placeholder
        values (never touching the table's contents). True when a new
        plan was made, False when one existed."""
        spec = _spec(args)
        with device_lock(self.device):
            # an entry retired while a warm-up held it plans nothing more
            if spec in self.compiled or self.epoch != self._cache.epoch:
                return False
            plan, _ = self._plan(state, args, _host_leaves(args, []),
                                 warm=True)
            self.compiled[spec] = plan
            return True

    def dry_run(self, args) -> tuple:
        """The closure's outputs on the shadow state (placeholder values of
        the right types and shapes, for the warm-up of what consumes
        them); the table is not touched."""
        with device_lock(self.device):
            plan = _Plan(self.fn, self.device, args)
            plan.stage(_host_leaves(args, []))
            return tuple(self.fn(self._shadow(), False, *plan.views)[1:])

    def _shadow(self) -> dict:
        """The shadow state in the layout this entry's closure takes (one
        lane of a sharded table's for a lane entry)."""
        sh = self._cache.shadow(self.device)
        return sh if self.view is None else self.view(sh)

    def _plan(self, state: dict, args, leaves, warm: bool = False):
        """Make one plan (caller holds the device lock): stage the values,
        prime on the shadow state and, on the card, capture every flag
        variant on the side stream."""
        cache = self._cache
        dev = self.device
        t0 = time.perf_counter()
        plan = _Plan(self.fn, dev, args)
        plan.stage(leaves)
        if dev.type == "cuda":
            _sweep()
            serving = torch.cuda.current_stream(dev)
            side = side_stream(dev)
            side.wait_stream(serving)
            try:
                with torch.cuda.device(dev), torch.cuda.stream(side):
                    plan.prime(self._shadow(), self.flags)
                    plan.capture(state, self.flags,
                                 cache.pool(self.epoch, dev))
            finally:
                serving.wait_stream(side)
        elif warm:
            plan.prime(self._shadow(), self.flags)
        ms = (time.perf_counter() - t0) * 1e3
        cache.counters.add("compiles")
        cache.counters.add("compile_ms_total", ms)
        return plan, ms


class MeshEntry:
    """A mesh fan-out: ``blocks[k]`` runs on block ``k`` (its device's
    entry), a merge entry combines their outputs on the home device, and
    ``post[k]`` (optional) runs on block ``k`` again with the merged
    outputs. Called like an :class:`ExecEntry` with the blocks as the
    state and ``args`` = (deltas, pre_deltas, *rest): the lazy clock's
    [n_shards] catch-up vectors, each block taking its slice; the blocks
    then take ``rest``, the post entries ``post_args(rest, merged)``. The
    expiry flag goes to the post entries where there are any, else to the
    blocks.

    Each block's packed output bytes reach the merge's input by one copy
    (no copy a leaf), with every device of the mesh locked from the
    blocks' replays to that copy. ``merge(list of block outputs) ->
    outputs`` runs on views of those bytes, in the entry ``merge_entry(
    sig, builder)`` gives for the blocks' output layouts ``sig``."""

    def __init__(self, blocks: list, home: torch.device, merge: Callable,
                 merge_entry: Callable, post=None,
                 post_args: Callable | None = None):
        self.blocks = blocks
        self.home = home
        self.merge = merge
        self.merge_entry = merge_entry
        self.post = post
        self.post_args = post_args
        self._devices = sorted({e.device for e in blocks} | {home}, key=str)

    def _split(self, args, n_blocks: int):
        deltas, pre, *rest = args
        per = deltas.shape[0] // n_blocks
        return [(deltas[k * per:(k + 1) * per], pre[k * per:(k + 1) * per])
                for k in range(n_blocks)], tuple(rest)

    def _merger(self, sig: tuple) -> ExecEntry:
        """The merge entry for block outputs laid out as ``sig`` (one
        (skeleton, layout) a block): it takes each block's bytes."""
        def build():
            def fn(st, flag, *bufs):
                outs = [_fill(skel, _views(b, lay))
                        for b, (skel, lay) in zip(bufs, sig)]
                return ({},) + tuple(self.merge(outs))
            return fn
        return self.merge_entry(sig, build)

    def __call__(self, blocks: list, flag: bool, args) -> tuple:
        lead, rest = self._split(args, len(blocks))
        bflag = flag and self.post is None
        with contextlib.ExitStack() as held:
            for dev in self._devices:
                held.enter_context(device_lock(dev))
            ran = [e.call_locked(st, bflag, lead[k] + rest, raw=True)
                   for k, (e, st) in enumerate(zip(self.blocks, blocks))]
            sig = tuple((p.out_skel, p.out_layout) for p, _ in ran)
            merged = self._merger(sig).call_locked(
                {}, False, tuple(b for _, b in ran))
            if self.post is not None:
                extra = self.post_args(rest, merged)
                for e, st in zip(self.post, blocks):
                    e.call_locked(st, flag, extra)
        return merged

    def warm(self, blocks: list, args) -> bool:
        """Pre-plan every part from placeholder values: the blocks', then
        the merge's on zeroed bytes of the blocks' output layouts, then
        the post entries' on the merge's outputs. True when any plan was
        new."""
        lead, rest = self._split(args, len(blocks))
        new = False
        sig, bufs = [], []
        for k, (e, st) in enumerate(zip(self.blocks, blocks)):
            new |= e.warm(st, lead[k] + rest)
            skel, layout, total, _ = _out_sig(e.dry_run(lead[k] + rest))
            sig.append((skel, layout))
            bufs.append(torch.zeros((total,), dtype=torch.uint8,
                                    device=self.home))
        merger = self._merger(tuple(sig))
        new |= merger.warm({}, tuple(bufs))
        if self.post is not None:
            extra = self.post_args(rest, merger.dry_run(tuple(bufs)))
            for e, st in zip(self.post, blocks):
                new |= e.warm(st, extra)
        return new


class ExecutorCache:
    """Per-table executor registry: epoch-keyed entries and counters.

    ``get(key, builder)`` memoizes one entry per ``(epoch, key)``; after
    :meth:`bump` every old plan is unreachable by construction. ``device``
    is the table's (its home); ``shadow`` builds a zeroed state of the
    table's layout on it (the prime's input), of which every other device
    an entry lives on gets a copy."""

    def __init__(self, device, shadow: Callable[[], dict] | None = None):
        self.device = torch.device(device)
        self.epoch = 0
        self._entries: dict[Any, ExecEntry] = {}
        # dispatch signatures already pre-planned (kind, stmt, bucket,
        # mode, placement); host only, read by scheduler admission and
        # EXPLAIN, cleared by bump() with the entries they describe
        self.sigs: set = set()
        self._lock = LK.make_lock("execache.entries")
        self.counters = TEL.Counters({"hits": 0, "misses": 0, "compiles": 0,
                                      "fallbacks": 0, "compile_ms_total": 0.0})
        self._shadow_fn = shadow
        self._shadows: dict = {}   # device -> shadow state
        self._pools: dict = {}     # device -> graph pool of this epoch
        self._devices = {self.device}

    @property
    def hits(self) -> int:
        return self.counters["hits"]

    @property
    def misses(self) -> int:
        return self.counters["misses"]

    @property
    def compiles(self) -> int:
        return self.counters["compiles"]

    @property
    def fallbacks(self) -> int:
        return self.counters["fallbacks"]

    @property
    def compile_ms_total(self) -> float:
        return self.counters["compile_ms_total"]

    # ------------------------------------------- device-side resources
    def shadow(self, device: torch.device | None = None) -> dict:
        """The zeroed shadow state on ``device`` (default: the table's;
        made on the current stream, which is the side stream on the card;
        caller holds the device lock)."""
        device = self.device if device is None else device
        sh = self._shadows.get(device)
        if sh is None:
            if device == self.device:
                if self._shadow_fn is None:
                    raise RuntimeError("ExecutorCache has no shadow-state "
                                       "builder")
                sh = self._shadow_fn()
            else:
                sh = _tree_to(self.shadow(), device)
            self._shadows[device] = sh
        return sh

    def pool(self, epoch: int, device: torch.device | None = None):
        """The graph memory pool of ``device`` (default: the table's) for a
        capture of an entry made in ``epoch``: the table's pool while that
        epoch is current, else a pool of its own. (A retired entry's
        graphs are freed with it; had they shared the current pool,
        freeing them could leave that pool with no graph while later
        captures still share it.)"""
        device = self.device if device is None else device
        with self._lock:
            if epoch != self.epoch:
                return torch.cuda.graph_pool_handle()
            if device not in self._pools:
                self._pools[device] = torch.cuda.graph_pool_handle()
            return self._pools[device]

    # ------------------------------------------------------------- entries
    def get(self, key: Any, builder: Callable[[], Callable],
            flags: tuple = (False,),
            view: Callable[[dict], dict] | None = None,
            device: torch.device | None = None) -> ExecEntry:
        """The entry for ``key`` under the current epoch, building its
        closure on first use. ``flags``: the expiry-flag variants a plan
        captures; ``view``: the part of the shadow state the closure
        takes (a sharded table's lane entries); ``device``: where it runs
        (default: the table's). The key names the placement."""
        ek = (self.epoch, key)
        entry = self._entries.get(ek)
        if entry is None:
            with self._lock:
                entry = self._entries.get(ek)
                if entry is None:
                    entry = ExecEntry(self, builder(), flags, view,
                                      epoch=ek[0], device=device)
                    self._entries[ek] = entry
                    self._devices.add(entry.device)
        return entry

    def _take(self, bump: bool, shadow=None) -> list:
        """Empty the cache under its lock; returns what it held. A bump
        moves the epoch on and keeps the shadow state unless the layout
        changed (``shadow``: the new layout's builder)."""
        with self._lock:
            if bump:
                self.epoch += 1
            old = list(self._entries.values())
            self._entries = {}
            self.sigs.clear()
            self._pools = {}
            if not bump or shadow is not None:
                old.append(self._shadows)
                self._shadows = {}
            if shadow is not None:
                self._shadow_fn = shadow
        return old

    def _release(self, old: list) -> None:
        """Retire ``old`` once every device the table's entries ran on has
        passed this point."""
        objs = [getattr(e, "compiled", e) for e in old]
        for dev in sorted(self._devices, key=str):
            with device_lock(dev):
                _retire(dev, objs)
                _sweep()

    def bump(self, shadow: Callable[[], dict] | None = None) -> int:
        """Retire every plan (schema epoch bump: REINDEX; RESHARD, which
        also hands the new layout's shadow builder)."""
        self._release(self._take(bump=True, shadow=shadow))
        return self.epoch

    def close(self) -> None:
        """Release every plan, the pool and the shadow state (DROP)."""
        self._release(self._take(bump=False))

    # ---------------------------------------------------------- signatures
    def note_sig(self, sig: tuple) -> None:
        self.sigs.add(sig)

    def has_sig(self, sig: tuple) -> bool:
        return sig in self.sigs

    # --------------------------------------------------------------- stats
    def stats_dict(self) -> dict:
        """The ``executors`` block of ``SHOW STATS t``."""
        entries = list(self._entries.values())
        return {
            "cached": sum(len(e.compiled) for e in entries),
            "entries": len(entries),
            "epoch": self.epoch,
            "hits": self.hits,
            "misses": self.misses,
            "compiles": self.compiles,
            "fallbacks": self.fallbacks,
            "compile_ms_total": round(self.compile_ms_total, 3),
        }
