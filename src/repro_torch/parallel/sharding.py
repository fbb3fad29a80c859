"""Logical-axis sharding rules and the placement of weights over a mesh
(port of ``repro.parallel.sharding``).

One rule table maps the logical axis names of a tensor's dimensions
(``"embed"``, ``"heads"``, ``"kv_heads"``, ...) to mesh axes; a *spec* is
the result for one tensor: a tuple with one entry a dimension, each
``None`` (not sharded), one mesh axis name, or a tuple of them (sharded
over their product, the first the major one), trailing ``None`` entries
dropped. It is the port's own counterpart of ``jax.sharding.PartitionSpec``
and compares equal to ``tuple(PartitionSpec(...))`` of the same rules.

The rule tables and :func:`spec_for_axes` / :func:`specs_for_tree` are the
reference's. :func:`place_params` places a parameter tree by them: each
leaf becomes a :class:`Placed`, one tensor a mesh coordinate on that
coordinate's device holding the coordinate's slice of the leaf (a leaf
replicated over an axis is a separate copy at each coordinate of that
axis, as on a real mesh); :func:`gather_params` puts the whole tree back
on the mesh's home entry. The model code runs over a placed tree
coordinate by coordinate (:class:`TP`), with the collectives of
``parallel/collectives.py`` where the reference's compiler inserts them:
``models/transformer.py``, ``serving/engine.py``, ``training/step.py``.
:func:`shard_act` returns its input unchanged: one process drives every
entry of a mesh, and nothing asks a compiler to reshard. The reference's
``shard_map`` compatibility shim has no counterpart (torch has no
``shard_map``: the mesh code loops over coordinates).

:func:`axis_rules` installs a rule table and a mesh for the model code
under its scope, thread by thread, as the reference's does;
``attention_forward`` reads :func:`current_mesh` for its sequence-parallel
branch.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, Sequence

import torch

from repro_torch.parallel.collectives import (Shards, all_gather,
                                              partial_product, psum)

# mesh axis groups
_DP = ("pod", "data")  # batch-parallel axes (outer pod, inner data/fsdp)

# Default logical-axis -> mesh-axis rules (single- and multi-pod; missing
# mesh axes in a rule are silently dropped against the actual mesh).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": _DP,
    "seq": (),
    "embed": (),            # d_model replicated (activations & serving params)
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "expert": ("model",),
    "inner": ("model",),     # SSM d_inner
    "inner2": ("model",),    # mamba1 in_proj output (2*d_inner)
    "inner_proj": ("model",),  # mamba2 in_proj output
    "ssm_heads": ("model",),
    "state": (),
    "conv": (),
    "lowrank": (),
    "layers": (),
    "kv_cap": ("data",),     # KV pool capacity rows live on the data axis
    "kv_block": (),
}

# Param tables: training shards d_model ('embed') over 'data' (FSDP) and
# the tensor dim over 'model'; serving replicates weights over 'data' and
# keeps the tensor dim on 'model'.
TRAIN_PARAM_RULES: dict[str, tuple[str, ...]] = dict(
    DEFAULT_RULES, embed=("data",)
)
SERVE_PARAM_RULES: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)
MULTIPOD_RULES = dict(DEFAULT_RULES)

_local = threading.local()


def current_rules() -> Mapping[str, tuple[str, ...]] | None:
    return getattr(_local, "rules", None)


def current_mesh():
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, Sequence[str]] | None, mesh=None):
    """Install logical->mesh rules (and a mesh) for model code running
    under this scope, in this thread. ``None`` (or outside any scope)
    disables them: the same model code runs on one device."""
    prev = getattr(_local, "rules", None)
    prev_mesh = getattr(_local, "mesh", None)
    _local.rules = dict(rules) if rules is not None else None
    _local.mesh = mesh
    try:
        yield
    finally:
        _local.rules = prev
        _local.mesh = prev_mesh


def _mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names) if mesh is not None else ()


def spec_entry(group: Sequence[str]):
    """A spec entry from a group of mesh axes: None (empty), the name (one
    axis) or the tuple (several), as ``PartitionSpec`` normalises it."""
    group = tuple(group)
    if not group:
        return None
    return group[0] if len(group) == 1 else group


def _strip(parts: list) -> tuple:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_for_axes(axes: Sequence[str | None],
                  rules: Mapping[str, Sequence[str]],
                  mesh_axis_names: Sequence[str] = ()) -> tuple:
    """Logical axes of one tensor -> its spec, dropping mesh axes that do
    not exist on the target mesh and axes already used (a mesh axis may
    shard only one dimension)."""
    used: set[str] = set()
    parts = []
    for ax in axes:
        entry: tuple[str, ...] = ()
        if ax is not None:
            entry = tuple(
                m for m in rules.get(ax, ())
                if (not mesh_axis_names or m in mesh_axis_names)
                and m not in used)
            used.update(entry)
        parts.append(spec_entry(entry))
    return _strip(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map(fn, tree, *rest):
    """``fn`` over the axes tuples of a nested dict / list tree (and the
    matching leaves of ``rest``)."""
    if _is_axes(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not an axes tree: {type(tree).__name__}")


def specs_for_tree(axes_tree, rules, mesh, shape_tree=None):
    """A tree of logical-axes tuples -> the same tree of specs on
    ``mesh``. With ``shape_tree`` (the leaves' shapes: tuples,
    ``torch.Size`` or anything with ``.shape``), mesh axes that do not
    divide their dimension are dropped from the end of its group until the
    rest divides (e.g. a 4-kv-head GQA keeps its KV projections whole over
    a 16-way 'model' axis); such a spec keeps an entry for every
    dimension, trailing ``None`` included, as the reference's does."""
    names = _mesh_axes(mesh)

    def size(group) -> int:
        return math.prod(int(mesh.shape[a]) for a in group)

    def trim(axes, shape=None):
        spec = spec_for_axes(axes, rules, names)
        if shape is None:
            return spec
        shape = tuple(getattr(shape, "shape", shape))
        parts = []
        for i, entry in enumerate(spec + (None,) * (len(shape) - len(spec))):
            group = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            while group and shape[i] % size(group):
                group = group[:-1]
            parts.append(spec_entry(group))
        return tuple(parts)   # one entry a dimension, as the reference's

    if shape_tree is None:
        return _map(trim, axes_tree)
    return _map(trim, axes_tree, shape_tree)


def shard_act(x, *axes: str | None):
    """The reference's sharding constraint on an activation: one process
    drives every entry of a port mesh, so it returns ``x`` as it is."""
    del axes
    return x


# ------------------------------------------------------------ placement
class Placed(Shards):
    """A leaf placed over ``mesh`` by ``spec``: {coordinate index: that
    coordinate's slice, a tensor of its own on its device}, with the
    leaf's global ``shape`` and ``dtype``."""

    def __init__(self, parts, *, mesh, spec: tuple, shape: tuple, dtype):
        super().__init__(parts)
        self.mesh, self.dtype = mesh, dtype
        self.shape = tuple(shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))

    def with_parts(self, parts, *, shape=None, spec=None, dtype=None):
        """A Placed of the same mesh over new ``parts`` (a dict)."""
        return Placed(parts, mesh=self.mesh,
                      spec=self.spec if spec is None else spec,
                      shape=self.shape if shape is None else shape,
                      dtype=self.dtype if dtype is None else dtype)

    def layer(self, i: int) -> "Placed":
        """Layer ``i`` of a stacked ``[L, ...]`` leaf (views)."""
        return self.with_parts({c: t[i] for c, t in self.items()},
                               shape=self.shape[1:], spec=self.spec[1:])

    def unbind(self) -> list:
        """Every layer of a stacked leaf: one ``unbind`` a coordinate (one
        stacked gradient in the backward)."""
        parts = {c: t.unbind(0) for c, t in self.items()}
        return [self.with_parts({c: p[i] for c, p in parts.items()},
                                shape=self.shape[1:], spec=self.spec[1:])
                for i in range(self.shape[0])]

    def axes_of(self, dim: int) -> tuple:
        """The mesh axes sharding dimension ``dim`` (an empty tuple when it
        is whole)."""
        e = self.spec[dim]
        return () if e is None else (e if isinstance(e, tuple) else (e,))

    def range_of(self, dim: int, key) -> tuple[int, int]:
        """[start, stop) of coordinate ``key``'s slice along ``dim``."""
        return spec_range(self.mesh, self.spec, self.shape, dim, key)

    def replicated_axes(self) -> tuple:
        """The mesh axes (of more than one entry) this leaf is copied
        over."""
        used = {a for d in range(len(self.shape)) for a in self.axes_of(d)}
        return tuple(a for a in self.mesh.axis_names
                     if a not in used and int(self.mesh.shape[a]) > 1)

    def owns(self, key) -> bool:
        """Whether ``key`` holds a distinct copy: index 0 on every axis
        the leaf is replicated over."""
        names = self.mesh.axis_names
        return all(key[names.index(a)] == 0 for a in self.replicated_axes())


def coord_keys(mesh) -> list:
    """Every coordinate's index tuple, row-major."""
    return [tuple(c[a] for a in mesh.axis_names) for c in mesh.coords()]


def _group(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple)
                                     else (entry,))


def spec_range(mesh, spec, shape, dim: int, key) -> tuple[int, int]:
    """[start, stop) along ``dim`` of the slice that coordinate ``key``
    holds of a tensor of ``shape`` placed by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    names = mesh.axis_names
    i, n = 0, 1
    for a in _group(spec[dim]):
        size = int(mesh.shape[a])
        i, n = i * size + key[names.index(a)], n * size
    step = shape[dim] // n
    return i * step, (i + 1) * step


def split_by_spec(t: torch.Tensor, spec, mesh) -> Placed:
    """``t`` placed by ``spec``: each coordinate's slice copied to its
    device."""
    parts = {}
    for key in coord_keys(mesh):
        sl = tuple(slice(*spec_range(mesh, spec, t.shape, d, key))
                   for d in range(t.dim()))
        parts[key] = t[sl].to(mesh.devices[key], copy=True).contiguous()
    return Placed(parts, mesh=mesh, spec=spec, shape=tuple(t.shape),
                  dtype=t.dtype)


def zeros_by_spec(shape, dtype, spec, mesh) -> Placed:
    """:func:`split_by_spec` of zeros, made on each coordinate's device."""
    shape = tuple(shape)
    parts = {}
    for key in coord_keys(mesh):
        local = tuple(b - a for a, b in (spec_range(mesh, spec, shape, d, key)
                                         for d in range(len(shape))))
        parts[key] = torch.zeros(local, dtype=dtype, device=mesh.devices[key])
    return Placed(parts, mesh=mesh, spec=spec, shape=shape, dtype=dtype)


def join_placed(leaf: Placed, device=None) -> torch.Tensor:
    """The whole tensor of a placed leaf on ``device`` (None: the mesh's
    home entry), from the coordinates that own distinct slices."""
    dev = leaf.mesh.home if device is None else device
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
    for key, t in leaf.items():
        if leaf.owns(key):
            sl = tuple(slice(*leaf.range_of(d, key))
                       for d in range(len(leaf.shape)))
            out[sl] = t.detach().to(dev)
    return out


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict) and not isinstance(tree, Shards):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def place_params(params, axes, rules, mesh):
    """A parameter tree (whole tensors) -> the same tree of
    :class:`Placed` leaves over ``mesh``, each by its spec from
    :func:`specs_for_tree` (axes that do not divide their dimension
    trimmed). ``axes``: ``models.params.param_axes(cfg)``."""
    mesh.require_runnable("place_params")
    specs = specs_for_tree(axes, rules, mesh, _tree_map(
        lambda t: tuple(t.shape), params))
    return _tree_map(lambda t, sp: split_by_spec(t, sp, mesh), params, specs)


def gather_params(placed, device=None):
    """The inverse of :func:`place_params`: every leaf whole on ``device``
    (None: the mesh's home entry), bit-equal to what was placed."""
    return _tree_map(lambda leaf: join_placed(leaf, device), placed)


def is_placed(tree) -> bool:
    """Whether ``tree`` (a nested dict) holds :class:`Placed` leaves."""
    while isinstance(tree, dict) and not isinstance(tree, Shards):
        if not tree:
            return False
        tree = next(iter(tree.values()))
    return isinstance(tree, Placed)


def placed_mesh(tree):
    """The mesh of a placed tree's first leaf."""
    while not isinstance(tree, Placed):
        tree = next(iter(tree.values()))
    return tree.mesh


def local_tree(tree, key):
    """Coordinate ``key``'s tensors of a tree of Shards leaves."""
    return _tree_map(lambda leaf: leaf[key], tree)


# --------------------------------------------------- the model code's view
class TP:
    """A mesh as the model code walks it: the coordinates in row-major
    order, the batch axes (the batch dimension of every activation is cut
    over them; the other axes hold copies) and the collectives bound to
    the mesh. ``batch_axes`` are mesh axes of more than one entry."""

    def __init__(self, mesh, batch_axes=()):
        self.mesh = mesh
        self.keys = coord_keys(mesh)
        self.batch_axes = tuple(a for a in batch_axes
                                if int(mesh.shape[a]) > 1)

    @classmethod
    def for_batch(cls, mesh, batch: int):
        """The batch over ('pod', 'data') where it divides their product,
        else whole at every coordinate (``dryrun.batch_specs``'s rule)."""
        dp = tuple(a for a in _DP if a in mesh.axis_names
                   and int(mesh.shape[a]) > 1)
        n = math.prod(int(mesh.shape[a]) for a in dp)
        return cls(mesh, dp if dp and batch % n == 0 else ())

    def device(self, key) -> torch.device:
        return self.mesh.devices[key]

    def batch_range(self, key, b: int) -> tuple[int, int]:
        names = self.mesh.axis_names
        i, n = 0, 1
        for a in self.batch_axes:
            size = int(self.mesh.shape[a])
            i, n = i * size + key[names.index(a)], n * size
        return i * (b // n), (i + 1) * (b // n)

    def scatter(self, t: torch.Tensor, dim: int = 0) -> Shards:
        """A global tensor's batch slice (dimension ``dim``) at every
        coordinate, on its device (the input's placement, as the
        reference's ``in_shardings``: no collective)."""
        out = Shards()
        for k in self.keys:
            b0, b1 = self.batch_range(k, t.shape[dim])
            out[k] = t.narrow(dim, b0, b1 - b0).to(self.device(k),
                                                    copy=True)
        return out

    def join_batch(self, sh: Shards, dim: int = 0, device=None):
        """The inverse of :func:`scatter` (the output's fetch): the batch
        slices of the coordinates at index 0 outside the batch axes,
        concatenated on ``device`` (None: home)."""
        dev = self.mesh.home if device is None else device
        names = self.mesh.axis_names
        parts = [sh[k].to(dev) for k in self.keys
                 if all(k[i] == 0 for i, a in enumerate(names)
                        if a not in self.batch_axes)]
        return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]

    def map(self, fn, *args) -> Shards:
        """``fn`` at every coordinate over the coordinate's entries of the
        Shards among ``args`` (other arguments passed as they are)."""
        return Shards({k: fn(*(a[k] if isinstance(a, Shards) else a
                               for a in args)) for k in self.keys})

    def psum(self, sh, axes, origin):
        return psum(sh, self.mesh, axes, origin)

    def rows(self, a: Shards, w, axes, origin: str, dtype) -> Shards:
        """A product whose weight ``w`` (Shards of each coordinate's rows)
        is cut over ``axes``: each coordinate's ``partial_product``, the
        ``psum`` of the partials, rounded once to ``dtype``."""
        parts = Shards({k: partial_product(a[k], w[k]) for k in self.keys})
        return Shards({k: t.to(dtype) for k, t in
                       psum(parts, self.mesh, axes, origin).items()})

    def all_gather(self, sh, axes, dim, origin):
        return all_gather(sh, self.mesh, axes, dim, origin)

    def use(self, leaf: Placed, origin: str) -> Placed:
        """A weight as the model code uses it: every dimension cut over a
        batch axis (FSDP: ``embed`` over 'data' by ``TRAIN_PARAM_RULES``)
        gathered whole at every coordinate (its gradient is a
        ``reduce-scatter``); dimensions cut over 'model' stay cut."""
        parts, spec = Shards(leaf), list(leaf.spec)
        for d in range(len(leaf.shape)):
            dp = tuple(a for a in leaf.axes_of(d) if a in _DP)
            if not dp:
                continue
            if len(dp) != len(leaf.axes_of(d)):
                raise NotImplementedError(
                    f"{origin}: dimension {d} is cut over {leaf.axes_of(d)}"
                    f"; the port gathers batch axes that cut a dimension "
                    f"alone")
            parts = all_gather(parts, self.mesh, dp, d, origin)
            spec[d] = None
        if tuple(spec) == leaf.spec:
            return leaf
        return leaf.with_parts(dict(parts), spec=tuple(spec))

    def use_tree(self, tree, origin: str):
        """:meth:`use` of every leaf of a (nested dict) tree."""
        if isinstance(tree, Placed):
            return self.use(tree, origin)
        return {k: self.use_tree(v, f"{origin}.{k}")
                for k, v in tree.items()}
