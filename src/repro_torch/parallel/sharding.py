"""Logical-axis sharding rules (port of ``repro.parallel.sharding``).

One rule table maps the logical axis names of a tensor's dimensions
(``"embed"``, ``"heads"``, ``"kv_heads"``, ...) to mesh axes; a *spec* is
the result for one tensor: a tuple with one entry a dimension, each
``None`` (not sharded), one mesh axis name, or a tuple of them (sharded
over their product, the first the major one), trailing ``None`` entries
dropped. It is the port's own counterpart of ``jax.sharding.PartitionSpec``
and compares equal to ``tuple(PartitionSpec(...))`` of the same rules.

The rule tables and :func:`spec_for_axes` / :func:`specs_for_tree` are the
reference's. Where they place a tensor is a plan: in this slice only the
serving mesh's paged island (``serving/paged.py``) and the sequence-
parallel attention (``models/layers/attention.py``) run over a mesh;
weights, projections, MLPs and logits stay whole on the mesh's home entry.
:func:`shard_act` therefore returns its input unchanged: one process drives
every entry of a mesh, and nothing asks a compiler to reshard. The
reference's ``shard_map`` compatibility shim has no counterpart (torch
has no ``shard_map``: the mesh code loops over coordinates).

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
