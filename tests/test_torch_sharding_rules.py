"""The port's logical-axis sharding rules (``repro_torch.parallel``) against
the reference's (``repro.parallel.sharding``) on the CPU.

Every arch's parameter axes (the reference's ``abstract_init`` of its
``init_model``: shapes only, no allocation) go through both packages'
``spec_for_axes`` and ``specs_for_tree`` under the four rule tables
(``DEFAULT_RULES``, ``TRAIN_PARAM_RULES``, ``SERVE_PARAM_RULES``,
``MULTIPOD_RULES``), with and without the leaves' shapes, over meshes of
shape (2, 2) and (1, 4) (``data``, ``model``) and (2, 2, 2) (``pod``,
``data``, ``model``). The reference's side uses a
``jax.sharding.AbstractMesh`` of the same shape, so no device count is
needed; a spec is compared as the tuple of its entries.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.params import abstract_init
from repro.parallel import sharding as JS
from repro_torch import parallel as TSP
from repro_torch.launch import mesh as TM
from repro_torch.parallel import sharding as TS

TABLES = ("DEFAULT_RULES", "TRAIN_PARAM_RULES", "SERVE_PARAM_RULES",
          "MULTIPOD_RULES")
MESHES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")))


@functools.lru_cache(maxsize=None)
def axes_of(arch):
    sds, axes = abstract_init(JTF.init_model, JC.get_config(arch))
    return sds, axes


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_rule_tables_equal_reference():
    for name in TABLES:
        assert getattr(TS, name) == getattr(JS, name), name
        assert getattr(TSP, name) is getattr(TS, name)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_param_specs_match_reference(arch):
    """Every leaf's spec, per table and mesh, with the leaves' shapes (the
    non-dividing axes trimmed) and without."""
    sds, axes = axes_of(arch)
    shapes = jax.tree.map(lambda s: tuple(s.shape), sds)
    flat_axes = _flat(axes if isinstance(axes, dict) else dict(axes))
    is_ns = (lambda x: isinstance(x, NamedSharding))
    for table in TABLES:
        rules = getattr(JS, table)
        for shape, names in MESHES:
            jm = AbstractMesh(shape, names)
            tm = TM.make_mesh(shape, names, device="meta")
            for path, ax in flat_axes.items():
                assert TS.spec_for_axes(ax, rules, names) == tuple(
                    JS.spec_for_axes(ax, rules, names)), (table, path)
                assert TS.spec_for_axes(ax, rules) == tuple(
                    JS.spec_for_axes(ax, rules)), (table, path)
            for with_shapes in (False, True):
                want = JS.specs_for_tree(axes, rules, jm,
                                         sds if with_shapes else None)
                got = TS.specs_for_tree(axes, rules, tm,
                                        shapes if with_shapes else None)
                want = _flat(jax.tree.map(lambda s: tuple(s.spec), want,
                                          is_leaf=is_ns))
                assert _flat(got) == want, (table, shape, with_shapes)


def test_spec_for_axes_basics():
    """The reference's unit cases (tests/test_sharding_rules.py)."""
    rules = TS.DEFAULT_RULES
    assert TS.spec_for_axes(("batch", "seq", "embed"), rules) == \
        tuple(P(("pod", "data")))
    assert TS.spec_for_axes(("embed", "mlp"), rules) == (None, "model")
    assert TS.spec_for_axes(("vocab", "embed"), rules) == ("model",)
    assert TS.spec_for_axes(("a", "b"), {"a": ("model",),
                                         "b": ("model",)}) == ("model",)
    assert TS.spec_for_axes(("batch",), rules, ("data", "model")) == \
        ("data",)


def test_specs_for_tree_trims_what_does_not_divide():
    """A 4-kv-head projection over 'model' 8 keeps its heads whole; 16
    split; a group keeps its leading axes that still divide."""
    mesh = TM.make_mesh((2, 8), ("data", "model"), device="meta")
    axes = {"wk": ("embed", "kv_heads", "head_dim"),
            "wq": ("embed", "heads", "head_dim"), "x": ("batch", "embed")}
    shapes = {"wk": (64, 4, 16), "wq": (64, 16, 16), "x": (6, 64)}
    got = TS.specs_for_tree(axes, TS.TRAIN_PARAM_RULES, mesh, shapes)
    assert got == {"wk": ("data", None, None),
                   "wq": ("data", "model", None), "x": ("data", None)}
    got = TS.specs_for_tree(axes, TS.DEFAULT_RULES, mesh,
                            {k: torch.empty(v, device="meta")
                             for k, v in shapes.items()})
    assert got["wk"] == (None, None, None)


def test_axis_rules_scope_and_shard_act():
    """``axis_rules`` installs rules and a mesh for its scope (nested
    scopes restore the outer one); ``shard_act`` returns its input."""
    mesh = TM.make_production_mesh()
    assert TS.current_rules() is None and TS.current_mesh() is None
    with TS.axis_rules(TS.DEFAULT_RULES, mesh):
        assert TS.current_mesh() is mesh
        assert TS.current_rules() == TS.DEFAULT_RULES
        with TS.axis_rules(None):
            assert TS.current_rules() is None and TS.current_mesh() is None
        assert TS.current_mesh() is mesh
        x = torch.ones(2, 3)
        assert TS.shard_act(x, "batch", "embed") is x
    assert TS.current_rules() is None and TS.current_mesh() is None
