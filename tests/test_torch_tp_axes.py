"""The port's weight placement against the JAX reference on the CPU.

* ``models/params.param_axes(cfg)`` equals the reference's axes tree
  (``abstract_init(init_model, cfg)[1]``) for every arch's SMOKE config and
  for the yi-6b, gemma2-2b and zamba2-2.7b full configs.
* ``parallel/sharding.place_params`` over forced CPU meshes ((2, 2), (1,
  4), (pod 2, data 1, model 2)) by ``SERVE_PARAM_RULES`` and
  ``TRAIN_PARAM_RULES``: every coordinate holds exactly its spec's slice
  (its bytes the leaf's over the product of the axes that cut it; a leaf
  copied over an axis is a tensor of its own at each coordinate), and
  ``gather_params`` gives the input back bit for bit.
* ``parallel/collectives.py``: ``psum``, ``pmax``, ``all_gather``,
  ``reduce_scatter`` and ``broadcast`` over one and two axes, their values,
  their gradients (the transposed collectives) and their log records;
  ``roofline.analysis.collective_bytes`` and ``roofline.profile.
  top_collectives`` of a log.
* The two repairs: ``launch/train.py --mesh single`` trains with the losses
  of ``--mesh none`` (the reference's launcher parses the flag and never
  reads it), and ``unroll=`` is taken by ``make_train_step``,
  ``train_loss`` and ``prefill`` with the same results for both values.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.params import abstract_init
from repro_torch import configs as TC
from repro_torch.launch import mesh as TM
from repro_torch.launch import train as TTR
from repro_torch.models import transformer as TTF
from repro_torch.models.params import param_axes
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SH
from repro_torch.roofline.analysis import collective_bytes
from repro_torch.roofline.profile import top_collectives
from repro_torch.training.step import make_train_step

FULL = ("yi-6b", "gemma2-2b", "zamba2-2.7b")
CASES = ([(a, True) for a in TC.all_archs()] + [(a, False) for a in FULL])


def _is_axes(x):
    return isinstance(x, tuple)


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_axes_equal_the_reference(arch, smoke):
    jcfg = JC.get_smoke(arch) if smoke else JC.get_config(arch)
    tcfg = TC.get_smoke(arch) if smoke else TC.get_config(arch)
    _, axes = abstract_init(JTF.init_model, jcfg)
    want = jax.tree.map(lambda a: a, axes, is_leaf=_is_axes)
    assert param_axes(tcfg) == want
    # and the port's own tree has the same structure and ranks
    meta = TTF.init_model(torch.Generator(), tcfg, "meta")

    def walk(t, a, path):
        if isinstance(t, dict):
            assert set(t) == set(a), path
            for k in t:
                walk(t[k], a[k], f"{path}.{k}")
        else:
            assert t.dim() == len(a), (path, tuple(t.shape), a)
    walk(meta, param_axes(tcfg), arch)


def cpu_mesh(shape):
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    with TM.force_device_count(math.prod(shape)):
        return TM.make_mesh(shape, axes, device="cpu")


def _weights(arch):
    cfg = TC.get_smoke(arch)
    return cfg, TTF.init_model(torch.Generator().manual_seed(3), cfg, "cpu")


PLACE = [(a, s, r) for a in ("yi-6b", "zamba2-2.7b", "granite-moe-1b-a400m",
                             "seamless-m4t-large-v2", "falcon-mamba-7b")
         for s in ((2, 2), (1, 4), (2, 1, 2)) for r in ("serve", "train")]


@pytest.mark.parametrize("arch,shape,rules", PLACE)
def test_place_then_gather_is_the_identity(arch, shape, rules):
    cfg, params = _weights(arch)
    mesh = cpu_mesh(shape)
    table = SH.SERVE_PARAM_RULES if rules == "serve" else \
        SH.TRAIN_PARAM_RULES
    placed = SH.place_params(params, param_axes(cfg), table, mesh)
    specs = SH.specs_for_tree(param_axes(cfg), table, mesh,
                              SH._tree_map(lambda t: tuple(t.shape), params))
    leaves = tree_leaves(params)
    placed_leaves = [leaf for leaf in _placed(placed)]
    spec_leaves = _specs(specs)
    assert len(placed_leaves) == len(leaves) == len(spec_leaves)
    for whole, leaf, spec in zip(leaves, placed_leaves, spec_leaves):
        assert leaf.spec[:len(spec)] == tuple(spec)
        cut = math.prod(int(mesh.shape[a]) for d in range(whole.dim())
                        for a in leaf.axes_of(d))
        assert len(leaf) == mesh.size
        seen = set()
        for key, t in leaf.items():
            assert t.numel() * t.element_size() == \
                whole.numel() * whole.element_size() // cut
            sl = tuple(slice(*leaf.range_of(d, key))
                       for d in range(whole.dim()))
            assert torch.equal(t, whole[sl])
            assert t.data_ptr() not in seen     # a copy of its own
            seen.add(t.data_ptr())
    back = SH.gather_params(placed, "cpu")
    for a, b in zip(leaves, tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _placed(tree):
    if isinstance(tree, SH.Placed):
        return [tree]
    return [x for v in tree.values() for x in _placed(v)]


def _specs(tree):
    if isinstance(tree, tuple):
        return [tree]
    return [x for v in tree.values() for x in _specs(v)]


def test_train_rules_cut_embed_over_data_and_serve_rules_do_not():
    cfg, params = _weights("yi-6b")
    mesh = cpu_mesh((2, 2))
    tr = SH.place_params(params, param_axes(cfg), SH.TRAIN_PARAM_RULES, mesh)
    sv = SH.place_params(params, param_axes(cfg), SH.SERVE_PARAM_RULES, mesh)
    assert tr["layers"]["attn"]["wq"].spec == (None, "data", "model", None)
    assert sv["layers"]["attn"]["wq"].spec == (None, None, "model", None)
    assert tr["embed"].spec == ("model", "data")
    assert sv["embed"].spec == ("model", None)
    # SMOKE yi-6b: kv heads 4 divide 'model' 2 (cut); over 8 they would not
    assert sv["layers"]["attn"]["wk"].axes_of(2) == ("model",)
    assert sv["layers"]["norm1"]["scale"].replicated_axes() == ("data",
                                                                "model")


# ---------------------------------------------------------- collectives
def _sh(mesh, fn):
    return CO.Shards({k: fn(k) for k in SH.coord_keys(mesh)})


def test_collectives_values_gradients_and_log():
    mesh = cpu_mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    base = {k: torch.randn(3, 4, generator=g) for k in SH.coord_keys(mesh)}
    x = CO.Shards({k: t.clone().requires_grad_(True) for k, t in
                   base.items()})
    with CO.recording() as log:
        s = CO.psum(x, mesh, "model", "t.psum")
        ga = CO.all_gather(x, mesh, ("data", "model"), 1, "t.gather")
        rs = CO.reduce_scatter(x, mesh, "data", 1, "t.rs")
        mx = CO.pmax(x, mesh, "data", "t.max")
        bc = CO.broadcast(torch.ones(2), mesh, "t.bc")
        loss = sum((s[k] * (i + 1)).sum() + ga[k].square().sum()
                   + rs[k].sum() * 3 for i, k in enumerate(s))
        grads = torch.autograd.grad(loss, [x[k] for k in x])
    keys = SH.coord_keys(mesh)
    for k in keys:
        grp = [q for q in keys if q[0] == k[0]]
        assert torch.equal(s[k], base[grp[0]] + base[grp[1]])
        assert torch.equal(ga[k], torch.cat([base[q] for q in keys], 1))
        col = [q for q in keys if q[1] == k[1]]
        tot = base[col[0]] + base[col[1]]
        assert torch.equal(rs[k], tot.chunk(2, 1)[k[0]])
        assert torch.equal(mx[k], torch.maximum(base[col[0]],
                                                base[col[1]]))
        assert torch.equal(bc[k], torch.ones(2))
    assert len({bc[k].data_ptr() for k in keys}) == 4
    # d loss / d x[k]: psum's transpose sums the weights over the model
    # group, the gather's is 2 x (summed over every member), the
    # reduce-scatter's a gather of 3s
    full = torch.cat([base[q] for q in keys], 1)
    for i, k in enumerate(keys):
        grp = [j for j, q in enumerate(keys) if q[0] == k[0]]
        want = sum(j + 1 for j in grp) * torch.ones(3, 4)
        j = keys.index(k)
        want = want + 2 * 4 * full[:, 4 * j:4 * (j + 1)] + 3
        assert torch.allclose(grads[i], want, atol=1e-6), k
    kinds = [(r.kind, r.origin) for r in log]
    assert kinds[:5] == [("all-reduce", "t.psum"), ("all-gather", "t.gather"),
                         ("reduce-scatter", "t.rs"), ("all-reduce", "t.max"),
                         ("broadcast", "t.bc")]
    assert ("all-reduce", "t.psum/grad") in kinds
    assert ("reduce-scatter", "t.gather/grad") in kinds
    assert ("all-gather", "t.rs/grad") in kinds
    by = {r.origin: r for r in log}
    assert by["t.psum"].nbytes == 48 and by["t.psum"].axes == ("model",)
    assert by["t.gather"].nbytes == 4 * 48
    assert by["t.rs"].nbytes == 24
    cb = collective_bytes(log)
    assert set(cb) == {"all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute", "total"}
    assert cb["total"] == sum(r.nbytes for r in log if r.kind != "broadcast")
    rows, agg = top_collectives(log, 3)
    assert rows[0][0] == 4 * 48 and len(rows) == 3
    assert agg[0][0] == ("all-gather", "t.gather")


def test_a_collective_over_an_axis_of_one_is_free():
    mesh = cpu_mesh((1, 4))
    x = _sh(mesh, lambda k: torch.full((2,), float(k[1])))
    with CO.recording() as log:
        out = CO.psum(x, mesh, "data", "noop")
    assert out is x and log == []


def test_sums_of_16_bit_types_are_taken_in_fp32_once():
    mesh = cpu_mesh((1, 4))
    vals = [1.0, 2 ** -9, 2 ** -9, 2 ** -9]
    x = CO.Shards({k: torch.tensor([v], dtype=torch.bfloat16)
                   for k, v in zip(SH.coord_keys(mesh), vals)})
    out = CO.psum(x, mesh, "model", "bf16")
    want = torch.tensor([sum(vals)], dtype=torch.float32).bfloat16()
    for t in out.values():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want)


# --------------------------------------------------------------- repairs
def test_mesh_flag_trains_as_without_a_mesh(tmp_path):
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-every", "100"]
    losses = {}
    for mesh in ("none", "single", "multi"):
        loop = TTR.main(argv + ["--mesh", mesh, "--ckpt-dir",
                                str(tmp_path / mesh)])
        losses[mesh] = [float(h["loss"]) for h in loop.history]
    assert len(losses["none"]) == 3
    assert losses["single"] == losses["none"] == losses["multi"]


def test_unroll_gives_the_same_results():
    cfg, params = _weights("zamba2-2.7b")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "loss_mask": torch.ones(2, 16)}
    with torch.no_grad():
        lf, cf = TTF.prefill(params, cfg, {"tokens": batch["tokens"]},
                             unroll=False)
        lt, ct = TTF.prefill(params, cfg, {"tokens": batch["tokens"]},
                             unroll=True)
        assert torch.equal(lf, lt)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cf),
                                                     tree_leaves(ct)))
        a, _ = TTF.train_loss(params, cfg, batch, unroll=False)
        b, _ = TTF.train_loss(params, cfg, batch, unroll=True)
        assert torch.equal(a, b)
    out = []
    for unroll in (False, True):
        p = {k: v for k, v in _weights("zamba2-2.7b")[1].items()}
        step = make_train_step(cfg, remat="full", unroll=unroll)
        _, _, m = step(p, adamw_init(p), batch, 1)
        out.append((float(m["loss"]), [t.clone() for t in tree_leaves(p)]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
