"""The two placed variants the dry run needs against the JAX reference's
placed steps on the CPU (the reference over an Auto (2, 2) mesh under
``axis_rules(DEFAULT_RULES, mesh)``, in one child process:
``tests/_torch_tp.py ... variants``).

* Sequence-parallel attention (gemma2-2b SMOKE, ``attn_seq_shard``): the
  placed train loss within 1e-5 and every gradient leaf within 1e-4 of its
  largest entry (``TRAIN_PARAM_RULES``, remat full); the step issues an
  ``all-to-all`` (q's heads traded for its sequence slice and back) and
  ``all-gather`` s of K/V, as the reference's compiled step does around its
  island; over (1, 8), where 'model' does not divide the heads, the
  mesh-free step's loss and gradients (the slices joined by an
  ``all_gather``); the placed prefill's logits within 1e-5 of the largest (the
  reference's prefill keeps its KV and takes no island: neither does the
  port's).
* The ragged MoE dispatch (granite-moe SMOKE, ``REPRO_MOE_RAGGED=1``): the
  placed train loss within 1e-5 and every gradient leaf within 1e-4 of its
  largest entry over (2, 2) and (4, 1); the same step over (1, 4) (the
  experts cut, the batch whole) against the port's mesh-free ragged step;
  and one layer whose router overflows expert 0's buffer, placed over
  (2, 2), (4, 1) and (2, 1), against the mesh-free dispatch: the capacity
  of the global token count and the global running count drop the same
  tokens.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import _torch_mesh as M
import _torch_tp as T
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import param_axes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SH
from repro_torch.training.step import make_loss_grad_fn


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return T.run_reference(str(tmp_path_factory.mktemp("tpv") / "r.npz"),
                           part="variants")


def cpu_mesh(shape):
    with TM.force_device_count(math.prod(shape)):
        return TM.make_mesh(shape, ("data", "model"), device="cpu")


def close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: {err} > {bound}"


def _case(ref, tag, arch, cfg_of=lambda c: c):
    cfg = cfg_of(TC.get_smoke(arch))
    params = convert.params_from_numpy(
        cfg, M.unflatten(ref, f"{tag}/weights"), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             T.train_batch(arch, cfg.vocab).items()}
    return cfg, params, batch


def _placed_grads(cfg, params, batch, shape, rules=SH.TRAIN_PARAM_RULES):
    pl = SH.place_params(params, param_axes(cfg), rules, cpu_mesh(shape))
    with CO.recording() as log:
        (loss, _), g = make_loss_grad_fn(cfg, remat="full")(pl, batch)
    return float(loss), SH.gather_params(g, "cpu"), log


def _seqpar(c):
    return dataclasses.replace(c, attn_seq_shard=True)


def test_placed_seqpar_train_matches_the_reference(ref):
    cfg, params, batch = _case(ref, "seqpar", T.SEQPAR_ARCH, _seqpar)
    loss, grads, log = _placed_grads(cfg, params, batch, (2, 2))
    assert abs(loss - float(ref["seqpar/loss"])) <= 1e-5
    want = M.unflatten(ref, "seqpar/grads")
    for a, b in zip(tree_leaves(grads), tree_leaves(
            convert.params_from_numpy(cfg, want, "cpu"))):
        close(a, b, 1e-4, "seqpar gradient leaf")
    kinds = {r.kind for r in log if ".attn." in r.origin}
    assert {"all-to-all", "all-gather"} <= kinds, kinds


def test_placed_seqpar_with_whole_heads_matches_the_mesh_free_step(ref):
    """Over (1, 8) the 4 heads do not divide 'model', so the rules keep
    the attention weights whole (gemma2-2b's case at 16 x 16): each
    coordinate slices its queries in place and the projected slices are
    joined by an ``all_gather``; loss within 1e-5 and every gradient leaf
    within 1e-4 of the mesh-free step's."""
    cfg, params, batch = _case(ref, "seqpar", T.SEQPAR_ARCH, _seqpar)
    loss, grads, log = _placed_grads(cfg, params, batch, (1, 8))
    (lf, _), gf = make_loss_grad_fn(cfg, remat="full")(params, batch)
    assert abs(loss - float(lf)) <= 1e-5
    for a, b in zip(tree_leaves(grads), tree_leaves(gf)):
        close(a, b, 1e-4, "seqpar gradient leaf, whole heads")
    assert any(r.origin.endswith(".attn.seq") for r in log)


def test_placed_seqpar_prefill_matches_the_reference(ref):
    cfg, params, batch = _case(ref, "seqpar", T.SEQPAR_ARCH, _seqpar)
    pl = SH.place_params(params, param_axes(cfg), SH.SERVE_PARAM_RULES,
                         cpu_mesh((2, 2)))
    logits, _ = TTF.prefill(pl, cfg, {"tokens": batch["tokens"]})
    close(logits, ref["seqpar/prefill"], 1e-5, "seqpar prefill logits")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_placed_ragged_moe_train_matches_the_reference(ref, shape):
    cfg, params, batch = _case(ref, "ragged", T.RAGGED_ARCH)
    os.environ["REPRO_MOE_RAGGED"] = "1"
    try:
        loss, grads, _ = _placed_grads(cfg, params, batch, shape)
    finally:
        os.environ.pop("REPRO_MOE_RAGGED")
    assert abs(loss - float(ref["ragged/loss"])) <= 1e-5
    want = convert.params_from_numpy(
        cfg, M.unflatten(ref, "ragged/grads"), "cpu")
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        close(a, b, 1e-4, f"ragged gradient leaf over {shape}")


def test_placed_ragged_moe_drops_tokens_as_the_mesh_free_one(ref):
    """Over (1, 4) every coordinate holds one of the 4 experts and the
    whole batch: the loss and gradients of the mesh-free ragged step."""
    cfg, params, batch = _case(ref, "ragged", T.RAGGED_ARCH)
    os.environ["REPRO_MOE_RAGGED"] = "1"
    try:
        loss, grads, _ = _placed_grads(cfg, params, batch, (1, 4))
        (lf, _), gf = make_loss_grad_fn(cfg, remat="full")(params, batch)
    finally:
        os.environ.pop("REPRO_MOE_RAGGED")
    assert abs(loss - float(lf)) <= 1e-5
    for a, b in zip(tree_leaves(grads), tree_leaves(gf)):
        close(a, b, 1e-4, "ragged gradient leaf, mesh-free")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 1)])
def test_ragged_layer_drops_the_tokens_the_global_capacity_drops(shape):
    """One MoE layer whose router sends every token to expert 0 (its
    column positive, the input's mean positive), so that expert 0's buffer
    overflows: the placed
    dispatch (the batch cut over 'data', the experts over 'model') gives
    the mesh-free dispatch's output and aux loss within 1e-5, the drops
    following the global running count across the batch slices."""
    from repro_torch.models.layers import moe as MOE
    cfg = TC.get_smoke(T.RAGGED_ARCH)
    g = torch.Generator().manual_seed(3)
    p = MOE.init_moe(g, cfg, "cpu")
    p["router"][:, 0] = 0.5    # with x's positive mean: expert 0 first
    x = torch.randn((4, 32, cfg.d_model), generator=g) + 1.0
    want, aux_w = MOE.moe_forward_ragged(p, cfg, x)
    n = x.shape[0] * x.shape[1]
    cap = min(max(8, int(MOE.CAPACITY_FACTOR * n * cfg.top_k
                         / cfg.n_experts)), n)
    _, _, topi = MOE._route(p, cfg, x.reshape(n, -1))
    assert int(torch.bincount(topi.reshape(-1)).max()) > cap
    mesh = cpu_mesh(shape)
    axes = {k: v for k, v in param_axes(cfg)["layers"]["mlp"].items()}
    specs = SH.specs_for_tree({k: v[1:] for k, v in axes.items()},
                              SH.TRAIN_PARAM_RULES, mesh,
                              {k: tuple(t.shape) for k, t in p.items()})
    P = {k: SH.split_by_spec(t, specs[k], mesh) for k, t in p.items()}
    tp = SH.TP.for_batch(mesh, x.shape[0])
    P = tp.use_tree(P, "mlp")
    out, aux = MOE.moe_ragged_tp(P, cfg, tp.scatter(x), tp, origin="mlp")
    close(tp.join_batch(out), want, 1e-5, f"ragged layer over {shape}")
    assert abs(float(aux[tp.keys[0]]) - float(aux_w)) <= 1e-5
