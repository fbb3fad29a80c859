"""Sequence sharding of the residual stream (``"seq": ("model",)``)
combined with the two placed variants, against the JAX reference on the
CPU. Both combinations run in the reference's placed step on jax 0.9
(``tests/_torch_tp.py ... seq_combos`` records their status), so the port
runs them too:

* gemma2-2b SMOKE with ``attn_seq_shard`` (the sequence-parallel island
  inside a residual stream cut over 'model': the island's slice is the
  coordinate's own, so with ``wo`` whole no ``all_gather`` joins it);
* granite-moe SMOKE with ``REPRO_MOE_RAGGED=1`` (the experts' combine is
  reduce-scattered along the sequence).

Each over (2, 2) with ``TRAIN_PARAM_RULES``, remat full: the loss within
1e-5 and every gradient leaf within 1e-4 of its largest entry against the
reference's and against the port's placed step without the ``seq`` rule.
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
from repro_torch.models.params import param_axes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SHD
from repro_torch.training.step import make_loss_grad_fn

SEQ_RULES = dict(SHD.DEFAULT_RULES, seq=("model",))
CASES = {"seqpar": (T.SEQPAR_ARCH, True, None),
         "ragged": (T.RAGGED_ARCH, False, "1")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return T.run_reference(str(tmp_path_factory.mktemp("sac") / "r.npz"),
                           part="seq_combos")


def close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: {err} > {bound}"


def _step(cfg, params, batch, rules):
    with TM.force_device_count(4):
        mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    pl = SHD.place_params(params, param_axes(cfg), SHD.TRAIN_PARAM_RULES,
                          mesh)
    with SHD.axis_rules(rules, mesh), CO.recording() as log:
        (loss, _), g = make_loss_grad_fn(cfg, remat="full")(pl, batch)
    return float(loss), SHD.gather_params(g, "cpu"), log


@pytest.mark.parametrize("tag", list(CASES))
def test_combination_matches_the_reference(ref, tag):
    arch, seqpar, ragged = CASES[tag]
    assert str(ref[f"seq_act/{tag}/status"]) == "ok"
    cfg = TC.get_smoke(arch)
    if seqpar:
        cfg = dataclasses.replace(cfg, attn_seq_shard=True)
    params = convert.params_from_numpy(
        cfg, M.unflatten(ref, f"seq_act/{tag}/weights"), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             T.train_batch(arch, cfg.vocab).items()}
    if ragged:
        os.environ["REPRO_MOE_RAGGED"] = ragged
    try:
        loss, grads, log = _step(cfg, params, batch, SEQ_RULES)
        lw, gw, _ = _step(cfg, params, batch, SHD.DEFAULT_RULES)
    finally:
        os.environ.pop("REPRO_MOE_RAGGED", None)
    assert abs(loss - float(ref[f"seq_act/{tag}/loss"])) <= 1e-5
    assert abs(loss - lw) <= 1e-5
    want = convert.params_from_numpy(
        cfg, M.unflatten(ref, f"seq_act/{tag}/grads"), "cpu")
    for a, b, c in zip(tree_leaves(grads), tree_leaves(want),
                       tree_leaves(gw)):
        close(a, b, 1e-4, f"{tag} gradient leaf")
        close(a, c, 1e-4, f"{tag} gradient leaf against no rule")
    assert any(r.kind == "reduce-scatter" and r.axes == ("model",)
               for r in log)
    if seqpar:   # the island's all-to-alls, and no join of its slices
        assert any(r.kind == "all-to-all" for r in log)
        assert not any(r.origin.endswith(".attn.seq") for r in log)
    else:
        assert any(r.origin.endswith(".mlp.experts") and
                   r.kind == "reduce-scatter" for r in log)
    assert math.isfinite(loss)
