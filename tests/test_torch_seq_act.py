"""Sequence sharding of the residual stream (``REPRO_SEQ_ACT=model``: the
rule ``"seq": ("model",)``) in the port's placed train step, against the
JAX reference on the CPU.

* gemma2-2b and zamba2-2.7b SMOKE, weights placed by ``TRAIN_PARAM_RULES``
  over (2, 2), remat full, under ``axis_rules({**DEFAULT_RULES, "seq":
  ("model",)}, mesh)``: the loss within 1e-5 and every gradient leaf within
  1e-4 of its largest entry against the reference's placed step under the
  same rules (a fresh ``jax.jit``: ``tests/_torch_tp.py ... seq_act``) and
  against the port's placed step without the rule.
* The collective log: the residual stream's ``all-reduce`` s over 'model'
  (the embedding lookup, ``wo``, ``w_down``, ``out_proj``; forward and
  backward) are gone; an ``all-gather`` over 'model' joins each sublayer's
  normed input and a ``reduce-scatter`` over 'model' cuts its output.
* The dry run under ``REPRO_SEQ_ACT=model`` (gemma2-2b ``train_4k`` at
  SMOKE, seq 64, batch 8, over a (2, 4) plan): its record's status, keys,
  ``model_flops_total`` and argument bytes against the reference's
  ``run_cell`` under the same variable (``tests/_torch_dryrun.py ...
  seq_act``), and its peak temporary bytes a device below the walk's
  without the rule.
"""
import os
import pathlib

import numpy as np
import pytest

import _torch_dryrun as D
import _torch_mesh as M
import _torch_tp as T
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.configs import shapes as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TM
from repro_torch.models.params import param_axes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SHD
from repro_torch.training.step import make_loss_grad_fn

SEQ_RULES = dict(SHD.DEFAULT_RULES, seq=("model",))
RESIDUAL = (".wo", ".w_down", ".out_proj", "embed.lookup", ".experts")


@pytest.fixture(scope="module")
def dr_child(tmp_path_factory):
    """The reference's dry-run cell, started first (it runs while the
    train-step child and the port work)."""
    return D.start_reference(
        str(tmp_path_factory.mktemp("sad") / "r.json"),
        archs=("gemma2-2b",), variant="seq_act")


@pytest.fixture(scope="module")
def ref(dr_child, tmp_path_factory):
    return T.run_reference(str(tmp_path_factory.mktemp("sa") / "r.npz"),
                           part="seq_act")


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


@pytest.fixture(scope="module")
def steps(ref):
    import torch
    out = {}
    for arch in T.SEQ_ACT_ARCHS:
        cfg = TC.get_smoke(arch)
        params = convert.params_from_numpy(
            cfg, M.unflatten(ref, f"seq_act/{arch}/weights"), "cpu")
        batch = {k: torch.from_numpy(v) for k, v in
                 T.train_batch(arch, cfg.vocab).items()}
        out[arch] = (cfg, _step(cfg, params, batch, SEQ_RULES),
                     _step(cfg, params, batch, SHD.DEFAULT_RULES))
    return out


@pytest.mark.parametrize("arch", T.SEQ_ACT_ARCHS)
def test_seq_sharded_step_matches_the_reference(ref, steps, arch):
    cfg, (loss, grads, _), _ = steps[arch]
    assert str(ref[f"seq_act/{arch}/status"]) == "ok"
    assert abs(loss - float(ref[f"seq_act/{arch}/loss"])) <= 1e-5
    want = convert.params_from_numpy(
        cfg, M.unflatten(ref, f"seq_act/{arch}/grads"), "cpu")
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        close(a, b, 1e-4, f"{arch} gradient leaf")


@pytest.mark.parametrize("arch", T.SEQ_ACT_ARCHS)
def test_seq_sharded_step_matches_the_step_without_the_rule(steps, arch):
    _, (loss, grads, _), (lw, gw, _) = steps[arch]
    assert abs(loss - lw) <= 1e-5
    for a, b in zip(tree_leaves(grads), tree_leaves(gw)):
        close(a, b, 1e-4, f"{arch} gradient leaf against no rule")


@pytest.mark.parametrize("arch", T.SEQ_ACT_ARCHS)
def test_residual_psums_become_gathers_and_reduce_scatters(steps, arch):
    _, (_, _, log), (_, _, log_w) = steps[arch]

    def residual(rec):
        return rec.axes == ("model",) and any(
            rec.origin.split("/")[0].endswith(o) for o in RESIDUAL)
    assert any(r.kind == "all-reduce" and residual(r) for r in log_w)
    assert not any(r.kind == "all-reduce" and residual(r) for r in log)
    rs = [r for r in log if r.kind == "reduce-scatter"
          and r.axes == ("model",)]
    ag = [r for r in log if r.kind == "all-gather" and r.axes == ("model",)]
    assert any(r.origin.endswith(".attn.wo") or r.origin.endswith(
        ".mamba.out_proj") for r in rs)
    assert any(r.origin.endswith(".seq_in") for r in ag)
    assert any(r.origin == "final_norm.seq" for r in ag)
    # the backward's transposes: a gather's gradient is a reduce-scatter
    assert any(r.origin.endswith(".seq_in/grad") for r in rs)
    assert any(r.origin.endswith(".wo/grad") for r in ag)


@pytest.fixture(scope="module")
def small():
    saved = dict(SH.SHAPES), TC.get_config
    for name, (s, b) in D.SHAPES.items():
        SH.SHAPES[name] = SH.ShapeSpec(name, s, b, SH.SHAPES[name].kind)
    TC.get_config = TC.get_smoke
    yield TM.make_debug_mesh(*D.MESH, device="meta")
    SH.SHAPES.clear()
    SH.SHAPES.update(saved[0])
    TC.get_config = saved[1]


@pytest.fixture(scope="module")
def walked(small, tmp_path_factory):
    out = tmp_path_factory.mktemp("sap")
    recs = {}
    for env in ("", "model"):
        if env:
            os.environ["REPRO_SEQ_ACT"] = env
        try:
            recs[env] = DR.run_cell("gemma2-2b", "train_4k", multi_pod=False,
                                    out_dir=pathlib.Path(out), unroll=False,
                                    mesh=small)
        finally:
            os.environ.pop("REPRO_SEQ_ACT", None)
    return recs


def test_dry_run_record_matches_the_reference(dr_child, ref, walked):
    want = D.load_reference(dr_child)["gemma2-2b/train_4k"]
    got = walked["model"]
    assert got["status"] == want["status"] == "ok", got.get("error")
    assert (set(got) - {"fits_hbm", "hbm_bytes", "time"}
            == set(want) - {"fits_16g_hbm", "time"})
    assert got["model_flops_total"] == want["model_flops_total"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert got.get("microbatches") == want.get("microbatches")
    print(f"seq -> model: collective bytes a device "
          f"{got['collective_bytes_per_device']} (reference HLO "
          f"{want['collective_bytes_per_device']}), temp "
          f"{got['temp_size_in_bytes']} (reference "
          f"{want['temp_size_in_bytes']})")


def test_dry_run_peak_falls_and_psums_move(walked):
    base, seq = walked[""], walked["model"]
    assert seq["temp_size_in_bytes"] < base["temp_size_in_bytes"]
    cb, cs = (base["collective_bytes_per_device"],
              seq["collective_bytes_per_device"])
    assert cs["all-reduce"] < cb["all-reduce"]
    assert cs["all-gather"] > cb["all-gather"]
    assert cs["reduce-scatter"] > cb["reduce-scatter"]
