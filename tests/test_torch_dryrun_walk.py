"""The dry run's walks (``repro_torch.launch.dryrun``, ``roofline/cost.py``)
on the CPU, at SMOKE size over ``make_debug_mesh(2, 4)`` on ``meta``,
with no reference (tests/test_torch_dryrun.py holds the records against
the reference's):

* ``two_point_costs`` equals the walk of the whole depth, exactly, and
  every coordinate counts the same FLOPs and argument bytes;
* the meta walk's FLOPs, bytes moved, argument bytes, kernel calls and
  collective log equal the same placed step run on CPU tensors over a CPU
  debug mesh (the kernels' wrappers then take the kernel's route, their
  plain versions computing uncounted);
* the model kernels' wrappers on meta tensors allocate their outputs,
  launch nothing and hand their reckoning to the counter; every device
  but CPU, CUDA and meta is refused;
* a step over a plan mesh raises outside ``walking()``;
* the command line writes the reference's record of a skipped cell.
"""
import json
import math
import subprocess
import sys
import types

import pytest
import torch

import _torch_dryrun as D
from repro_torch import configs as TC
from repro_torch.configs import shapes as SH
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import param_axes
from repro_torch.parallel import sharding as SHD
from repro_torch.roofline.cost import CostCounter


@pytest.fixture(scope="module")
def small():
    saved = dict(SH.SHAPES)
    for name, (s, b) in D.SHAPES.items():
        SH.SHAPES[name] = SH.ShapeSpec(name, s, b, SH.SHAPES[name].kind)
    yield TM.make_debug_mesh(*D.MESH, device="meta")
    SH.SHAPES.clear()
    SH.SHAPES.update(saved)


@pytest.mark.parametrize("arch", D.ARCHS)
def test_two_point_costs_equal_the_whole_depth(small, arch):
    cfg = TC.get_smoke(arch)
    shape = SH.SHAPES["train_4k"]
    _, ng, _ = TTF.scan_layout(cfg)
    tp = DR.two_point_costs(
        lambda c: DR.lower_train(c, shape, small, True), cfg, ng)
    whole, extra = DR.lower_train(cfg, shape, small, True)
    s = extra["cost_scale"]
    assert tp["flops"] == whole.cost["flops"] * s
    assert tp["bytes"] == whole.cost["bytes"] * s
    assert tp["coll"] == {k: int(v * s) for k, v in
                          whole.collectives().items()}
    assert whole.cost["spread"]["flops"][0] == whole.cost["spread"][
        "flops"][1]
    assert whole.cost["spread"]["argument_bytes"][0] == whole.cost[
        "spread"]["argument_bytes"][1]


def _cpu_mesh():
    with TM.force_device_count(math.prod(D.MESH)):
        return TM.make_mesh(D.MESH, ("data", "model"), device="cpu")


def _cpu_walk(cfg, shape, mesh):
    """The cell's step on CPU tensors (the port's own weights) under the
    same counter, through the walks the dry run takes on meta."""
    params = TTF.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    rules = (SHD.TRAIN_PARAM_RULES if shape.kind == "train"
             else SHD.SERVE_PARAM_RULES)
    pl = SHD.place_params(params, param_axes(cfg), rules, mesh)
    if shape.kind == "decode":
        return DR.decode_walk(cfg, shape, pl, mesh)[0]
    tp = SHD.TP.for_batch(mesh, shape.global_batch)
    specs = (SH.train_specs if shape.kind == "train"
             else SH.prefill_specs)(cfg, shape)
    batch = {k: tp.scatter(torch.zeros(tuple(v.shape), dtype=v.dtype))
             for k, v in specs.items()}
    if shape.kind == "train":
        return DR.train_walk(cfg, pl, batch, mesh)
    with SHD.axis_rules(SHD.DEFAULT_RULES, mesh):
        return DR.walk(lambda: TTF.prefill(pl, cfg, batch), (pl, batch),
                       mesh)


@pytest.mark.parametrize("arch,kind", [
    ("yi-6b", "train_4k"), ("yi-6b", "prefill_32k"), ("yi-6b", "decode_32k"),
    ("zamba2-2.7b", "train_4k"), ("granite-moe-1b-a400m", "train_4k")])
def test_meta_walk_counts_what_the_cpu_step_counts(small, arch, kind):
    cfg = TC.get_smoke(arch)
    shape = SH.SHAPES[kind]
    meta, _ = DR._lower(shape.kind)(cfg, shape, small, True)
    cpu = _cpu_walk(cfg, shape, _cpu_mesh())
    for f in ("flops", "bytes", "argument_bytes"):
        assert meta.cost[f] == cpu.cost[f], f
    assert [(r.kind, r.axes, r.nbytes, r.origin) for r in meta.log] == [
        (r.kind, r.axes, r.nbytes, r.origin) for r in cpu.log]
    assert meta.cost["kernel_calls"] == cpu.cost["kernel_calls"]


def test_wrappers_on_meta_allocate_reckon_and_launch_nothing():
    meta = dict(device="meta")
    q = torch.empty((2, 4, 96, 16), **meta)
    k = torch.empty((2, 2, 96, 16), **meta)
    arena = torch.empty((9, 2, 16, 2, 16), **meta)
    pages = torch.zeros((2, 4), dtype=torch.int32, **meta)
    lens = torch.zeros((2,), dtype=torch.int32, **meta)
    x = torch.empty((1, 130, 2, 8), **meta)
    f32 = [torch.empty((1, 130, 2), **meta), torch.empty((1, 130, 2), **meta),
           torch.empty((1, 130, 4), **meta), torch.empty((1, 130, 4), **meta)]
    _build.reset_launches()
    with CostCounter() as c:
        o = FA.flash_attention(q, k, k, scale=0.25, window=8)
        dq, dk, dv = FA.flash_attention_bwd(
            q, k, k, o, torch.empty((2, 4, 96), **meta), o, scale=0.25)
        out, lse = PA.paged_attention(q[:, :, 0], arena, pages, lens,
                                      scale=0.25, return_lse=True)
        y, h = MS.mamba2_scan(x, *f32)
    assert all(n == 0 for n in _build.launches.values())
    assert o.shape == q.shape and dk.shape == k.shape
    assert out.dtype == torch.float32 and lse.shape == (2, 4)
    assert y.shape == x.shape and h.shape == (1, 2, 8, 4)
    assert dict(c.kernel_calls) == {
        "flash_attention": 1, "flash_attention_bwd_delta": 1,
        "flash_attention_bwd_dkdv": 1, "flash_attention_bwd_dq": 1,
        "paged_attention_lse": 1, "mamba2_scan": 1}
    want = (FA.flash_cost(2, 4, 2, 96, 96, 16, 4, window=8)[0]
            + sum(FA.flash_bwd_cost(n, 2, 4, 2, 96, 96, 16, 4)[0]
                  for n in ("flash_attention_bwd_delta",
                            "flash_attention_bwd_dkdv",
                            "flash_attention_bwd_dq"))
            + PA.paged_cost(2, 4, 2, 16, 16, 4, 4, lse=True)[0]
            + MS.scan_cost(1, 130, 2, 8, 4, 4, h0=False)[0])
    assert c.flops[None] == want


def test_wrappers_refuse_other_devices():
    fake = types.SimpleNamespace(device=torch.device("xpu"))
    for kernel in ("flash_attention", "paged_attention", "mamba2_scan"):
        with pytest.raises(RuntimeError):
            _build.require_cuda(fake, kernel, meta=True)
    with pytest.raises(RuntimeError):   # the CPU only under a counter
        _build.require_cuda(torch.empty(1), "flash_attention", meta=True)


def test_a_plan_mesh_runs_steps_only_in_a_walk():
    mesh = TM.make_production_mesh()
    with pytest.raises(RuntimeError, match="walking"):
        mesh.require_runnable("a step")
    with TM.walking():
        mesh.require_runnable("a step")


def test_command_line_writes_the_skip_record(tmp_path):
    env = {"PYTHONPATH": str(D.__file__).rsplit("/tests/", 1)[0] + "/src"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads((tmp_path / "yi-6b__long_500k__single.json").read_text())
    assert rec["status"] == "skip" and "skip" in out.stdout
