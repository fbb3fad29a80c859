"""Multi-pod dry run (port of ``repro.launch.dryrun``): walk every (arch x
shape x mesh) cell's placed step over the production mesh on the ``meta``
device, count it, and write the reference's JSON record per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]

Nothing is lowered or launched and no card is needed. Where the reference
lowers and compiles a step and reads XLA's memory and cost analyses, the
port runs its own placed step (``models/transformer.*_tp``,
``serving/engine`` over a mesh, ``training/step``) on meta tensors inside
:func:`~repro_torch.launch.mesh.walking`, under a cost counter
(``roofline/cost.py``) and a collective log
(``parallel/collectives.recording``): a *walk*. It counts each mesh
coordinate's FLOPs, bytes moved, peak temporary bytes and argument bytes
(one coordinate's figures are the per-device figures, after the check
that every coordinate counts the same), and the collective bytes by kind.
The same step on the card under the same counter counts the same
(``chip_smoke.py`` phase ``dryrun``).

The functions and names are the reference's: :func:`batch_specs`,
:func:`pick_microbatches` (``REPRO_MB`` kept; the per-microbatch
temporary is the walk's own reading, extrapolated from one and two scan
groups, and the budget is the card's memory less the arguments),
:func:`lower_train` / :func:`lower_prefill` / :func:`lower_decode`
(``unroll=True``: the cost walk of ONE microbatch at a global batch cut
to ``gb``, whose costs scale by ``cost_scale``; ``unroll=False``: the
production step with its real microbatch count, the memory-fit walk),
:func:`shrink_to_groups`, :func:`two_point_costs` (costs are additive in
scan groups, as in the reference), :data:`VARIANTS`, :func:`run_cell` and
:func:`main`. The record writes ``fits_hbm`` and ``hbm_bytes`` (the
card's memory, ``roofline/analysis.CARDS``) in place of the reference's
``fits_16g_hbm``, and its roofline terms use the card's figures
(``--card``, default the H100). ``REPRO_SEQ_ACT=model`` (the reference's
Megatron-style sequence sharding of the residual stream) walks the train
step under ``"seq": ("model",)`` (``models/transformer.train_loss_tp``):
the residual stream's ``psum`` s over 'model' become an ``all-gather``
before each sublayer and a ``reduce-scatter`` after it; prefill and decode
keep ``DEFAULT_RULES``, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import time
import traceback

import numpy as np
import torch
from torch.utils import checkpoint as CK

from repro_torch import configs
from repro_torch.configs import shapes as SH
from repro_torch.launch.mesh import make_production_mesh, walking
from repro_torch.models import transformer as TF
from repro_torch.models.params import param_axes
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SHD
from repro_torch.roofline.analysis import (collective_bytes, hw_for,
                                           model_flops_per_step,
                                           roofline_terms)
from repro_torch.roofline.cost import CostCounter
from repro_torch.training.step import make_train_step

DEFAULT_CARD = "NVIDIA H100 80GB HBM3"
# the reference passes the step number as an int32 scalar and keeps AdamW's
# count as one, both replicated on every device: 8 argument bytes a device
# (the port's step is a host int and its count one tensor)
STEP_SCALARS = 8


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in _dp_axes(mesh))


def batch_specs(mesh, tree, batch: int) -> dict:
    """Each batch leaf's spec: dim 0 over the DP axes where ``batch``
    divides them, else replicated (the reference's NamedShardings, as the
    port's spec tuples)."""
    dp = _dp_axes(mesh)
    ok = batch % _dp_size(mesh) == 0
    first = SHD.spec_entry(dp) if ok and dp else None
    return {k: (first,) + (None,) * (len(v.shape) - 1)
            for k, v in tree.items()}


# --------------------------------------------------------------- a walk
@dataclasses.dataclass
class Walked:
    """A step walked over a mesh: what the reference reads from its
    compiled step (``cost_analysis``, ``memory_analysis``, the collectives
    of its HLO), for one device, and each coordinate's counts."""

    cost: dict            # CostCounter.summary of the reporting coordinate
    per_coord: dict       # CostCounter.per_coord
    log: list             # the collective Records
    seconds: float
    ops: int              # aten ops dispatched
    # argument bytes a device that the reference's arguments lack: the
    # paged arenas' scratch row a coordinate (the island's dropped writes)
    scratch_bytes: int = 0

    def cost_analysis(self) -> dict:
        return {"flops": self.cost["flops"],
                "bytes accessed": self.cost["bytes"]}

    def memory_analysis(self) -> dict:
        return {"temp_size_in_bytes": self.cost["peak_temp_bytes"],
                "argument_size_in_bytes": self.cost["argument_bytes"],
                "output_size_in_bytes": 0,
                "generated_code_size_in_bytes": 0}

    def collectives(self) -> dict:
        return collective_bytes(self.log)


def walk(run, arguments, mesh, *, extra_args: int = 0) -> Walked:
    """Run ``run()`` (a step over ``mesh``: meta tensors over a plan, or a
    runnable mesh's own) under a cost counter and a collective log, with
    ``arguments`` (a tree of Shards / tensors) counted as the step's
    arguments and ``extra_args`` bytes more at every coordinate. It runs
    inside :func:`walking`, and with the checkpoint's early stop off: a
    unit's recompute then runs whole at every coordinate, where the early
    stop would skip the trailing products of the last coordinate alone
    (an artifact of one process driving every coordinate)."""
    keys = SHD.coord_keys(mesh)
    counter = CostCounter()
    counter.arguments(arguments)
    for k in keys:
        counter.args[k] += extra_args
    t0 = time.perf_counter()
    with walking(), CK.set_checkpoint_early_stop(False), \
            CO.recording() as log, counter:
        run()
    seconds = time.perf_counter() - t0
    return Walked(counter.summary(keys), counter.per_coord(), list(log),
                  seconds, counter.ops)


def _zeros_like_specs(specs: dict, device) -> dict:
    return {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in specs.items()}


def _placed(cfg, rules, mesh):
    """Parameters placed by ``rules`` over a plan ``mesh``, made on its
    ``meta`` entries (a walk reads no value)."""
    if not mesh.is_plan:
        raise ValueError("a walk's own parameters are made over a plan mesh "
                         "only; pass placed parameters for a runnable one")
    params = TF.init_model(torch.Generator().manual_seed(0), cfg, "meta")
    specs = SHD.specs_for_tree(param_axes(cfg), rules, mesh,
                               SHD._tree_map(lambda t: tuple(t.shape),
                                             params))
    return SHD._tree_map(lambda t, sp: SHD.zeros_by_spec(
        t.shape, t.dtype, sp, mesh), params, specs)


# ----------------------------------------------------------- the steps
def _probe_temp(cfg, shape: SH.ShapeSpec, mesh) -> tuple[float, int]:
    """(the per-device temporary of one microbatch of the whole local
    batch at ``cfg``'s depth, the argument bytes): the cost walks of one
    and two scan groups, extrapolated (a walk of remat=full stores one
    residual a layer, so its peak grows by the same step a group)."""
    _, ng, _ = TF.scan_layout(cfg)
    temps, arg = {}, 0
    for k in sorted({1, min(2, max(ng, 1))}):
        w = _train_walk(shrink_to_groups(cfg, k), shape, mesh, 1)
        temps[k] = w.cost["peak_temp_bytes"]
        arg = w.cost["argument_bytes"]
    t1 = temps[min(temps)]
    t2 = temps[max(temps)]
    return t1 + (max(ng, 1) - 1) * (t2 - t1), arg


def pick_microbatches(cfg, shape: SH.ShapeSpec, mesh, *,
                      card: str = DEFAULT_CARD) -> int:
    """The smallest power-of-two microbatch count whose per-microbatch
    temporary (:func:`_probe_temp`, the walk's own reading) fits the
    card's memory less the arguments; ``REPRO_MB`` overrides (the
    reference's perf-iteration knob)."""
    if os.environ.get("REPRO_MB"):
        return int(os.environ["REPRO_MB"])
    b_local = max(shape.global_batch // _dp_size(mesh), 1)
    act, arg = _probe_temp(cfg, shape, mesh)
    budget = hw_for(card).hbm_bytes - arg
    mb = 1
    while act / mb > budget and mb < b_local:
        mb *= 2
    return mb


def _act_rules():
    """Activation rules (the reference's variant hook):
    ``REPRO_SEQ_ACT=model`` turns on Megatron-style sequence sharding of
    the residual stream over 'model' (``train_loss_tp`` reads the rule)."""
    rules = dict(SHD.DEFAULT_RULES)
    if os.environ.get("REPRO_SEQ_ACT") == "model":
        rules["seq"] = ("model",)
    return rules


_walks: dict = {}   # (cfg, shape, mesh, microbatches) -> Walked


def _train_walk(cfg, shape: SH.ShapeSpec, mesh, mb: int) -> Walked:
    """The train step's walk (each (cfg, shape, mesh, mb) walked once a
    process: the microbatch probe and the cost probe share walks)."""
    key = (cfg, shape, tuple(mesh.shape.items()), str(mesh.home), mb,
           os.environ.get("REPRO_MOE_RAGGED"),
           os.environ.get("REPRO_SEQ_ACT"))
    if key not in _walks:
        _walks[key] = _walk_train(cfg, shape, mesh, mb)
    return _walks[key]


def _walk_train(cfg, shape: SH.ShapeSpec, mesh, mb: int) -> Walked:
    placed = _placed(cfg, SHD.TRAIN_PARAM_RULES, mesh)
    specs = SH.train_specs(cfg, shape)
    tp = SHD.TP.for_batch(mesh, shape.global_batch)
    batch = {k: tp.scatter(v) for k, v in
             _zeros_like_specs(specs, mesh.home).items()}
    return train_walk(cfg, placed, batch, mesh, mb)


def train_walk(cfg, placed, batch: dict, mesh, mb: int = 1, *,
               opt=None) -> Walked:
    """The walk of one training step (remat full, ``mb`` microbatches,
    AdamW at step 1) of ``placed`` parameters (``TRAIN_PARAM_RULES``) and
    their moments (``opt``, made here when None) on a ``batch`` already
    scattered over ``mesh`` (``TP.scatter``), under the activation rules
    of :func:`_act_rules`: on meta tensors in a dry run, on the card's to
    count the same step for real."""
    opt = adamw_init(placed) if opt is None else opt
    step = make_train_step(cfg, remat="full", microbatches=mb)
    with SHD.axis_rules(_act_rules(), mesh):
        return walk(lambda: step(placed, opt, batch, 1),
                    (placed, opt.mu, opt.nu, batch), mesh,
                    extra_args=STEP_SCALARS)


def lower_train(cfg, shape: SH.ShapeSpec, mesh, unroll: bool = True):
    """unroll=False: the production step (its real microbatch count) ->
    the memory-fit walk. unroll=True: the cost walk (ONE microbatch at a
    global batch cut to ``gb``; FLOPs, bytes and collectives scale by
    ``cost_scale``, the optimizer counted once: a small overcount, as in
    the reference). Returns (Walked, extra)."""
    mb = pick_microbatches(cfg, shape, mesh)
    extra = {"microbatches": mb}
    if unroll:
        dp = _dp_size(mesh)
        gb = max(((shape.global_batch // mb) // dp) * dp, dp)
        extra["cost_scale"] = shape.global_batch / gb
        return _train_walk(cfg, dataclasses.replace(shape, global_batch=gb),
                           mesh, 1), extra
    return _train_walk(cfg, shape, mesh, mb), extra


def lower_prefill(cfg, shape: SH.ShapeSpec, mesh, unroll: bool = True):
    """The placed prefill (``SERVE_PARAM_RULES``) over ``mesh``: (Walked,
    {}). ``unroll`` changes nothing (the port's loops are unrolled)."""
    del unroll
    placed = _placed(cfg, SHD.SERVE_PARAM_RULES, mesh)
    specs = SH.prefill_specs(cfg, shape)
    tp = SHD.TP.for_batch(mesh, shape.global_batch)
    batch = {k: tp.scatter(v) for k, v in
             _zeros_like_specs(specs, mesh.home).items()}
    with SHD.axis_rules(SHD.DEFAULT_RULES, mesh):
        w = walk(lambda: TF.prefill(placed, cfg, batch), (placed, batch),
                 mesh)
    return w, {}


def lower_decode(cfg, shape: SH.ShapeSpec, mesh, unroll: bool = True):
    """The paged decode step over ``mesh`` (``serving/engine.
    lower_serve_step``) on its placed parameters, placed state and the
    round's inputs: (Walked, extra with the paged geometry)."""
    del unroll
    return decode_walk(cfg, shape, _placed(cfg, SHD.SERVE_PARAM_RULES, mesh),
                       mesh)


def decode_walk(cfg, shape: SH.ShapeSpec, placed, mesh, *, step=None):
    """The walk of one decode round of ``shape.global_batch`` slots of
    ``shape.seq_len`` tokens over ``placed`` parameters
    (``SERVE_PARAM_RULES``), on zeroed state: on meta tensors in a dry run,
    on the card's for real. The inputs count as arguments by their
    reference specs (each coordinate's cut of them; the port keeps them
    whole on the home entry). ``step``: the round's ``MeshServeStep``
    when the caller built it (``lower_serve_step``). Returns (Walked,
    extra)."""
    from repro_torch.serving.engine import ARENAS, lower_serve_step
    extra = {}
    if step is None:
        with walking():
            step, extra = lower_serve_step(cfg, shape, placed, mesh)
    inputs = 0
    k0 = SHD.coord_keys(mesh)[0]
    for name, (shp, dt, spec) in step.input_specs.items():
        local = [b - a for a, b in (SHD.spec_range(mesh, spec, shp, d, k0)
                                    for d in range(len(shp)))]
        inputs += math.prod(local) * torch.empty((), dtype=dt).element_size()
    vec = np.zeros((3, step.geom.batch), dtype=np.int32)
    with SHD.axis_rules(SHD.DEFAULT_RULES, mesh):
        w = walk(lambda: step(vec), (placed, step.state), mesh,
                 extra_args=inputs)
    w.scratch_bytes = sum(
        t[k0][:, :1].numel() * t[k0].element_size()
        for name, t in step.state.items() if name in ARENAS)
    return w, extra


def shrink_to_groups(cfg, k: int):
    """Same arch with only ``k`` scan groups (+ the tail): the two-point
    cost probe. The walk's costs are additive in groups, so total(ng) =
    C(1) + (ng - 1) * (C(2) - C(1))."""
    gs, ng, tail = TF.scan_layout(cfg)
    k = min(k, ng)
    n_layers = gs * k + tail
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        layer_pattern=cfg.layer_pattern[: gs * k]
        + cfg.layer_pattern[gs * ng:])


def _cost_of(walked: Walked) -> dict:
    cost = walked.cost_analysis()
    return {"flops": float(cost["flops"]),
            "bytes": float(cost["bytes accessed"]),
            "coll": walked.collectives()}


def two_point_costs(lower_one, cfg, ng: int) -> dict:
    """Walk the k=1 and k=2 group variants, extrapolate to ``ng``."""
    c = {}
    for k in (1, 2):
        walked, extra = lower_one(shrink_to_groups(cfg, k))
        c[k] = _cost_of(walked)
        c[k]["scale"] = float(extra.get("cost_scale", 1.0))
    out = {}
    s1, s2 = c[1]["scale"], c[2]["scale"]
    for key in ("flops", "bytes"):
        v1, v2 = c[1][key] * s1, c[2][key] * s2
        out[key] = v1 + (ng - 1) * (v2 - v1)
    coll = {}
    for op in c[1]["coll"]:
        v1 = c[1]["coll"][op] * s1
        v2 = c[2]["coll"][op] * s2
        coll[op] = int(v1 + (ng - 1) * (v2 - v1))
    out["coll"] = coll
    out["probe"] = {"c1": c[1], "c2": c[2]}
    return out


# the reference's named config mutations
VARIANTS = {
    "seqpar": lambda cfg: dataclasses.replace(cfg, attn_seq_shard=True),
    "remat_dots": lambda cfg: cfg,
    "qblk256": lambda cfg: dataclasses.replace(cfg, q_block=256),
    "qblk1024": lambda cfg: dataclasses.replace(cfg, q_block=1024,
                                                kv_block=2048),
    "lossblk256": lambda cfg: dataclasses.replace(cfg, loss_block=256),
    "kvq8": lambda cfg: dataclasses.replace(cfg, kv_quant_int8=True),
    "moe_ragged": lambda cfg: cfg,   # handled via env in the MoE layer
}


def _lower(kind: str):
    return {"train": lower_train, "prefill": lower_prefill}.get(
        kind, lower_decode)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: pathlib.Path, unroll: bool = True,
             variant: str = "", card: str = DEFAULT_CARD,
             mesh=None) -> dict:
    """One cell's record (the reference's keys, ``fits_hbm`` /
    ``hbm_bytes`` for ``fits_16g_hbm``), written to
    ``<out_dir>/<arch>__<shape>__<mesh>[__<variant>].json``. ``mesh``
    (default the production mesh) lets a test walk a smaller plan."""
    cfg = configs.get_config(arch)
    if variant:
        cfg = VARIANTS[variant](cfg)
    shape = SH.SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "variant": variant or "baseline",
    }
    suffix = f"__{variant}" if variant else ""
    fn = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    reason = SH.skip_reason(cfg, shape_name)
    if reason:
        rec["status"] = "skip"
        rec["skip_reason"] = reason
        out_dir.mkdir(parents=True, exist_ok=True)
        fn.write_text(json.dumps(rec, indent=1))
        return rec

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    hw = hw_for(card)
    lower = _lower(shape.kind)
    try:
        # ---- pass A: the production step -> memory-fit proof
        t0 = time.time()
        walked, extra = lower(cfg, shape, mesh, False)
        rec.update(extra)
        rec["lower_s"] = time.time() - t0
        rec["compile_s"] = 0.0   # nothing is compiled: the walk is the run
        mem = walked.memory_analysis()
        for k in ("temp_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "generated_code_size_in_bytes"):
            rec[k] = int(mem[k])
        rec["bytes_per_device"] = int(rec["argument_size_in_bytes"]
                                      + rec["temp_size_in_bytes"])
        rec["hbm_bytes"] = int(hw.hbm_bytes)
        rec["fits_hbm"] = rec["bytes_per_device"] <= hw.hbm_bytes

        # ---- pass B: cost accounting via the two-point group probe
        if unroll and not multi_pod:
            t2 = time.time()
            _, ng, _ = TF.scan_layout(cfg)
            tpc = two_point_costs(
                lambda cfg_k: lower(cfg_k, shape, mesh, True), cfg, ng)
            rec["cost_compile_s"] = time.time() - t2
            flops, bytes_acc, coll = tpc["flops"], tpc["bytes"], tpc["coll"]
        else:
            cost = walked.cost_analysis()
            flops = float(cost["flops"])
            bytes_acc = float(cost["bytes accessed"])
            coll = walked.collectives()
            rec["hlo_n_lines"] = walked.ops
            rec["cost_note"] = ("production walk: one microbatch's costs "
                                "times nothing (memory-fit pass; see the "
                                "single-pod record for the cost terms)")
        rec["hlo_flops_per_device"] = flops
        rec["hlo_bytes_per_device"] = bytes_acc
        rec["collective_bytes_per_device"] = coll
        rec["roofline"] = roofline_terms(
            flops=flops, nbytes=bytes_acc, coll_bytes=coll["total"],
            chips=chips, per_device=True, hw=hw)
        tokens = shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1)
        mf = model_flops_per_step(
            cfg, tokens, "train" if shape.kind == "train" else "serve")
        rec["model_flops_total"] = mf
        rec["model_flops_per_device"] = mf / chips
        rec["useful_flops_ratio"] = mf / chips / flops if flops > 0 else None
        rec["status"] = "ok"
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    fn.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rolled", action="store_true",
                    help="report the production walk's own costs (no "
                         "two-point probe)")
    ap.add_argument("--variant", default="",
                    help=f"a variant: one of {sorted(VARIANTS)}")
    ap.add_argument("--card", default=DEFAULT_CARD,
                    help="the card whose figures give the roofline terms")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = configs.all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SH.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = pathlib.Path(args.out)
    n_fail = 0
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(arch, shp, multi_pod=mp, out_dir=out,
                               unroll=not args.rolled, variant=args.variant,
                               card=args.card)
                status = rec["status"]
                extra = (f" [{rec.get('error', '')[:120]}]"
                         if status == "fail" else "")
                n_fail += status == "fail"
                print(f"{arch:24s} {shp:12s} "
                      f"{'multi' if mp else 'single':6s} -> {status}{extra} "
                      f"({time.time() - t0:.1f} s)", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
