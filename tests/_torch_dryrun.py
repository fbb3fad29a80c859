"""The reference's side of tests/test_torch_dryrun.py.

The reference's dry run lowers and compiles each cell over its production
mesh of 512 forced host devices; at SMOKE size the same code runs over an
Auto (2, 4) mesh of eight forced host devices (over jax 0.9's default
explicit axes its placed steps refuse ``with_sharding_constraint``), in
child processes (``python tests/_torch_dryrun.py OUT.json ARCH``): jax is
started with eight devices before ``repro.launch.dryrun`` is imported
(whose first line asks for 512), and the child points the reference's
``make_production_mesh`` at that mesh, its ``configs.get_config`` at the
SMOKE configs and its shapes at :data:`SHAPES`. Nothing in the reference
is edited. One child runs an arch's cells (the three start together);
each cell's ``run_cell`` record (the production graph, rolled: one
compile a cell) goes to the parent as JSON. ``python
tests/_torch_dryrun.py OUT.json ARCH seq_act`` (for
tests/test_torch_seq_act.py) runs the arch's ``train_4k`` cell alone under
``REPRO_SEQ_ACT=model``.
"""
from __future__ import annotations

import json
import os
import sys

ARCHS = ("yi-6b", "zamba2-2.7b", "granite-moe-1b-a400m")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
# the shapes the cells take here (name: seq_len, global_batch)
SHAPES = {"train_4k": (64, 8), "prefill_32k": (64, 8),
          "decode_32k": (64, 8), "long_500k": (512, 1)}
MESH = (2, 4)


def _reference(out_path: str, arch: str, variant: str = "") -> None:
    import pathlib
    import tempfile

    import jax
    assert jax.device_count() >= 8, jax.devices()
    from repro import configs as JC
    from repro.configs import shapes as JSH
    from repro.launch import dryrun as JDR
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    JDR.make_production_mesh = lambda multi_pod=False: mesh
    JC.get_config = JC.get_smoke
    for name, (s, b) in SHAPES.items():
        JSH.SHAPES[name] = JSH.ShapeSpec(name, s, b, JSH.SHAPES[name].kind)
    out = {}
    if variant == "seq_act":
        os.environ["REPRO_SEQ_ACT"] = "model"
        with tempfile.TemporaryDirectory() as tmp:
            rec = JDR.run_cell(arch, "train_4k", multi_pod=False,
                               out_dir=pathlib.Path(tmp), unroll=False)
        rec.pop("traceback", None)
        with open(out_path, "w") as f:
            json.dump({f"{arch}/train_4k": rec}, f, default=str)
        return
    with tempfile.TemporaryDirectory() as tmp:
        for kind in KINDS:
            rec = JDR.run_cell(arch, kind, multi_pod=False,
                               out_dir=pathlib.Path(tmp), unroll=False)
            rec.pop("traceback", None)
            out[f"{arch}/{kind}"] = rec
        if arch != "yi-6b":
            with open(out_path, "w") as f:
                json.dump(out, f, default=str)
            return
        out["yi-6b/long_500k"] = JDR.run_cell(
            "yi-6b", "long_500k", multi_pod=False,
            out_dir=pathlib.Path(tmp), unroll=False)
    # the cost walk's extra (microbatches, cost_scale) under REPRO_MB=2,
    # which cuts the global batch the cost graph takes: lowered, not
    # compiled (the records hold the microbatches of the cells' own choice)
    os.environ["REPRO_MB"] = "2"
    out["extra/mb2"] = JDR.lower_train(
        JC.get_smoke("yi-6b"), JSH.SHAPES["train_4k"], mesh, True)[1]
    os.environ.pop("REPRO_MB")
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


def start_reference(out_path: str, archs=ARCHS, variant: str = "") -> list:
    """Start one child an arch (eight forced host devices, CPU), all at
    once; the parent works on while they run (:func:`load_reference`
    waits for them). ``variant``: ``seq_act`` (``train_4k`` alone under
    ``REPRO_SEQ_ACT=model``)."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    env.pop("REPRO_SEQ_ACT", None)
    return [(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               f"{out_path}.{i}", arch]
                              + ([variant] if variant else []), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True), f"{out_path}.{i}")
            for i, arch in enumerate(archs)]


def load_reference(children: list, timeout: float = 600.0) -> dict:
    """Wait for the children and load their records."""
    out = {}
    for proc, path in children:
        _, err = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"the reference child failed:\n{err}")
        with open(path) as f:
            out.update(json.load(f))
    return out


if __name__ == "__main__":
    _reference(*sys.argv[1:4])
