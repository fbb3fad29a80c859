"""Inputs of tests/test_torch_tp_step.py and the reference's side of it.

The reference's placed steps (the serve step and the train step jitted
with ``in_shardings`` from ``specs_for_tree(param_axes,
SERVE_PARAM_RULES / TRAIN_PARAM_RULES, mesh, shapes)``) need four host
devices, which jax fixes when it starts, and a mesh whose axes are
``AxisType.Auto``: over jax 0.9's default explicit axes
(``make_debug_mesh``) the placed serve step stops in ``embed_tokens``'
gather. So they run here, in ONE child process per test file
(``python tests/_torch_tp.py OUT.npz``, four forced host devices, no
``axis_rules``), and the parent reads the results from the ``.npz``.
``compress_psum_pod`` runs here too, under ``jax.vmap(axis_name="pod")``.
Every input is drawn from seeded numpy generators, so the parent rebuilds
the same ones.
"""
from __future__ import annotations

import os
import sys

import numpy as np

import _torch_mesh as M

SERVE_ARCHS = ("yi-6b", "zamba2-2.7b", "granite-moe-1b-a400m")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
SLOTS = 4
ROUNDS = 3
TRAIN_ARCHS = ("gemma2-2b", "zamba2-2.7b")
TRAIN_B, TRAIN_S, TRAIN_STEP = 4, 32, 1
COMP_SHAPE, COMP_STEPS, COMP_PODS = (6, 10), 3, 2


def serve_case(arch: str, cfg, geom) -> dict:
    """The pools and first tokens of one placed serve case
    (``_torch_mesh.step_case`` in the geometry's layout)."""
    n_shared = cfg.n_shared_applications() if cfg.shared_attn_every else 0
    n_attn = len(cfg.attn_layer_ids)
    return M.step_case(arch, SLOTS, cfg.n_kv_heads, cfg.head_dim,
                       SLOTS // geom.batch_local, geom.stripe_total, n_attn,
                       n_shared, cfg.vocab)


def train_batch(arch: str, vocab: int) -> dict:
    """A seeded batch: tokens, labels (one masked -1 label a row) and a
    loss mask with a few zeros."""
    rng = np.random.default_rng(31 + len(arch))
    shape = (TRAIN_B, TRAIN_S)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[:, -1] = -1
    mask = (rng.random(shape) > 0.1).astype(np.float32)
    mask[:, -1] = 0.0
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": labels, "loss_mask": mask}


def comp_grads() -> np.ndarray:
    """[steps, pods, *COMP_SHAPE] fp32 gradients of the compression case."""
    rng = np.random.default_rng(77)
    return rng.standard_normal((COMP_STEPS, COMP_PODS) + COMP_SHAPE
                               ).astype(np.float32)


def _auto_mesh(shape):
    import jax
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _serve(res: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JTF
    from repro.models.params import abstract_init
    from repro.parallel import sharding as JSH
    from repro.roofline.analysis import collective_bytes
    from repro.serving import engine as JE
    from repro.serving import paged as JP
    for arch in SERVE_ARCHS:
        cfg, jp = M.ref_weights(arch)
        sds, axes = abstract_init(JTF.init_model, cfg)
        for mname, shape in MESHES.items():
            mesh = _auto_mesh(shape)
            geom = JP.plan_geometry(
                batch=SLOTS, seq_len=M.STEP_NBLK * M.STEP_BLOCK,
                kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                q_heads=cfg.n_heads, mesh=mesh, block=M.STEP_BLOCK)
            c = serve_case(arch, cfg, geom)
            s_sds, s_spec = JE.serve_state_specs(cfg, geom, mesh)
            _, i_spec = JE.serve_input_specs(cfg, geom, mesh)
            p_spec = JSH.specs_for_tree(axes, JSH.SERVE_PARAM_RULES, mesh,
                                        sds)
            state = {k: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     v) for k, v in s_sds.items()}
            for name in ("arena", "shared_arena"):
                if name in state:
                    state[name] = jnp.asarray(c[name])
            step = jax.jit(JE.make_serve_step(cfg, geom, mesh,
                                              return_logits=True),
                           in_shardings=(p_spec, s_spec, i_spec))
            lens, tokens = c["lengths0"].copy(), c["tokens0"]
            logits = []
            for r in range(ROUNDS):
                wr = M.write_rows(c["pt"], lens, c["active"], M.STEP_BLOCK)
                inputs = {"tokens": jnp.asarray(tokens),
                          "lengths": jnp.asarray(lens),
                          "write_off": jnp.asarray(lens % M.STEP_BLOCK),
                          "pt": jnp.asarray(c["pt"]),
                          "blk_start": jnp.asarray(c["bs"]),
                          "write_rows": jnp.asarray(wr)}
                if r == 0:   # one compile: its HLO, then its runs
                    step = step.lower(jp, state, inputs).compile()
                    for kind, n in collective_bytes(
                            step.as_text()).items():
                        res[f"serve/{arch}/{mname}/hlo_bytes/{kind}"] = (
                            np.int64(n))
                nxt, state, lg = step(jp, state, inputs)
                logits.append(np.asarray(lg))
                tokens = np.where(c["active"], np.asarray(nxt), 0).astype(
                    np.int32)
                lens = lens + c["active"].astype(np.int32)
            res[f"serve/{arch}/{mname}/logits"] = np.stack(logits)
        res.update(M.flatten(jp, f"weights/{arch}"))


def _train(res: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as JTF
    from repro.models.params import abstract_init
    from repro.optim.adamw import AdamWState, adamw_init
    from repro.parallel import sharding as JSH
    from repro.training.step import make_train_step
    mesh = _auto_mesh((2, 2))
    for arch in TRAIN_ARCHS:
        cfg, jp = M.ref_weights(arch)
        sds, axes = abstract_init(JTF.init_model, cfg)
        p_spec = JSH.specs_for_tree(axes, JSH.TRAIN_PARAM_RULES, mesh, sds)
        rep = NamedSharding(mesh, P())
        o_spec = AdamWState(p_spec, p_spec, rep)
        batch = {k: jnp.asarray(v) for k, v in
                 train_batch(arch, cfg.vocab).items()}
        b_spec = {k: NamedSharding(mesh, P("data")) for k in batch}
        step = jax.jit(make_train_step(cfg, remat="full"),
                       in_shardings=(p_spec, o_spec, b_spec, rep))
        params, _, metrics = step(jp, adamw_init(jp), batch,
                                  jnp.int32(TRAIN_STEP))
        res[f"train/{arch}/loss"] = np.asarray(metrics["loss"])
        res[f"train/{arch}/grad_norm"] = np.asarray(metrics["grad_norm"])
        res.update(M.flatten(params, f"train/{arch}/params"))
        res.update(M.flatten(jp, f"weights/{arch}"))


def _compress(res: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro.parallel.compression import compress_psum_pod
    fn = jax.vmap(lambda g, e: compress_psum_pod(g, e, n_pods=COMP_PODS),
                  axis_name="pod")
    err = jnp.zeros((COMP_PODS,) + COMP_SHAPE, jnp.float32)
    for i, g in enumerate(comp_grads()):
        g_hat, err = fn(jnp.asarray(g), err)
        res[f"compress/{i}/g_hat"] = np.asarray(g_hat)
        res[f"compress/{i}/err"] = np.asarray(err)


def _reference(out_path: str) -> None:
    import jax
    assert jax.device_count() >= 4, jax.devices()
    res: dict = {}
    _serve(res)
    _train(res)
    _compress(res)
    np.savez(out_path, **res)


def run_reference(out_path: str, timeout: float = 600.0) -> dict:
    """Start the child (four forced host devices, CPU) and load its
    results."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           out_path], env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the reference child failed:\n{proc.stderr}")
    with np.load(out_path) as f:
        return dict(f)


if __name__ == "__main__":
    _reference(sys.argv[1])
