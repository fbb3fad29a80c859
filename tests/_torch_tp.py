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
``compress_psum_pod`` runs here too, under ``jax.vmap(axis_name="pod")``,
and the embedding lookup's gradient (mesh-free and placed by
``TRAIN_PARAM_RULES`` under ``axis_rules``) on a bf16 table. A second
part (``python tests/_torch_tp.py OUT.npz variants``, for
tests/test_torch_tp_variants.py) runs the placed variants under
``axis_rules(DEFAULT_RULES, mesh)``: gemma2-2b SMOKE with
``attn_seq_shard`` (its train loss and gradients, its prefill) and
granite-moe SMOKE with ``REPRO_MOE_RAGGED=1`` (train loss and gradients).
A third part (``... seq_act``, for tests/test_torch_seq_act.py) runs the
placed train step's loss and gradients of gemma2-2b and zamba2-2.7b SMOKE
under ``axis_rules({**DEFAULT_RULES, "seq": ("model",)}, mesh)`` (the
dry run's ``REPRO_SEQ_ACT=model``); ``... seq_combos`` (for
tests/test_torch_seq_act_combos.py) the same rules combined with
``attn_seq_shard`` (gemma2-2b) and with ``REPRO_MOE_RAGGED=1``
(granite-moe): each combination's status (``ok`` or the error jax 0.9
raises) and, where it runs, its loss and gradients. jit's cache does not
key on the axis rules, so every rule set gets a fresh ``jax.jit``. A
fourth (``... decode``, for tests/test_torch_tp_decode.py) runs the dense
``decode_step`` of yi-6b, zamba2-2.7b and granite-moe SMOKE jitted with
``SERVE_PARAM_RULES`` shardings (the cache's slots over 'data', its kv
heads over 'model') over (2, 2) and (1, 4), 3 rounds each.
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
EMBED_ARCH, EMBED_B, EMBED_S = "gemma2-2b", 2, 4096
SEQPAR_ARCH, RAGGED_ARCH = "gemma2-2b", "granite-moe-1b-a400m"
SEQ_ACT_ARCHS = ("gemma2-2b", "zamba2-2.7b")
DECODE_LEN, DECODE_LENGTHS = 16, (0, 3, 5, 1)


def embed_case(vocab: int, d: int) -> dict:
    """Zipf(1.2) tokens [EMBED_B, EMBED_S] clipped to the vocabulary (a
    frequent token's row sums thousands of gradient rows) and a seeded
    cotangent of the lookup's output, fp32 (cast to bf16 by both
    sides)."""
    rng = np.random.default_rng(12)
    toks = np.minimum(rng.zipf(1.2, (EMBED_B, EMBED_S)) - 1, vocab - 1)
    return {"tokens": toks.astype(np.int32),
            "cot": rng.standard_normal((EMBED_B, EMBED_S, d)).astype(
                np.float32)}


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


def decode_case(arch: str, cfg) -> dict:
    """A dense decode case of ``SLOTS`` slots: every cache leaf of
    ``init_cache(cfg, SLOTS, DECODE_LEN)`` filled from a seeded generator
    (fp32; cast by both sides), the tokens of each round and the starting
    lengths."""
    rng = np.random.default_rng(41 + len(arch))
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    out = {"tokens": rng.integers(0, cfg.vocab, (ROUNDS, SLOTS)).astype(
        np.int32), "lengths": np.asarray(DECODE_LENGTHS, np.int32)}
    shape = (SLOTS, DECODE_LEN, kh, hd)
    la = len(cfg.attn_layer_ids)
    if la:
        for n in ("k", "v"):
            out[f"cache/{n}"] = rng.standard_normal(
                (la,) + shape).astype(np.float32)
    if cfg.shared_attn_every > 0:
        na = cfg.n_shared_applications()
        for n in ("shared_k", "shared_v"):
            out[f"cache/{n}"] = rng.standard_normal(
                (na,) + shape).astype(np.float32)
    return out


def _ssm_shapes(cfg) -> dict:
    from repro.models.layers import ssm
    one = ssm.mamba2_init_state(cfg, SLOTS)
    n = len(cfg.ssm_layer_ids)
    return {k: (n,) + tuple(a.shape) for k, a in one.items()}


def ssm_case(arch: str, cfg, shapes: dict) -> dict:
    """Seeded SSM states of the decode case (``shapes``: name -> the
    stacked state's shape)."""
    rng = np.random.default_rng(43 + len(arch))
    return {f"cache/ssm/{k}": (rng.standard_normal(sh) * 0.5).astype(
        np.float32) for k, sh in sorted(shapes.items())}


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


def _embed(res: dict) -> None:
    """The gradient of ``embed_tokens`` (its table bf16) for the cotangent
    of :func:`embed_case`: mesh-free, and with the table placed by
    ``TRAIN_PARAM_RULES`` over an Auto (2, 2) mesh under ``axis_rules``
    (the reference's manual lookup)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as JTF
    from repro.models.params import abstract_init
    from repro.parallel import sharding as JSH
    base, jp = M.ref_weights(EMBED_ARCH)
    cfg = dataclasses.replace(base, dtype=jnp.bfloat16)
    emb = jp["embed"].astype(jnp.bfloat16)
    case = embed_case(cfg.vocab, cfg.d_model)
    toks = jnp.asarray(case["tokens"])
    cot = jnp.asarray(case["cot"]).astype(jnp.bfloat16)

    def grad(e, t, c):
        return jax.vjp(lambda e: JTF.embed_tokens({"embed": e}, cfg, t),
                       e)[1](c)[0]
    res["embed/free"] = np.asarray(jax.jit(grad)(emb, toks, cot),
                                   np.float32)
    mesh = _auto_mesh((2, 2))
    sds, axes = abstract_init(JTF.init_model, cfg)
    spec = JSH.specs_for_tree(axes, JSH.TRAIN_PARAM_RULES, mesh,
                              sds)["embed"]
    dp = NamedSharding(mesh, P("data"))
    with JSH.axis_rules(JSH.DEFAULT_RULES, mesh):
        got = jax.jit(grad, in_shardings=(spec, dp, dp))(emb, toks, cot)
    res["embed/placed"] = np.asarray(got, np.float32)
    res["weights/embed"] = np.asarray(emb, np.float32)


def _variants(res: dict) -> None:
    """gemma2-2b SMOKE with ``attn_seq_shard``: the placed train loss and
    gradients (``TRAIN_PARAM_RULES``, remat full) and the placed prefill's
    logits (``SERVE_PARAM_RULES``); granite-moe SMOKE with
    ``REPRO_MOE_RAGGED=1``: the placed train loss and gradients. Over an
    Auto (2, 2) mesh under ``axis_rules(DEFAULT_RULES, mesh)`` (the
    sequence-parallel island needs the current mesh)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as JTF
    from repro.models.params import abstract_init
    from repro.parallel import sharding as JSH
    mesh = _auto_mesh((2, 2))
    dp = NamedSharding(mesh, P("data"))
    for tag, arch in (("seqpar", SEQPAR_ARCH), ("ragged", RAGGED_ARCH)):
        base, jp = M.ref_weights(arch)
        cfg = (dataclasses.replace(base, attn_seq_shard=True)
               if tag == "seqpar" else base)
        sds, axes = abstract_init(JTF.init_model, cfg)
        batch = {k: jnp.asarray(v) for k, v in
                 train_batch(arch, cfg.vocab).items()}
        spec = JSH.specs_for_tree(axes, JSH.TRAIN_PARAM_RULES, mesh, sds)
        if tag == "ragged":
            os.environ["REPRO_MOE_RAGGED"] = "1"
        try:
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: JTF.train_loss(p, cfg, b, remat="full")[0]),
                in_shardings=(spec, {k: dp for k in batch}))
            with JSH.axis_rules(JSH.DEFAULT_RULES, mesh):
                loss, grads = fn(jp, batch)
        finally:
            os.environ.pop("REPRO_MOE_RAGGED", None)
        res[f"{tag}/loss"] = np.asarray(loss)
        res.update(M.flatten(grads, f"{tag}/grads"))
        res.update(M.flatten(jp, f"{tag}/weights"))
        if tag == "seqpar":
            sspec = JSH.specs_for_tree(axes, JSH.SERVE_PARAM_RULES, mesh,
                                       sds)
            fn = jax.jit(lambda p, t: JTF.prefill(p, cfg, {"tokens": t})[0],
                         in_shardings=(sspec, dp))
            with JSH.axis_rules(JSH.DEFAULT_RULES, mesh):
                res["seqpar/prefill"] = np.asarray(fn(jp, batch["tokens"]))


def _seq_act(res: dict, combos: bool = False) -> None:
    """The placed train loss and gradients under the ``seq -> model``
    activation rule (``TRAIN_PARAM_RULES``, remat full, Auto (2, 2)): a
    fresh ``jax.jit`` for each rule set (jit's cache does not key on the
    rules). The combinations with ``attn_seq_shard`` and the ragged MoE
    record their status and, where they run, their loss."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as JTF
    from repro.models.params import abstract_init
    from repro.parallel import sharding as JSH
    mesh = _auto_mesh((2, 2))
    dp = NamedSharding(mesh, P("data"))
    rules = dict(JSH.DEFAULT_RULES, seq=("model",))
    cases = ([("seqpar", SEQPAR_ARCH,
               lambda c: dataclasses.replace(c, attn_seq_shard=True), None),
              ("ragged", RAGGED_ARCH, lambda c: c, "1")] if combos else
             [(a, a, lambda c: c, None) for a in SEQ_ACT_ARCHS])
    for tag, arch, cfg_of, ragged in cases:
        base, jp = M.ref_weights(arch)
        cfg = cfg_of(base)
        sds, axes = abstract_init(JTF.init_model, cfg)
        batch = {k: jnp.asarray(v) for k, v in
                 train_batch(arch, cfg.vocab).items()}
        spec = JSH.specs_for_tree(axes, JSH.TRAIN_PARAM_RULES, mesh, sds)
        if ragged:
            os.environ["REPRO_MOE_RAGGED"] = ragged
        try:
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: JTF.train_loss(p, cfg, b, remat="full")[0]),
                in_shardings=(spec, {k: dp for k in batch}))
            with JSH.axis_rules(rules, mesh):
                loss, grads = fn(jp, batch)
            res[f"seq_act/{tag}/status"] = np.asarray("ok")
            res[f"seq_act/{tag}/loss"] = np.asarray(loss)
            res.update(M.flatten(grads, f"seq_act/{tag}/grads"))
            res.update(M.flatten(jp, f"seq_act/{tag}/weights"))
        except Exception as e:  # noqa: BLE001 — recorded for the parent
            res[f"seq_act/{tag}/status"] = np.asarray(
                f"{type(e).__name__}: {e}"[:500])
        finally:
            os.environ.pop("REPRO_MOE_RAGGED", None)


def _decode(res: dict) -> None:
    """The dense ``decode_step`` over weights placed by
    ``SERVE_PARAM_RULES`` (jitted with ``in_shardings``; the cache's slots
    over 'data' and kv heads over 'model' where they divide), 3 rounds from
    :func:`decode_case`'s cache."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as JTF
    from repro.models.params import abstract_init
    from repro.parallel import sharding as JSH
    for arch in SERVE_ARCHS:
        cfg, jp = M.ref_weights(arch)
        sds, axes = abstract_init(JTF.init_model, cfg)
        c = decode_case(arch, cfg)
        cache = {k.split("/", 1)[1]: jnp.asarray(v, cfg.dtype)
                 for k, v in c.items() if k.startswith("cache/")}
        if cfg.ssm_layer_ids:
            st = ssm_case(arch, cfg, _ssm_shapes(cfg))
            one = JTF.init_cache(cfg, SLOTS, DECODE_LEN)["ssm"]
            cache["ssm"] = {k: jnp.asarray(st[f"cache/ssm/{k}"], a.dtype)
                            for k, a in one.items()}
            res.update({f"decode/{arch}/{k}": v for k, v in st.items()})
        for mname, shape in MESHES.items():
            mesh = _auto_mesh(shape)
            nm, nd = shape[1], shape[0]
            heads = "model" if cfg.n_kv_heads % nm == 0 else None
            slots = "data" if SLOTS % nd == 0 else None

            def cspec(name, a):
                if name == "ssm":
                    return {k: NamedSharding(mesh, P(None, slots))
                            for k in a}
                return NamedSharding(mesh, P(None, slots, None, heads))
            c_spec = {k: cspec(k, v) for k, v in cache.items()}
            p_spec = JSH.specs_for_tree(axes, JSH.SERVE_PARAM_RULES, mesh,
                                        sds)
            vec = NamedSharding(mesh, P(slots))
            step = jax.jit(
                lambda p, t, ca, ln: JTF.decode_step(p, cfg, t, ca, ln),
                in_shardings=(p_spec, vec, c_spec, vec))
            ca, lens, logits = cache, c["lengths"], []
            for r in range(ROUNDS):
                lg, ca = step(jp, jnp.asarray(c["tokens"][r]),
                              jax.device_put(ca, c_spec), jnp.asarray(lens))
                logits.append(np.asarray(lg))
                lens = lens + 1
            res[f"decode/{arch}/{mname}/logits"] = np.stack(logits)
            for k, v in ca.items():
                if k != "ssm":
                    res[f"decode/{arch}/{mname}/cache/{k}"] = np.asarray(
                        v, np.float32)
        res.update(M.flatten(jp, f"weights/{arch}"))


def _reference(out_path: str, part: str = "steps") -> None:
    import jax
    assert jax.device_count() >= 4, jax.devices()
    res: dict = {}
    if part in ("seq_act", "seq_combos"):
        _seq_act(res, combos=part == "seq_combos")
    elif part == "decode":
        _decode(res)
    elif part == "variants":
        _variants(res)
    else:
        _serve(res)
        _train(res)
        _compress(res)
        _embed(res)
    np.savez(out_path, **res)


def run_reference(out_path: str, timeout: float = 600.0,
                  part: str = "steps") -> dict:
    """Start the child (four forced host devices, CPU) and load its
    results (``part``: ``steps``, the placed steps of
    tests/test_torch_tp_step.py, ``variants``, ``seq_act``,
    ``seq_combos`` or ``decode``)."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           out_path, part], env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the reference child failed:\n{proc.stderr}")
    with np.load(out_path) as f:
        return dict(f)


if __name__ == "__main__":
    _reference(sys.argv[1], *sys.argv[2:3])
