"""The port's optimizer, schedule, data pipeline and training step
against the reference's on the CPU.

``cosine_schedule`` within 1e-9 relative (the reference computes in
fp32), ``clip_by_global_norm`` and ``adamw_update`` on seeded trees (fp32
and bf16 parameters; moments within 1e-6, parameters within one bf16
rounding), ``make_batch`` bit-equal for the same (seed, step, shard), the
int8 gradient compression exact, and three ``make_train_step`` steps of
yi-6b's SMOKE config (microbatches 1 and 2; remat none, dots and full)
whose losses stay within 1e-4 of the reference's jitted step from the
same weights and batches (fp32: the order of the sums, over three
optimizer steps)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import synthetic as JD
from repro.models import transformer as JTF
from repro.models.params import split
from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro.training import step as JST
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.configs import shapes as TSH
from repro_torch.data import synthetic as TD
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedule as TS
from repro_torch.training import step as TST


@pytest.mark.parametrize("kw", [dict(), dict(peak_lr=1e-3, warmup=10,
                                             total=50, floor=0.2)])
def test_cosine_schedule_matches_reference(kw):
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 200, 20_000):
        want = float(JS.cosine_schedule(jnp.asarray(step), **kw))
        got = TS.cosine_schedule(step, **kw)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), step


def _tree(rng, dtype):
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 3)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes)


def _both(tree, dtype):
    """(the reference's jnp tree, the port's torch tree) in ``dtype``."""
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.dtype(dtype)), tree)
    tt = jax.tree.map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)),
                      tree)
    return jt, tt


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(1), "float32")
    jg, tg = _both(g, "float32")
    jc, jn = JA.clip_by_global_norm(jg, max_norm)
    tc, tn = TA.clip_by_global_norm(tg, max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for a, b in zip(jax.tree.leaves(jc), TA.tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    rng = np.random.default_rng(2)
    p0 = _tree(rng, dtype)
    jp, tp = _both(p0, dtype)
    js, ts = JA.adamw_init(jp), TA.adamw_init(tp)
    for i in range(3):
        g = _tree(rng, "float32")
        jg, tg = _both(g, dtype)
        lr = 1e-2 / (i + 1)
        jp, js, jm = JA.adamw_update(jg, js, jp, lr, max_grad_norm=2.0)
        tp, ts, tm = TA.adamw_update(tg, ts, tp, lr, max_grad_norm=2.0)
        assert int(ts.count) == int(js.count) == i + 1
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
    for a, b in zip(jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu),
                    TA.tree_leaves(ts.mu) + TA.tree_leaves(ts.nu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    for a, b in zip(jax.tree.leaves(jp), TA.tree_leaves(tp)):
        assert b.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-1b",
                                  "seamless-m4t-large-v2"])
def test_make_batch_is_bit_equal(arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    for seed, step, shard in ((0, 0, 0), (3, 17, 1), (9, 2, 5)):
        want = JD.make_batch(jcfg, 3, 20, seed=seed, step=step, shard=shard)
        got = TD.make_batch(tcfg, 3, 20, seed=seed, step=step, shard=shard)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    ds = TD.SyntheticDataset(tcfg, 4, 20, seed=1, shard=1, num_shards=2)
    np.testing.assert_array_equal(
        ds.batch_at(7)["tokens"],
        JD.SyntheticDataset(jcfg, 4, 20, seed=1, shard=1,
                            num_shards=2).batch_at(7)["tokens"])


def test_shape_specs_match_reference():
    from repro.configs import shapes as JSH
    for arch in ("gemma2-2b", "internvl2-1b", "seamless-m4t-large-v2"):
        jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        for name, shape in TSH.SHAPES.items():
            jshape = JSH.SHAPES[name]
            assert TSH.applicable(tcfg, name) == JSH.applicable(jcfg, name)
            assert TSH.skip_reason(tcfg, name) == JSH.skip_reason(jcfg, name)
            for fn in ("train_specs", "prefill_specs", "decode_specs"):
                want = getattr(JSH, fn)(jcfg, jshape)
                got = getattr(TSH, fn)(tcfg, shape)
                assert sorted(got) == sorted(want)
                for k, w in want.items():
                    assert got[k].device.type == "meta"
                    assert tuple(got[k].shape) == tuple(w.shape)
                    assert str(got[k].dtype).split(".")[-1] == \
                        jnp.dtype(w.dtype).name


def test_int8_compression_matches_reference():
    g = np.random.default_rng(4).standard_normal((33, 17)).astype(np.float32)
    jq, js = JST.quantize_int8(jnp.asarray(g))
    tq, ts = TST.quantize_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == pytest.approx(float(js), rel=1e-7)
    np.testing.assert_allclose(TST.dequantize_int8(tq, ts).numpy(),
                               np.asarray(JST.dequantize_int8(jq, js)),
                               rtol=1e-6)


STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _reference_losses(microbatches):
    cfg = JC.get_smoke("yi-6b")
    params = split(JTF.init_model(jax.random.PRNGKey(0), cfg))[0]
    opt = JA.adamw_init(params)
    step_fn = jax.jit(JST.make_train_step(cfg, remat="none",
                                          microbatches=microbatches,
                                          **STEP_KW))
    data = JD.SyntheticDataset(cfg, 4, 16, seed=3)
    losses = []
    numpy_params = jax.tree.map(np.asarray, params)
    for step in range(3):
        batch = jax.tree.map(jnp.asarray, data.batch_at(step))
        params, opt, m = step_fn(params, opt, batch, jnp.asarray(step))
        losses.append(float(m["loss"]))
    return numpy_params, tuple(losses)


@pytest.mark.parametrize("microbatches,remat", [
    (1, "none"), (1, "dots"), (1, "full"), (2, "none"), (2, "full")])
def test_train_steps_match_reference(microbatches, remat):
    numpy_params, want = _reference_losses(microbatches)
    cfg = TC.get_smoke("yi-6b")
    params = convert.params_from_numpy(cfg, numpy_params, "cpu")
    opt = TA.adamw_init(params)
    step_fn = TST.make_train_step(cfg, remat=remat,
                                  microbatches=microbatches, **STEP_KW)
    data = TD.SyntheticDataset(cfg, 4, 16, seed=3)
    for step in range(3):
        batch = {k: torch.from_numpy(v) for k, v in
                 data.batch_at(step).items()}
        params, opt, m = step_fn(params, opt, batch, step)
        assert abs(float(m["loss"]) - want[step]) <= 1e-4, (step,
                                                            float(m["loss"]),
                                                            want[step])
    assert int(opt.count) == 3
    assert not any(p.requires_grad for p in TA.tree_leaves(params))
