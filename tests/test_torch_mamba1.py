"""The port's Mamba1 (falcon-mamba-7b) against the JAX reference on the
CPU.

The doubling scan (``ssm.linear_scan``) is held against the reference's
``_assoc_linear_scan`` at a prime length and at a decay that underflows
fp32 within a few steps (a ``cumprod`` followed by a division would give
inf and NaN there); the layer (forward over a prompt whose length is
prime, so the port tiles it with a ragged last chunk where the reference
shrinks its chunk to 1, and decode) within 1e-5 in fp32 (summation
order). falcon-mamba's SMOKE weights are drawn by the reference
(``init_model(PRNGKey(0))``), with ``dt_bias`` and ``D`` made non-trivial
from a seed, and carried across with ``convert.params_from_numpy``; the
stack's prefill and dense decode agree within 1e-5 and 8 rounds of both
serving engines give equal greedy tokens, logits within 1e-4 and equal
SSM states. The stack is attention-free: neither engine allocates a
block, and finishing, evicting and flushing remove nothing."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.layers import ssm as JS
from repro.models.params import split
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TTF
from repro_torch.models.layers import ssm as TS
from repro_torch.serving.engine import ServeEngine as TEngine

ATOL = 1e-5
LOGIT_ATOL = 1e-4
ARCH = "falcon-mamba-7b"

j_prefill = jax.jit(JTF.prefill, static_argnums=1)
j_decode = jax.jit(JTF.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def weights():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    rng = np.random.default_rng(5)
    m = jp["layers"]["mamba"]
    m["dt_bias"] = jnp.asarray(rng.standard_normal(m["dt_bias"].shape) * 0.5,
                               jnp.float32)
    m["D"] = jnp.asarray(1 + 0.5 * rng.standard_normal(m["D"].shape),
                         jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_config_matches_reference():
    for name in ("CONFIG", "SMOKE"):
        j = getattr(__import__("repro.configs.falcon_mamba_7b",
                               fromlist=[name]), name)
        t = getattr(__import__("repro_torch.configs.falcon_mamba_7b",
                               fromlist=[name]), name)
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), f.name
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
        for f in ("padded_vocab", "d_inner", "ssm_layer_ids"):
            assert getattr(j, f) == getattr(t, f), f
        assert j.param_count() == t.param_count()
    assert ARCH in TC.PORTED and TC.get_config(ARCH).d_inner == 8192


def test_init_has_the_reference_layout():
    """Leaves, shapes and dtypes of the port's seeded init equal the
    reference's: A_log, D and dt_bias fp32 (``ssm.FP32_LEAVES``), A_log
    the S4D-real init log(1..state) in both."""
    jcfg, tcfg, jp, _ = weights()
    ours = _leaves(TTF.init_model(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    theirs = _leaves(jax.tree.map(np.asarray, jp))
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == v.shape, k
        assert str(ours[k].dtype).split(".")[-1] == v.dtype.name, k
    np.testing.assert_allclose(ours["layers.mamba.A_log"].numpy(),
                               theirs["layers.mamba.A_log"], atol=1e-7)


def test_params_keep_the_fp32_leaves_at_bf16():
    """At the published bf16 dtype the reference keeps A_log, D and
    dt_bias in fp32; carried across they stay fp32 and exact, every other
    leaf bf16."""
    jcfg = dataclasses.replace(JC.get_smoke(ARCH), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.get_smoke(ARCH), dtype=torch.bfloat16)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    jp["layers"]["mamba"]["dt_bias"] = jnp.full(
        jp["layers"]["mamba"]["dt_bias"].shape, 0.1234567, jnp.float32)
    want = _leaves(jax.tree.map(np.asarray, jp))
    got = _leaves(convert.params_from_numpy(tcfg,
                                            jax.tree.map(np.asarray, jp),
                                            "cpu"))
    for k, v in want.items():
        fp32 = k.rsplit(".", 1)[-1] in TS.FP32_LEAVES
        assert got[k].dtype == (torch.float32 if fp32 else torch.bfloat16), k
        assert v.dtype.name == ("float32" if fp32 else "bfloat16"), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      v.astype(np.float32))


@pytest.mark.parametrize("s,decay", [(37, 1.0), (61, 16.0), (1, 1.0)])
def test_linear_scan_matches_reference(s, decay):
    """The doubling scan against the reference's associative scan, with a
    nonzero h0: a prime length, and decays a = exp(-dt * decay) with dt up
    to 8 (at ``decay`` 16, A = -16 as at falcon-mamba's last state
    index: the products underflow fp32 to 0 within a few steps, where a
    cumprod's division gives inf / NaN). fp32 within 1e-5."""
    rng = np.random.default_rng(s)
    dt = rng.uniform(0.0, 8.0, (2, s, 6, 4)).astype(np.float32)
    a = np.exp(-dt * decay).astype(np.float32)
    b = rng.standard_normal((2, s, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jh, jlast = JS._assoc_linear_scan(*map(jnp.asarray, (a, b, h0)))
    th, tlast = TS.linear_scan(*map(torch.from_numpy, (a, b, h0)))
    assert bool(torch.isfinite(th).all())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    if decay > 1:   # the cumprod form would not be finite here
        pa = np.cumprod(a, axis=1)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            q = b / pa
        assert not np.isfinite(q).all()


def test_mamba1_layer_matches_reference():
    """The layer at falcon-mamba's SMOKE widths: forward over 13 tokens
    (prime: chunks 8 + 5 here, 13 chunks of 1 in the reference) from a
    nonzero state, then three decode steps; fp32 within 1e-5."""
    jcfg, tcfg, jp, tp = weights()
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["mamba"])
    tl = {k: v[1] for k, v in tp["layers"]["mamba"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    h0 = {"h": rng.standard_normal((2, tcfg.d_inner, tcfg.ssm_state))
          .astype(np.float32),
          "conv": rng.standard_normal((2, tcfg.ssm_conv - 1, tcfg.d_inner))
          .astype(np.float32)}
    jy, jst = JS.mamba1_forward(jl, jcfg, jnp.asarray(x[:, :13]),
                                jax.tree.map(jnp.asarray, h0))
    ty, tst = TS.mamba1_forward(tl, tcfg, torch.from_numpy(x[:, :13]),
                                {k: torch.from_numpy(v)
                                 for k, v in h0.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=ATOL)
    for t in range(13, 16):
        jy, jst = JS.mamba1_decode(jl, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = TS.mamba1_decode(tl, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                   tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                               atol=ATOL)
    init = TS.mamba1_init_state(tcfg, 3, "cpu")
    want = JS.mamba1_init_state(jcfg, 3)
    for k in ("h", "conv"):
        assert tuple(init[k].shape) == want[k].shape
        assert str(init[k].dtype).split(".")[-1] == want[k].dtype.name


def test_prefill_and_decode_match_reference():
    """The stack: prefill of 13 tokens (its cache: every layer's h and
    conv tail) and three dense decode steps, fp32 within 1e-5."""
    jcfg, tcfg, jp, tp = weights()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert sorted(tc) == sorted(jc) == ["ssm"]
    jd, td = JTF.init_cache(jcfg, 2, 24), TTF.init_cache(tcfg, 2, 24, "cpu")
    assert sorted(td) == sorted(jd) == ["ssm"]
    jd["ssm"] = jc["ssm"]
    for nm, t in td["ssm"].items():
        assert tuple(t.shape) == jd["ssm"][nm].shape
        np.testing.assert_allclose(tc["ssm"][nm].numpy(),
                                   np.asarray(jc["ssm"][nm]), atol=ATOL)
        t.copy_(tc["ssm"][nm])
    lengths = np.full(2, 13, np.int32)
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jl, jd = j_decode(jp, jcfg, jnp.asarray(nxt), jd,
                          jnp.asarray(lengths))
        tl, td = TTF.decode_step(tp, tcfg, torch.from_numpy(nxt), td,
                                 torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lengths += 1
    for nm, t in td["ssm"].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jd["ssm"][nm]),
                                   atol=ATOL)


def test_engine_matches_reference_engine():
    """Both engines in lockstep: two prompts (one longer than the SMOKE
    chunk of 8), 8 rounds, finish_request, a third prompt into the freed
    slot, evict_user, flush and re-admission. Tokens equal, logits within
    1e-4, every slot's SSM state equal; the ``kv`` table stays empty in
    both (an attention-free stack allocates no block), every DELETE and
    FLUSH removes 0, and the page table and tail rows stay as the
    reference keeps them."""
    jcfg, tcfg, jp, tp = weights()
    rng = np.random.default_rng(3)
    p1, p2, p3 = (rng.integers(0, jcfg.vocab, size=n).astype(np.int32)
                  for n in (9, 21, 6))
    kw = dict(max_slots=4, max_seq=64, block=8)
    j, t = JEngine(jcfg, jp, **kw), TEngine(tcfg, tp, device="cpu", **kw)
    assert not t.attends and "arena" not in t.state
    assert sorted(t.state) == sorted(j.state) == ["ssm"]
    j_logits = []
    step = j._step

    def capture(*a):
        out = step(*a)
        j_logits.append(np.asarray(out[2]))
        return out
    j._step = capture

    def check():
        assert t.live_blocks() == j.live_blocks() == 0
        np.testing.assert_array_equal(t._pt.numpy(), np.asarray(j._pt))
        np.testing.assert_array_equal(t.tail_row.numpy(),
                                      np.asarray(j.tail_row))
        for nm, x in t.state["ssm"].items():
            np.testing.assert_allclose(x.numpy(),
                                       np.asarray(j.state["ssm"][nm]),
                                       atol=LOGIT_ATOL)

    def add(prompt, user):
        sj, st = (e.add_request(prompt, user_id=user) for e in (j, t))
        assert sj == st and t.requests[st].generated == \
            j.requests[sj].generated
        check()
        return st

    def rounds(n):
        for _ in range(n):
            assert t.decode_round() == j.decode_round()
            live = sorted(t.requests)
            np.testing.assert_allclose(t.logits.numpy()[live],
                                       j_logits[-1][live], atol=LOGIT_ATOL)
            check()

    s1 = add(p1, 1)
    add(p2, 2)
    rounds(8)
    assert t.finish_request(s1) == j.finish_request(s1) == 0
    add(p3, 2)
    rounds(2)
    assert t.evict_user(2) == j.evict_user(2) == 0
    assert not t.requests
    add(p1, 4)
    rounds(1)
    assert t.flush() == j.flush() == 0
    add(p2, 5)
    rounds(1)
    check()
