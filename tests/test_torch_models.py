"""The port's dense decoder against the JAX reference on the CPU.

yi-6b's SMOKE weights are drawn by the reference and carried across with
``repro_torch.convert.params_from_numpy``; the same seeded numpy tokens
then go through both packages' prefill and dense decode steps. Both
compute in fp32, so logits and the collected KV agree to 1e-5 (only the
order of the fp32 sums differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.layers import norms as JN
from repro.models.layers import rope as JROPE
from repro.models.params import split
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TTF
from repro_torch.models.config import NotPorted
from repro_torch.models.layers import norms as TN
from repro_torch.models.layers import rope as TROPE

ATOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = JC.get_smoke("yi-6b"), TC.get_smoke("yi-6b")
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
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
        j = getattr(__import__("repro.configs.yi_6b", fromlist=[name]), name)
        t = getattr(__import__("repro_torch.configs.yi_6b",
                               fromlist=[name]), name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "padded_vocab", "rope_theta",
                  "layer_pattern", "attn_layer_ids", "norm_eps"):
            assert getattr(j, f) == getattr(t, f), f
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_init_model_has_the_reference_layout(smoke):
    jcfg, tcfg, jp, _ = smoke
    gen = torch.Generator().manual_seed(0)
    ours = _leaves(TTF.init_model(gen, tcfg, "cpu"))
    theirs = _leaves(jp)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        assert ours[k].dtype == tcfg.dtype
    again = _leaves(TTF.init_model(torch.Generator().manual_seed(0), tcfg,
                                   "cpu"))
    assert all(torch.equal(ours[k], again[k]) for k in ours)  # seeded


def test_params_round_trip(smoke):
    _, tcfg, jp, tp = smoke
    back = _leaves(convert.params_to_numpy(tp))
    for k, v in _leaves(jp).items():
        np.testing.assert_array_equal(back[k], np.asarray(v))


def test_rope_and_norm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    want = JROPE.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)
    got = TROPE.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    h = rng.standard_normal((3, 5, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    want = JN.rms_norm(jnp.asarray(h), {"scale": jnp.asarray(g)}, 1e-6)
    got = TN.rms_norm(torch.from_numpy(h), {"scale": torch.from_numpy(g)},
                      1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_decode_match_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    rng = np.random.default_rng(1)
    s, L = 13, 24
    toks = rng.integers(0, jcfg.vocab, (2, s)).astype(np.int32)
    jl, jc = JTF.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for nm in ("k", "v"):
        assert tuple(tc[nm].shape) == jc[nm].shape
        np.testing.assert_allclose(tc[nm].numpy(), np.asarray(jc[nm]),
                                   atol=ATOL)
    # three dense decode steps from the prefilled cache
    jd = JTF.init_cache(jcfg, 2, L)
    td = TTF.init_cache(tcfg, 2, L, "cpu")
    for nm in ("k", "v"):
        jd[nm] = jd[nm].at[:, :, :s].set(jc[nm])
        td[nm][:, :, :s] = tc[nm]
    lengths = np.full(2, s, np.int32)
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jl, jd = JTF.decode_step(jp, jcfg, jnp.asarray(nxt), jd,
                                 jnp.asarray(lengths))
        tl, td = TTF.decode_step(tp, tcfg, torch.from_numpy(nxt), td,
                                 torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lengths += 1
    for nm in ("k", "v"):
        np.testing.assert_allclose(td[nm].numpy(), np.asarray(jd[nm]),
                                   atol=ATOL)


def test_padded_vocab_is_masked(smoke):
    _, tcfg, _, tp = smoke
    assert tcfg.padded_vocab > tcfg.vocab
    lg = TTF.logits_fn(tp, tcfg, torch.randn(3, tcfg.d_model))
    assert lg.dtype == torch.float32
    assert bool((lg[:, tcfg.vocab:] <= -1e29).all())


def test_unported_configs_raise():
    """Every arch of the reference is served now (``PORTED`` is all of
    ``ARCHS``); what the port still refuses raises ``NotPorted``: a
    stack of Mamba1 and Mamba2 layers. A device mesh for the serve state
    is ported (tests/test_torch_serve_mesh.py); one that is not a
    ``launch.mesh.Mesh`` raises TypeError."""
    assert TC.PORTED == set(TC.ARCHS)
    assert set(TC.all_archs()) == set(JC.all_archs())
    for arch in TC.ARCHS:
        assert TC.get_smoke(arch).name == JC.get_smoke(arch).name
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")
    import dataclasses

    from repro_torch.serving import engine as TE
    from repro_torch.serving.paged import PagedGeom
    cfg = TC.get_smoke("yi-6b")
    geom = PagedGeom(8, 4, 2, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads)
    with pytest.raises(TypeError):
        TE.serve_state_specs(cfg, geom, mesh=object())
    mixed = dataclasses.replace(TC.get_smoke("zamba2-2.7b"),
                                layer_pattern=("mamba1",) + ("mamba2",) * 3,
                                shared_attn_every=0, scan_group=1)
    with pytest.raises(NotPorted):
        TTF.init_model(torch.Generator(), mixed, "cpu")


# ------------------------------------------------------------------ zamba2
@pytest.fixture(scope="module")
def zamba():
    """zamba2 SMOKE (4 Mamba2 layers, the shared block after every 2nd),
    drawn by the reference and carried across, with A_log, D and dt_bias
    made nonzero so that the decay and skip paths are exercised."""
    jcfg, tcfg = JC.get_smoke("zamba2-2.7b"), TC.get_smoke("zamba2-2.7b")
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    rng = np.random.default_rng(5)
    for name in ("A_log", "D", "dt_bias"):
        leaf = jp["layers"]["mamba"][name]
        jp["layers"]["mamba"][name] = jnp.asarray(
            rng.standard_normal(leaf.shape) * 0.5, jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _close_tree(got, want, atol=ATOL):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close_tree(got[k], want[k], atol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_zamba2_config_matches_reference():
    for name in ("CONFIG", "SMOKE"):
        j = getattr(__import__("repro.configs.zamba2_2p7b", fromlist=[name]),
                    name)
        t = getattr(__import__("repro_torch.configs.zamba2_2p7b",
                               fromlist=[name]), name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "padded_vocab", "layer_pattern",
                  "shared_attn_every", "scan_group", "ssm_state", "ssm_conv",
                  "ssm_expand", "ssm_head_dim", "ssm_chunk", "d_inner",
                  "ssm_heads", "rope_theta", "norm_eps"):
            assert getattr(j, f) == getattr(t, f), f
        assert j.n_shared_applications() == t.n_shared_applications()
        assert j.param_count() == t.param_count()
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_zamba2_init_has_the_reference_layout(zamba):
    jcfg, tcfg, jp, _ = zamba
    ours = _leaves(TTF.init_model(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    theirs = _leaves(jp)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        assert str(ours[k].dtype).split(".")[-1] == np.asarray(v).dtype.name


def test_zamba2_prefill_and_decode_match_reference(zamba):
    """Prefill logits and the whole cache (SSM states, the shared block's
    KV), then three dense decode steps from it."""
    jcfg, tcfg, jp, tp = zamba
    j_prefill = jax.jit(JTF.prefill, static_argnums=1)
    j_decode = jax.jit(JTF.decode_step, static_argnums=1)
    rng = np.random.default_rng(1)
    s, L = 13, 24
    toks = rng.integers(0, jcfg.vocab, (2, s)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _close_tree(tc, jc)
    jd = JTF.init_cache(jcfg, 2, L)
    td = TTF.init_cache(tcfg, 2, L, "cpu")
    assert sorted(td) == sorted(jd) == ["shared_k", "shared_v", "ssm"]
    for nm in ("shared_k", "shared_v"):
        jd[nm] = jd[nm].at[:, :, :s].set(jc[nm])
        td[nm][:, :, :s] = tc[nm]
    jd["ssm"] = jc["ssm"]
    for nm, t in td["ssm"].items():
        t.copy_(tc["ssm"][nm])
    lengths = np.full(2, s, np.int32)
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jl, jd = j_decode(jp, jcfg, jnp.asarray(nxt), jd,
                          jnp.asarray(lengths))
        tl, td = TTF.decode_step(tp, tcfg, torch.from_numpy(nxt), td,
                                 torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lengths += 1
    _close_tree(td, jd)


def test_params_keep_the_reference_fp32_leaves_at_bf16():
    """At a bf16 config the reference keeps A_log, D and dt_bias in fp32;
    carrying the tree across (and back through params_to_numpy, whose
    leaves are all fp32) keeps them fp32 and exact, and every other leaf
    in bf16."""
    import dataclasses
    jcfg = dataclasses.replace(JC.get_smoke("zamba2-2.7b"),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.get_smoke("zamba2-2.7b"),
                               dtype=torch.bfloat16)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    # values that bf16 cannot hold
    jp["layers"]["mamba"]["dt_bias"] = jnp.full(
        jp["layers"]["mamba"]["dt_bias"].shape, 0.1234567, jnp.float32)
    want = _leaves(jax.tree.map(np.asarray, jp))
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    again = convert.params_from_numpy(tcfg, convert.params_to_numpy(tp),
                                      "cpu")
    for tree in (tp, again):
        got = _leaves(tree)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            fp32 = k.rsplit(".", 1)[-1] in ("A_log", "D", "dt_bias")
            assert got[k].dtype == (torch.float32 if fp32 else torch.bfloat16)
            assert v.dtype.name == ("float32" if fp32 else "bfloat16"), k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          v.astype(np.float32))
