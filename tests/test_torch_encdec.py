"""The port's encoder-decoder (seamless-m4t-v2) against the JAX reference
on the CPU.

seamless's SMOKE weights are drawn by the reference (``init_model
(PRNGKey(0))``: the ``encoder`` subtree, each decoder layer's ``norm_x``
and ``cross``) and carried across; the same seeded numpy frames and
tokens go through both packages. fp32 throughout, so every comparison is
within 1e-5 (only the order of the sums differs): the non-causal
self-attention and the cross attention (with and without the reference's
``kv_valid`` tail mask, which the port computes plainly on the CPU), the
encoder, each decoder layer's cross K/V, the prefill (logits, the
decoder's KV and ``enc_k`` / ``enc_v``) and three dense decode steps with
``enc_valid`` masking part of one sequence's frames. Then 8 rounds of both
serving engines in lockstep with ``enc_frames`` on every request: equal
greedy tokens, logits within 1e-4, equal block counts and page tables."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import check_config, check_layout, engine_stream
from _torch_pair import smoke_weights
from repro.models import transformer as JTF
from repro.models.layers import attention as JA
from repro_torch.launch import serve as TSERVE
from repro_torch.models import transformer as TTF
from repro_torch.models.layers import attention as TA

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def weights():
    return smoke_weights(ARCH)


def _frames(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
            * 0.5).astype(np.float32)


def _close(got, want, atol=ATOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_config_matches_reference():
    check_config(ARCH)


def test_init_has_the_reference_layout():
    """The encoder's stacked GLOBAL blocks (no cross sublayer) and final
    norm; each decoder layer's ``norm_x`` and ``cross`` attention."""
    ours = check_layout(weights(), TTF.init_model)
    cfg = weights()[1]
    assert tuple(ours["encoder.layers.attn.wq"].shape) == (
        cfg.enc_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert "encoder.layers.cross.wq" not in ours
    assert "layers.cross.wk" in ours and "layers.norm_x.scale" in ours


@pytest.mark.parametrize("masked", [False, True])
def test_attention_forward_and_cross_attention_match_reference(masked):
    """Layer 0's non-causal self-attention (RoPE applied, as in the
    reference's encoder) and its cross attention of 5 queries over the
    frames' K/V (no RoPE); ``masked``: the reference's ``kv_valid`` /
    ``enc_valid`` tail mask, 3 and all 8 keys."""
    jcfg, tcfg, jp, tp = weights()
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = TTF.layer_params(tp, tcfg, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    q = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8))
    valid = np.array([3, 8], np.int32) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want = JA.attention_forward(jl["attn"], jcfg, jnp.asarray(x),
                                jnp.asarray(pos), theta=1e4, causal=False,
                                kv_valid=jv)
    got = TA.attention_forward(tl["attn"], tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()), theta=1e4,
                               causal=False, kv_valid=tv)
    _close(got, want)
    jk, jvv = JA.cross_kv(jl["cross"], jcfg, jnp.asarray(x))
    tk, tvv = TA.cross_kv(tl["cross"], tcfg, torch.from_numpy(x))
    _close(tk, jk)
    _close(tvv, jvv)
    want = JA.cross_attention(jl["cross"], jcfg, jnp.asarray(q), jk, jvv,
                              enc_valid=jv)
    got = TA.cross_attention(tl["cross"], tcfg, torch.from_numpy(q), tk, tvv,
                             enc_valid=tv)
    _close(got, want)


def test_encoder_and_prefill_match_reference():
    """run_encoder over 8 frames, encoder_cross_kv ([L, b, se, kh, hd]),
    and the prefill of 11 tokens: last-token logits, the decoder's
    collected KV and the cross K/V it returns."""
    jcfg, tcfg, jp, tp = weights()
    fr = _frames(tcfg, 2, 4)
    je = JTF.run_encoder(jp, jcfg, jnp.asarray(fr))
    te = TTF.run_encoder(tp, tcfg, torch.from_numpy(fr))
    _close(te, je)
    jk, jv = JTF.encoder_cross_kv(jp, jcfg, je)
    tk, tv = TTF.encoder_cross_kv(tp, tcfg, te)
    assert tuple(tk.shape) == (tcfg.n_layers, 2, tcfg.frontend_len,
                               tcfg.n_kv_heads, tcfg.head_dim)
    _close(tk, jk)
    _close(tv, jv)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    jl, jc = jax.jit(JTF.prefill, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(fr)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                    "enc_frames": torch.from_numpy(fr)})
    _close(tl, jl)
    assert sorted(tc) == sorted(jc) == ["enc_k", "enc_v", "k", "v"]
    for nm in tc:
        _close(tc[nm], jc[nm])


def test_decode_with_enc_valid_matches_reference():
    """Three dense decode steps after the prefill, ``enc_valid`` [5, 8]:
    the first sequence attends only its first 5 frames."""
    jcfg, tcfg, jp, tp = weights()
    fr = _frames(tcfg, 2, 6)
    s, L, se = 11, 20, tcfg.frontend_len
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (2, s)).astype(
        np.int32)
    jl, jc = jax.jit(JTF.prefill, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(fr)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                    "enc_frames": torch.from_numpy(fr)})
    jd = JTF.init_cache(jcfg, 2, L, enc_len=se)
    td = TTF.init_cache(tcfg, 2, L, "cpu", enc_len=se)
    assert sorted(td) == sorted(jd) == ["enc_k", "enc_v", "k", "v"]
    for nm in ("k", "v"):
        jd[nm] = jd[nm].at[:, :, :s].set(jc[nm])
        td[nm][:, :, :s] = tc[nm]
    for nm in ("enc_k", "enc_v"):
        jd[nm] = jc[nm]
        td[nm].copy_(tc[nm])
    valid = np.array([5, se], np.int32)
    lengths = np.full(2, s, np.int32)
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jl, jd = JTF.decode_step(jp, jcfg, jnp.asarray(nxt), jd,
                                 jnp.asarray(lengths),
                                 enc_valid=jnp.asarray(valid))
        tl, td = TTF.decode_step(tp, tcfg, torch.from_numpy(nxt), td,
                                 torch.from_numpy(lengths),
                                 enc_valid=torch.from_numpy(valid))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lengths += 1
    for nm in ("k", "v"):
        _close(td[nm], jd[nm])


def test_engine_matches_reference_engine():
    """``_torch_pair.engine_stream`` with fresh ``enc_frames`` on every
    admission; the state's ``enc_k`` / ``enc_v`` ``[L, slots, se, kh,
    hd]`` and the static ``enc_valid`` input (every slot's frontend_len),
    and the cross K/V of the live slots equal the reference's."""
    w = weights()
    cfg = w[1]
    rng = np.random.default_rng(8)
    frames = [(rng.standard_normal((cfg.frontend_len, cfg.d_model))
               * 0.5).astype(np.float32) for _ in range(4)]
    pr = engine_stream(w, extras=lambda i: {"enc_frames": frames[i]})
    assert pr.counts == (3, 6, 2)
    st = pr.t.state
    assert tuple(st["enc_k"].shape) == (cfg.n_layers, 4, cfg.frontend_len,
                                        cfg.n_kv_heads, cfg.head_dim)
    assert pr.t._step.inputs["enc_valid"].tolist() == [cfg.frontend_len] * 4
    for nm in ("enc_k", "enc_v"):   # slot 0 holds the last admission
        _close(st[nm][:, 0], np.asarray(pr.j.state[nm])[:, 0])


def test_launcher_needs_enc_frames():
    """The launcher sends text prompts only: like the reference's, it
    stops at seamless's prefill for want of ``enc_frames``."""
    with pytest.raises(KeyError, match="enc_frames"):
        TSERVE.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
