"""The port's MoE feed-forward and its two MoE decoders (granite-moe-1b:
32 experts top-8 in the full config; phi3.5-moe: 16 experts top-2)
against the JAX reference on the CPU.

The router: fp32 softmax over the logits, the top k renormalised, the
Switch aux loss, within 1e-6 (fp32: only summation order differs); with
duplicated router columns, which make probabilities tie exactly, the port
must choose the experts ``jax.lax.top_k`` chooses (the lower index). Both
dispatches (dense, and ragged with and without dropped tokens) within
1e-5. Each SMOKE config's weights are drawn by the reference and carried
across; prefill and three dense decode steps within 1e-5. The serving
engines in lockstep are in ``test_torch_moe_engine.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import check_config, check_layout, smoke_weights
from repro.models import transformer as JTF
from repro.models.layers import moe as JM
from repro_torch.models import transformer as TTF
from repro_torch.models.layers import moe as TM

ATOL = 1e-5
ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]

weights = functools.lru_cache(maxsize=None)(smoke_weights)


class Cfg:
    """The fields the MoE layer reads."""

    def __init__(self, d, f, e, k, gated=True, act="silu"):
        self.d_model, self.d_ff, self.n_experts, self.top_k = d, f, e, k
        self.mlp_gated, self.mlp_act = gated, act
        self.dtype = torch.float32


def _layer(rng, cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if not cfg.mlp_gated:
        del p["w_gate"]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    check_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_layout(arch):
    """The experts' leaves ``[layers, e, ...]`` and the router ``[layers,
    d, e]`` where the MLP was."""
    ours = check_layout(weights(arch), TTF.init_model)
    cfg = weights(arch)[1]
    assert tuple(ours["layers.mlp.w_up"].shape) == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert tuple(ours["layers.mlp.router"].shape) == (
        cfg.n_layers, cfg.d_model, cfg.n_experts)


@pytest.mark.parametrize("e,k", [(4, 2), (32, 8), (16, 2)])
def test_router_probs_match_reference(e, k):
    cfg = Cfg(64, 32, e, k)
    rng = np.random.default_rng(e)
    p = _layer(rng, cfg)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jp, jx, tp, tx = _both(p, x)
    jw, jaux = JM.router_probs(jp, cfg, jx)
    tw, taux = TM.router_probs(tp, cfg, tx)
    np.testing.assert_array_equal(tw.numpy() > 0, np.asarray(jw) > 0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_router_ties_choose_the_lower_index():
    """Router columns duplicated in pairs: every probability ties with its
    twin exactly, so the k-th and (k+1)-th of each token tie; the port
    must keep the reference's (lower-index) choice. ``top_k`` itself
    against ``jax.lax.top_k`` on rows full of ties."""
    cfg = Cfg(64, 32, 8, 3)
    rng = np.random.default_rng(3)
    p = _layer(rng, cfg)
    p["router"][:, 1::2] = p["router"][:, 0::2]
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    jp, jx, tp, tx = _both(p, x)
    jw, _ = JM.router_probs(jp, cfg, jx)
    tw, _ = TM.router_probs(tp, cfg, tx)
    chosen = tw.numpy() > 0
    np.testing.assert_array_equal(chosen, np.asarray(jw) > 0)
    # the tie at the boundary goes to the even (lower) twin everywhere
    assert chosen.sum(axis=-1).tolist() == [[3] * 11] * 3
    assert (chosen[..., 0::2].sum(axis=-1) == 2).all()
    vals = rng.integers(0, 4, (50, 16)).astype(np.float32)
    for kk in (1, 3, 8, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(vals), kk)
        tv, ti = TM.top_k(torch.from_numpy(vals), kk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "relu")])
def test_dense_dispatch_matches_reference(gated, act):
    cfg = Cfg(64, 48, 16, 2, gated, act)
    rng = np.random.default_rng(5)
    p = _layer(rng, cfg)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jp, jx, tp, tx = _both(p, x)
    jo, jaux = JM.moe_forward(jp, cfg, jx)
    to, taux = TM.moe_forward(tp, cfg, tx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("drop", [False, True])
def test_ragged_dispatch_matches_reference(drop):
    """Without drops (every expert's buffer holds its tokens) the ragged
    dispatch equals the dense one; with a router that sends every token
    to expert 0, 64 tokens overflow its capacity of 40 and the dropped
    (token, slot) pairs contribute nothing, as in the reference."""
    cfg = Cfg(64, 48, 4, 2)
    rng = np.random.default_rng(6)
    p = _layer(rng, cfg)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    if drop:
        x = np.abs(x)
        p["router"][:, 0] = 1.0
    jp, jx, tp, tx = _both(p, x)
    jo, jaux = JM.moe_forward(jp, cfg, jx, ragged=True)
    to, taux = TM.moe_forward(tp, cfg, tx, ragged=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    dense, _ = TM.moe_forward(tp, cfg, tx)
    gap = float((dense - to).abs().max())
    assert (gap > 1e-2) if drop else (gap <= ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 13 tokens and three dense decode steps from its cache,
    fp32, within 1e-5; the router's aux loss of the stack too."""
    jcfg, tcfg, jp, tp = weights(arch)
    rng = np.random.default_rng(1)
    s, L = 13, 24
    toks = rng.integers(0, jcfg.vocab, (2, s)).astype(np.int32)
    jl, jc = jax.jit(JTF.prefill, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for nm in ("k", "v"):
        np.testing.assert_allclose(tc[nm].numpy(), np.asarray(jc[nm]),
                                   atol=ATOL)
    x = TTF.assemble_inputs(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    pos = torch.arange(s)[None].expand(2, s)
    _, taux, _ = TTF.run_stack(tp, tcfg, x, pos)
    jx = JTF.assemble_inputs(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _, jaux, _ = JTF.run_stack(jp, jcfg, jx, jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jd, td = JTF.init_cache(jcfg, 2, L), TTF.init_cache(tcfg, 2, L, "cpu")
    for nm in ("k", "v"):
        jd[nm] = jd[nm].at[:, :, :s].set(jc[nm])
        td[nm][:, :, :s] = tc[nm]
    lengths = np.full(2, s, np.int32)
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    j_decode = jax.jit(JTF.decode_step, static_argnums=1)
    for _ in range(3):
        jl, jd = j_decode(jp, jcfg, jnp.asarray(nxt), jd,
                          jnp.asarray(lengths))
        tl, td = TTF.decode_step(tp, tcfg, torch.from_numpy(nxt), td,
                                 torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lengths += 1
