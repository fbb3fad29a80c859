"""The port's sequence-parallel attention against the JAX reference's
mathematics on the CPU.

The reference's ``_seqpar_attention`` runs only under ``axis_rules`` with
a mesh, where jax 0.9 refuses its sharding constraints (ROADMAP
"Reference caveats"), so the port's is held against what it computes:

* per shard, the reference's ``chunked_attention(..., q_positions=...)``
  over the full K/V, the positions of that shard's queries (causal,
  window, softcap, GQA; fp32 within the flash tests' 2e-5);
* whole, the reference's ``attention_forward`` without a mesh, for the
  port's ``attention_forward`` with ``attn_seq_shard`` under
  ``axis_rules(DEFAULT_RULES, mesh)`` over ``make_debug_mesh`` (the CPU
  repeated under ``force_device_count``), and ``None`` (the mesh-free
  path) for a sequence that does not split over 'model';
* the gradients of that sub-layer's input and weights (gemma2-2b and
  starcoder2-7b SMOKE, the archs of the reference's
  tests/test_seqpar_attention.py) with ``attn_seq_shard`` over a 'model'
  axis of 4 against ``jax.grad`` of the reference's mesh-free one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models.layers import attention as JA
from repro.models.params import KeyGen, split
from repro_torch import configs as TC
from repro_torch.launch import mesh as TM
from repro_torch.models.layers import attention as TA
from repro_torch.parallel import sharding as TS

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_torch_attention.py's fp32


def mesh_of(n_data, n_model):
    with TM.force_device_count(n_data * n_model):
        return TM.make_debug_mesh(n_data, n_model, device="cpu")


@dataclasses.dataclass(frozen=True)
class Cfg:
    attn_softcap: float = 0.0
    head_dim: int = 16
    attn_scale: float = 0.0


# (b, s, h, kh, hd, causal, window, softcap, n_model)
CASES = [(2, 32, 4, 4, 16, True, 0, 0.0, 4),
         (1, 48, 8, 2, 16, True, 0, 0.0, 4),      # GQA 4
         (2, 40, 4, 2, 8, True, 7, 0.0, 2),       # a window shards cross
         (1, 64, 6, 3, 16, True, 0, 30.0, 4),     # softcap
         (2, 24, 4, 4, 16, False, 0, 0.0, 3),     # non-causal
         (1, 64, 4, 1, 32, True, 20, 50.0, 8)]


def _qkv(rng, b, s, h, kh, hd):
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kh, hd)).astype(np.float32),
            rng.standard_normal((b, s, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_shards_match_reference_chunked_attention_with_positions(case):
    b, s, h, kh, hd, causal, window, softcap, n_model = case
    q, k, v = _qkv(np.random.default_rng(s + h), b, s, h, kh, hd)
    cfg = Cfg(attn_softcap=softcap, head_dim=hd)
    got = TA._seqpar_attention(cfg, *map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window,
                               mesh=mesh_of(1, n_model))
    sl = s // n_model
    shard = jax.jit(lambda q, k, v, pos: JA.chunked_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        scale=hd ** -0.5, q_block=min(16, sl), kv_block=16,
        q_positions=pos))
    for i in range(n_model):
        want = shard(jnp.asarray(q[:, i * sl:(i + 1) * sl]), jnp.asarray(k),
                     jnp.asarray(v), i * sl + jnp.arange(sl))
        np.testing.assert_allclose(got[:, i * sl:(i + 1) * sl].numpy(),
                                   np.asarray(want), **TOL)


def test_ragged_sequence_falls_back():
    q, k, v = map(torch.from_numpy,
                  _qkv(np.random.default_rng(0), 1, 30, 4, 4, 16))
    assert TA._seqpar_attention(Cfg(), q, k, v, causal=True, window=0,
                                mesh=mesh_of(1, 4)) is None


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """One attention layer of the arch's SMOKE config, drawn by the
    reference (``init_attention``) and carried across."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp = jax.jit(lambda k: split(JA.init_attention(KeyGen(k), jcfg))[0])(
        jax.random.PRNGKey(2))
    return jcfg, tcfg, jp, {k: torch.from_numpy(np.asarray(v).copy())
                            for k, v in jp.items()}


@pytest.mark.parametrize("arch,s,window", [("gemma2-2b", 32, 8),
                                           ("gemma2-2b", 32, 0),
                                           ("starcoder2-7b", 24, 0),
                                           ("yi-6b", 30, 0)])
@pytest.mark.parametrize("n_data,n_model", [(2, 2), (1, 4)])
def test_attention_forward_seq_sharded_matches_reference(arch, s, window,
                                                         n_data, n_model):
    """The port's attention_forward with ``attn_seq_shard`` under a mesh
    against the reference's without one (yi-6b's 30 tokens over 4: the
    ragged fallback; over 2 they split)."""
    jcfg, tcfg, jp, tattn = _weights(arch)
    x = np.random.default_rng(3).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jax.jit(lambda p, x, pos: JA.attention_forward(
        p, jcfg, x, pos, theta=jcfg.rope_theta, window=window))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    cfg = dataclasses.replace(tcfg, attn_seq_shard=True)
    calls = []
    real = TA._seqpar_attention

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out is not None)
        return out
    TA._seqpar_attention = spy
    try:
        with TS.axis_rules(TS.DEFAULT_RULES, mesh_of(n_data, n_model)):
            got = TA.attention_forward(tattn, cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()),
                                       theta=tcfg.rope_theta, window=window)
    finally:
        TA._seqpar_attention = real
    assert calls == [s % n_model == 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,window", [("gemma2-2b", 8),
                                         ("starcoder2-7b", 0)])
def test_seqpar_gradients_match_reference(arch, window):
    """The gradient through the split, the shards and the concatenation:
    the port's attention_forward with ``attn_seq_shard`` over a 'model'
    axis of 4 under autograd against ``jax.grad`` of the reference's
    mesh-free attention_forward (its weights and input), within the
    training tests' 1e-4 of each gradient's largest entry."""
    jcfg, tcfg, jp, tattn = _weights(arch)
    s = 32
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))

    def loss(p, x):
        o = JA.attention_forward(p, jcfg, x, jnp.asarray(pos),
                                 theta=jcfg.rope_theta, window=window)
        return jnp.sum(o * jnp.asarray(w))
    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    cfg = dataclasses.replace(tcfg, attn_seq_shard=True)
    tp = {k: t.clone().requires_grad_(True) for k, t in tattn.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    with TS.axis_rules(TS.DEFAULT_RULES, mesh_of(1, 4)):
        o = TA.attention_forward(tp, cfg, tx, torch.from_numpy(pos.copy()),
                                 theta=tcfg.rope_theta, window=window)
    grads = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                                [tx] + list(tp.values()))
    for name, g, want in zip(["x"] + list(tp), grads,
                             [jgx] + [jgp[k] for k in tp]):
        want = np.asarray(want)
        top = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * top, name


def test_seqpar_leaves_the_model_without_a_mesh_alone():
    """``attn_seq_shard`` without a current mesh (or with one that has no
    'model' axis) is the mesh-free path, call for call."""
    jcfg, tcfg, _, tattn = _weights("gemma2-2b")
    cfg = dataclasses.replace(tcfg, attn_seq_shard=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(16)[None]
    base = TA.attention_forward(tattn, tcfg, x, pos, theta=1e4)
    with TM.force_device_count(2):
        lanes = TM.make_mesh((2,), ("data",), device="cpu")
    for mesh in (None, lanes):
        with TS.axis_rules(TS.DEFAULT_RULES, mesh):
            got = TA.attention_forward(tattn, cfg, x, pos, theta=1e4)
        assert torch.equal(got, base)


def test_remat_recompute_keeps_the_forwards_mesh():
    """Under ``remat="full"`` the backward recomputes each scan unit, on
    autograd's own thread for a card's tensors: the recompute must take
    the sequence-parallel path again (the forward's rules and mesh), so
    the backward here runs on another thread, where none are installed.
    Loss and gradients equal the mesh-free step's within the training
    tests' bounds."""
    import threading

    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import transformer as TTF
    from repro_torch.optim.adamw import tree_leaves
    tcfg = TC.get_smoke("gemma2-2b")
    tp = TTF.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in
          make_batch(tcfg, 2, 32, seed=3).items()}
    flat = tree_leaves(tp)
    for t in flat:
        t.requires_grad_(True)
    calls = []
    real = TA._seqpar_attention

    def spy(*a, **kw):
        calls.append(threading.current_thread().name)
        return real(*a, **kw)

    def grads(cfg, mesh):
        out = {}
        with TS.axis_rules(TS.DEFAULT_RULES, mesh):
            out["loss"] = TTF.train_loss(tp, cfg, tb, remat="full")[0]

        def back():   # outside the scope, as autograd's device thread is
            out["g"] = torch.autograd.grad(out["loss"], flat)
        th = threading.Thread(target=back, name="backward")
        th.start()
        th.join()
        return out["loss"], out["g"]
    base, g0 = grads(tcfg, None)
    TA._seqpar_attention = spy
    try:
        loss, g1 = grads(dataclasses.replace(tcfg, attn_seq_shard=True),
                         mesh_of(1, 4))
    finally:
        TA._seqpar_attention = real
    n_attn = tcfg.n_layers
    assert calls[:n_attn] == ["MainThread"] * n_attn
    assert calls[n_attn:] and set(calls[n_attn:]) == {"backward"}
    assert abs(float(loss.detach()) - float(base.detach())) <= 1e-5
    for a, b in zip(g1, g0):
        top = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-4 * top
