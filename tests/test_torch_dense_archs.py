"""The port's other dense decoders against the JAX reference on the CPU:
gemma2-2b (sandwich norms, alternating local / global layers, both
softcaps, scaled embeddings), gemma3-27b (q/k norms too, 5 local : 1
global with a tail, two rope thetas) and starcoder2-7b (36 / 4 heads,
plain GELU MLP).

Each SMOKE config's weights are drawn by the reference
(``init_model(PRNGKey(0))``), with the sandwich and q/k norm gains made
non-trivial from a seed (the reference initialises them to ones, which
would hide a norm applied in the wrong place), and carried across with
``convert.params_from_numpy``. The same seeded numpy tokens then go
through both packages: prefill logits and the collected KV, and three
dense decode steps, within 1e-5 (fp32: only the order of the sums
differs); then 8 rounds of both serving engines in lockstep with equal
greedy tokens, logits within 1e-4 (fp32; summation order and the port's
write-then-attend island against the reference's self term) and equal
block counts and page tables after every statement. The prompts are
longer than the SMOKE window (8), so the local layers' window binds in
the prefill and in the paged decode."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.layers import attention as JA
from repro.models.layers import norms as JN
from repro.models.params import split
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TTF
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import norms as TN
from repro_torch.serving.engine import ServeEngine as TEngine

ATOL = 1e-5
LOGIT_ATOL = 1e-4
ARCHS = ["gemma2-2b", "gemma3-27b", "starcoder2-7b"]
GAINS = ("norm1_post", "norm2_post")   # and attn.q_norm / attn.k_norm

j_prefill = jax.jit(JTF.prefill, static_argnums=1)
j_decode = jax.jit(JTF.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def weights(arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    rng = np.random.default_rng(7)

    def perturb(tree, name):
        leaf = tree[name]
        tree[name] = jnp.asarray(1 + 0.5 * rng.standard_normal(leaf.shape),
                                 leaf.dtype)
    blocks = [jp["layers"]] + [jp[f"tail_{t}"]
                               for t in range(TTF.scan_layout(tcfg)[2])]
    for blk in blocks:
        for name in GAINS:
            if name in blk:
                perturb(blk[name], "scale")
        for name in ("q_norm", "k_norm"):
            if name in blk["attn"]:
                perturb(blk["attn"], name)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    mod = TC.ARCHS[arch]
    for name in ("CONFIG", "SMOKE"):
        j = getattr(__import__(f"repro.configs.{mod}", fromlist=[name]), name)
        t = getattr(__import__(f"repro_torch.configs.{mod}",
                               fromlist=[name]), name)
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), f.name
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
        for f in ("padded_vocab", "attn_layer_ids"):
            assert getattr(j, f) == getattr(t, f), f
        assert j.param_count() == t.param_count()
    assert arch in TC.PORTED
    assert TC.get_config(arch) is getattr(__import__(
        f"repro_torch.configs.{mod}", fromlist=["CONFIG"]), "CONFIG")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_layout(arch):
    """The port's seeded init has the reference's leaves, shapes and
    dtypes: the sandwich norms beside each block's norms, the q/k norms
    ``[layers, hd]`` in the attention (gemma3), the tail layers apart."""
    jcfg, tcfg, jp, _ = weights(arch)
    ours = _leaves(TTF.init_model(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    theirs = _leaves(jp)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        assert ours[k].dtype == tcfg.dtype, k
    assert ("layers.norm1_post.scale" in ours) == tcfg.sandwich_norm
    assert ("layers.attn.q_norm" in ours) == tcfg.qk_norm


def test_rms_norm_gain_matches_reference():
    """The per-head norm with a raw gain: fp32 statistics over hd, output
    in x's dtype (fp32 within 1e-5; bf16 equal up to one rounding)."""
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 4, 16))).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    want = JN.rms_norm_gain(jnp.asarray(x), jnp.asarray(g), 1e-6)
    got = TN.rms_norm_gain(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want = JN.rms_norm_gain(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(g, jnp.bfloat16), 1e-6)
    got = TN.rms_norm_gain(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(g).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 13 tokens (past the SMOKE window of 8) and three dense
    decode steps from its cache, fp32, within 1e-5."""
    jcfg, tcfg, jp, tp = weights(arch)
    rng = np.random.default_rng(1)
    s, L = 13, 24
    toks = rng.integers(0, jcfg.vocab, (2, s)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TTF.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for nm in ("k", "v"):
        assert tuple(tc[nm].shape) == jc[nm].shape
        np.testing.assert_allclose(tc[nm].numpy(), np.asarray(jc[nm]),
                                   atol=ATOL)
    jd = JTF.init_cache(jcfg, 2, L)
    td = TTF.init_cache(tcfg, 2, L, "cpu")
    for nm in ("k", "v"):
        jd[nm] = jd[nm].at[:, :, :s].set(jc[nm])
        td[nm][:, :, :s] = tc[nm]
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
    for nm in ("k", "v"):
        np.testing.assert_allclose(td[nm].numpy(), np.asarray(jd[nm]),
                                   atol=ATOL)


class Pair:
    """A reference engine and a port engine driven in lockstep; the
    reference's round logits are captured from its step."""

    def __init__(self, w, **kw):
        jcfg, tcfg, jp, tp = w
        self.j = JEngine(jcfg, jp, **kw)
        self.t = TEngine(tcfg, tp, device="cpu", **kw)
        self.j_logits = []
        step = self.j._step

        def capture(*a):
            out = step(*a)
            self.j_logits.append(np.asarray(out[2]))
            return out
        self.j._step = capture

    def check_tables(self):
        assert self.t.live_blocks() == self.j.live_blocks()
        np.testing.assert_array_equal(self.t._pt.numpy(),
                                      np.asarray(self.j._pt))
        np.testing.assert_array_equal(self.t.tail_row.numpy(),
                                      np.asarray(self.j.tail_row))

    def add(self, prompt, user_id):
        sj = self.j.add_request(prompt, user_id=user_id)
        st = self.t.add_request(prompt, user_id=user_id)
        assert sj == st
        assert self.t.requests[st].generated == self.j.requests[sj].generated
        self.check_tables()
        return st

    def rounds(self, n):
        for _ in range(n):
            assert self.t.decode_round() == self.j.decode_round()
            live = sorted(self.t.requests)
            np.testing.assert_allclose(self.t.logits.numpy()[live],
                                       self.j_logits[-1][live],
                                       atol=LOGIT_ATOL)
            self.check_tables()

    def check_arena(self):
        """The arena's live rows: the normed, roped K and the V each
        engine wrote."""
        pt = self.t._pt.numpy()
        rows = np.unique(pt[pt < self.t.cap])
        np.testing.assert_allclose(self.t.state["arena"][:, rows].numpy(),
                                   np.asarray(self.j.state["arena"])[:, rows],
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch):
    """Two prompts past the window through both engines, 8 rounds (both
    cross a block boundary), then finish_request, a third prompt into the
    freed rows, evict_user and flush, with equal counts."""
    w = weights(arch)
    rng = np.random.default_rng(3)
    p1, p2, p3 = (rng.integers(0, w[0].vocab, size=n).astype(np.int32)
                  for n in (9, 15, 12))
    pr = Pair(w, max_slots=4, max_seq=64, block=8)
    s1 = pr.add(p1, 1)
    pr.add(p2, 2)
    pr.rounds(8)
    pr.check_arena()
    n = pr.t.finish_request(s1)
    assert n == pr.j.finish_request(s1) == 3
    pr.check_tables()
    pr.add(p3, 2)
    pr.rounds(2)
    pr.check_arena()
    assert pr.t.evict_user(2) == pr.j.evict_user(2) == 4 + 2  # 25, 14
    assert not pr.t.requests and pr.t.live_blocks() == 0
    pr.check_tables()
    pr.add(p1, 4)
    pr.rounds(1)
    assert pr.t.flush() == pr.j.flush() == 2
    pr.check_tables()


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode_paged_matches_reference(window):
    """The reference's pure-JAX paged decode (q/k norms and RoPE on the
    new token, the pool in its table layout with missing pages, the self
    term, the ``<= window`` mask) against the port's plain counterpart at
    gemma3's SMOKE widths, fp32 within 1e-5."""
    jcfg, tcfg, jp, tp = weights("gemma3-27b")
    layer = 1
    jl = jax.tree.map(lambda a: a[layer], jp["layers"]["attn"])
    tl = {k: v[layer] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(4)
    b, cap, nlayers, block, nb = 3, 17, 3, 4, 5
    kh, hd = tcfg.n_kv_heads, tcfg.head_dim
    pool = rng.standard_normal((cap, nlayers, 2, block, kh, hd)).astype(
        np.float32)
    pages = rng.permutation(cap)[:b * nb].reshape(b, nb).astype(np.int32)
    pages[0, 3:] = cap            # a short sequence: missing tail pages
    pages[1, 1] = cap             # a missing page inside a sequence
    lengths = np.array([11, 19, 0], np.int32)
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    want = JA.attention_decode_paged(
        jl, jcfg, jnp.asarray(x), jnp.asarray(pool), jnp.asarray(pages),
        jnp.asarray(lengths), theta=1e4, layer_idx=layer, window=window)
    got = TA.attention_decode_paged(
        tl, tcfg, *map(torch.from_numpy, (x, pool, pages, lengths)),
        theta=1e4, layer_idx=layer, window=window)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
