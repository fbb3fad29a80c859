"""The flash-attention backward's plain version against autograd and
against the reference, on the CPU.

``flash_attention_bwd_ref`` (the formulas the CUDA backward kernels run:
P recomputed from the row log-sum-exp, D = rowsum(dO o O), dS = P (dP -
D)) must give what ``torch.autograd`` gives for the plain forward
``flash_attention_ref``, and what ``jax.vjp`` gives for the reference's
jnp ``chunked_attention`` (which the reference differentiates in
training), on the same seeded numpy inputs: fp32 within 1e-5 (the order
of the fp32 sums). The cases are the backward kernels' on the card:
causal and not, ``q_offset``, windows, softcap 50, GQA groups 1, 2, 7 and
8, sq != sk, ragged lengths and rows that see no key (the reference's
``chunked_attention`` runs with whole-sequence blocks there: its block
skipping drops such rows' keys, where its own Pallas kernel, the port's
kernels and the plain version give them the mean of V). On the CPU the
Mamba2 scan's plain version is differentiated by autograd (on the card
its gradient is the backward kernel's: ``tests/test_torch_mamba2_bwd.py``
holds its plain version)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import chunked_attention
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS

TOL = 1e-5

# (b, h, kh, sq, sk, hd, causal, window, softcap, q_offset)
CASES = [
    (2, 4, 4, 32, 32, 16, True, 0, 0.0, 0),
    (1, 8, 4, 40, 40, 8, True, 0, 0.0, 0),        # GQA 2
    (1, 7, 1, 20, 20, 8, True, 0, 50.0, 0),       # GQA 7, softcap 50
    (1, 8, 1, 33, 33, 16, True, 0, 0.0, 0),       # GQA 8
    (2, 4, 2, 24, 48, 32, False, 0, 0.0, 0),      # not causal, sq != sk
    (1, 4, 4, 64, 64, 16, True, 12, 0.0, 0),      # window crossed
    (2, 2, 2, 37, 37, 16, True, 10, 30.0, 0),     # window + softcap, ragged
    (1, 4, 2, 13, 40, 16, True, 7, 20.0, 27),     # q_offset
    (1, 4, 4, 3, 64, 8, False, 0, 0.0, 0),        # cross: few queries
    (1, 4, 2, 16, 16, 16, True, 4, 0.0, 8),       # rows that see no key
    (1, 4, 4, 30, 20, 8, False, 6, 10.0, 5),      # the same, not causal
]


def _inputs(case):
    b, h, kh, sq, sk, hd = case[:6]
    rng = np.random.default_rng(sq * 7 + hd + h)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd),
                  (b, h, sq, hd)))


def _kw(case):
    causal, window, softcap, q_offset = case[6:]
    return dict(scale=case[5] ** -0.5, causal=causal, window=window,
                softcap=softcap, q_offset=q_offset)


def _err(got, want):
    return max(float((torch.as_tensor(np.asarray(a)) - b).abs().max())
               for a, b in zip(got, want))


def _plain_bwd(qn, kn, vn, don, kw):
    q, k, v, do = (torch.tensor(x) for x in (qn, kn, vn, don))
    o = FA.flash_attention_ref(q, k, v, **kw)
    lse = FA.attention_lse_ref(q, k, **kw)
    return FA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_autograd(case):
    qn, kn, vn, don = _inputs(case)
    kw = _kw(case)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    FA.flash_attention_ref(q, k, v, **kw).backward(torch.tensor(don))
    got = _plain_bwd(qn, kn, vn, don, kw)
    assert all(g.dtype == torch.float32 for g in got)
    assert _err((q.grad, k.grad, v.grad), got) <= TOL


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_reference_vjp(case):
    qn, kn, vn, don = _inputs(case)
    kw = _kw(case)

    def f(q, k, v):
        return chunked_attention(q, k, v, causal=kw["causal"],
                                 window=kw["window"], softcap=kw["softcap"],
                                 scale=kw["scale"], q_offset=kw["q_offset"])
    tr = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    _, vjp = jax.vjp(f, tr(qn), tr(kn), tr(vn))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(tr(don))]
    assert _err(want, _plain_bwd(qn, kn, vn, don, kw)) <= TOL


@pytest.mark.parametrize("case", CASES[:4] + CASES[-2:])
def test_lse_is_the_softmax_normaliser(case):
    """P = exp(s - lse) sums to 1 over the keys of every row that sees
    one; a row that sees none keeps -1e30."""
    qn, kn, _, _ = _inputs(case)
    kw = _kw(case)
    q, k = torch.tensor(qn), torch.tensor(kn)
    lse = FA.attention_lse_ref(q, k, **kw)
    mask, blind = FA._masks(q.shape[2], k.shape[2], kw["causal"],
                            kw["window"], kw["q_offset"], q.device)
    s = FA._capped_scores(q, k, scale=kw["scale"], softcap=kw["softcap"])
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0).sum(-1)
    assert torch.allclose(p[..., ~blind], torch.ones_like(p[..., ~blind]),
                          atol=1e-5)
    assert bool((lse[..., blind] <= -1e29).all())


@pytest.mark.parametrize("case", CASES[:2] + CASES[-2:])
def test_bwd_delta_is_the_row_sum_of_do_times_o(case):
    """The delta wrapper's D on the port's output equals rowsum(dO * O)
    of the reference's output."""
    qn, kn, vn, don = _inputs(case)
    kw = _kw(case)
    q, k, v = (torch.tensor(x) for x in (qn, kn, vn))
    o = FA.flash_attention(q, k, v, **kw)
    got = FA.flash_attention_bwd_delta(o, torch.tensor(don))
    tr = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    jo = chunked_attention(tr(qn), tr(kn), tr(vn), causal=kw["causal"],
                           window=kw["window"], softcap=kw["softcap"],
                           scale=kw["scale"], q_offset=kw["q_offset"])
    want = np.asarray(jnp.sum(jo * tr(don), axis=-1)).transpose(0, 2, 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_cpu_wrappers_differentiate_the_plain_version():
    """On the CPU ``flash_attention`` is the plain forward under autograd,
    and ``flash_attention_bwd`` the plain backward in the input dtype."""
    case = CASES[7]
    qn, kn, vn, don = _inputs(case)
    kw = _kw(case)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    o = FA.flash_attention(q, k, v, **kw)
    o.backward(torch.tensor(don))
    want = _plain_bwd(qn, kn, vn, don, kw)
    assert _err((q.grad, k.grad, v.grad), want) <= TOL
    lse = FA.attention_lse_ref(q.detach(), k.detach(), **kw)
    got = FA.flash_attention_bwd(q.detach().bfloat16(), k.detach().bfloat16(),
                                 v.detach().bfloat16(), o.detach().bfloat16(),
                                 lse, torch.tensor(don).bfloat16(), **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)


def test_mamba2_scan_differentiates_on_the_cpu():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 20, 2, 8)).astype(np.float32),
                     requires_grad=True)
    dt = torch.tensor(rng.random((1, 20, 2)).astype(np.float32))
    B, C = (torch.tensor(rng.standard_normal((1, 20, 4)).astype(np.float32))
            for _ in range(2))
    y, h = MS.mamba2_scan(x, dt, -dt, B, C)
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
