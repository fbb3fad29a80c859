"""Head dim 4 through the flash wrappers' zero-padded route
(``kernels/flash_attention.padded``): q, k, v (and o, dO in the backward)
padded to the kernels' head dim 8, the result sliced back, at the true
``scale``. On the CPU the route's arithmetic runs with the plain versions:
forward, the stored log-sum-exp and the backward equal the plain versions
at head dim 4 within fp32 rounding, and so does the wrapper's own route
under a cost counter (CPU tensors then take the kernels' route, whose
launches count at head dim 8)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA

CASES = [
    # b, h, kh, sq, sk, causal, window, softcap, q_offset
    (2, 4, 2, 9, 9, True, 0, 0.0, 0),
    (1, 2, 1, 5, 12, True, 4, 30.0, 7),
    (2, 2, 2, 6, 6, False, 0, 50.0, 0),
]


def _inputs(case, dtype=torch.float32):
    b, h, kh, sq, sk = case[:5]
    rng = np.random.default_rng(sum(case[:5]))
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return f(b, h, sq, 4), f(b, kh, sk, 4), f(b, kh, sk, 4), f(b, h, sq, 4)


def _kw(case):
    return dict(scale=4 ** -0.5, causal=case[5], window=case[6],
                softcap=case[7], q_offset=case[8])


def test_head_dim_4_pads_to_8():
    assert FA.kernel_head_dim(4) == 8 and FA.takes_head_dim(4)
    assert not FA.takes_head_dim(3) and not FA.takes_head_dim(12)
    q = torch.ones(1, 1, 2, 4)
    p = FA.pad_head_dim(q, 8)
    assert p.shape == (1, 1, 2, 8) and float(p[..., 4:].abs().sum()) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_padded_forward_equals_the_plain_version(case):
    q, k, v, _ = _inputs(case)
    kw = _kw(case)
    want = FA.flash_attention_ref(q, k, v, **kw)
    got = FA.padded(FA.flash_attention_ref, q, k, v, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    lse_w = FA.attention_lse_ref(q, k, **kw)
    lse = FA.attention_lse_ref(FA.pad_head_dim(q, 8), FA.pad_head_dim(k, 8),
                               **kw)
    torch.testing.assert_close(lse, lse_w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_padded_backward_equals_the_plain_version(case):
    """The kernels' backward formulas at head dim 8 on padded inputs,
    sliced, against the same formulas at head dim 4; and autograd through
    pad -> plain forward -> slice against autograd of the plain forward."""
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    o = FA.flash_attention_ref(q, k, v, **kw)
    lse = FA.attention_lse_ref(q, k, **kw)
    want = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = FA.padded(FA.flash_attention_bwd_ref, q, k, v, o, lse, do, **kw)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5,
                                   msg=f"d{name}")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.padded(FA.flash_attention_ref, *leaves, **kw).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_ref(*ref, **kw).backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


def test_the_wrapper_takes_the_padded_route_under_a_counter():
    """Under an open cost counter a CPU call takes the kernels' route:
    head dim 4 goes through ``padded`` (forward with its lse, and the
    three backward launches, each reckoned at head dim 8), and its output
    and gradients equal the plain version's."""
    from repro_torch.roofline.cost import CostCounter
    case = CASES[0]
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _build.reset_launches()
    with CostCounter() as counter:
        out = FA.flash_attention(*leaves, **kw)
        out.backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = FA.flash_attention_ref(*ref, **kw)
    want.backward(do)
    torch.testing.assert_close(out.detach(), want.detach(), atol=1e-6,
                               rtol=1e-6)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)
    assert counter.ops > 0
