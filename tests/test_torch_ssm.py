"""The port's Mamba2 pieces against the JAX reference on the CPU.

The scan's plain version (``repro_torch.kernels.mamba_scan``, what the
wrapper runs for CPU tensors) is held against the reference's Pallas
kernel in interpret mode at tests/test_kernels.py's shapes and
tolerances (y 1e-4 fp32, h_last 1e-3, bf16 2e-2: one bf16 rounding of
y), and against the sequential oracle ``repro.kernels.ref.
mamba2_scan_ref`` with a ragged length and a nonzero initial state.
The Mamba2 layer (conv, forward, decode) is held against
``repro.models.layers.ssm`` at zamba2's SMOKE widths in fp32 within 1e-5
(summation order). Every input is made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ref as JR
from repro.kernels.mamba_scan import mamba2_scan as j_scan
from repro.models.layers import ssm as JS
from repro.models.params import KeyGen, split
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.kernels import mamba_scan as TM
from repro_torch.models.config import NotPorted
from repro_torch.models.layers import ssm as TS

ATOL = 1e-5
# the reference's layer, jitted once per shape (eager JAX is slow here)
j_forward = jax.jit(JS.mamba2_forward, static_argnums=1)
j_decode = jax.jit(JS.mamba2_decode, static_argnums=1)
Y_TOL = dict(rtol=1e-4, atol=1e-4)
H_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _scan_inputs(rng, b, s, nh, dh, st, h0=False):
    """tests/test_kernels.py's distributions: x normal, dt = softplus(n),
    dA = -softplus(n), B and C normal."""
    sp = lambda a: np.log1p(np.exp(a))  # noqa: E731
    x = rng.standard_normal((b, s, nh, dh)).astype(np.float32)
    dt = sp(rng.standard_normal((b, s, nh))).astype(np.float32)
    dA = -sp(rng.standard_normal((b, s, nh))).astype(np.float32)
    B = rng.standard_normal((b, s, st)).astype(np.float32)
    C = rng.standard_normal((b, s, st)).astype(np.float32)
    hz = (rng.standard_normal((b, nh, dh, st)).astype(np.float32) if h0
          else np.zeros((b, nh, dh, st), np.float32))
    return x, dt, dA, B, C, hz


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,nh,dh,st,chunk",
    [(2, 64, 2, 16, 8, 16), (1, 128, 4, 32, 16, 32), (2, 96, 1, 8, 4, 32)])
def test_plain_scan_matches_pallas_interpret(b, s, nh, dh, st, chunk,
                                             dt_name):
    rng = np.random.default_rng(s * 10 + nh)
    x, dt, dA, B, C, _ = _scan_inputs(rng, b, s, nh, dh, st)
    tx = torch.from_numpy(x).to(getattr(torch, dt_name))
    jx = jnp.asarray(tx.float().numpy(), getattr(jnp, dt_name))
    want_y, want_h = j_scan(jx, jnp.asarray(dt), jnp.asarray(dA),
                            jnp.asarray(B), jnp.asarray(C), chunk=chunk,
                            interpret=True)
    y, h = TM.mamba2_scan(tx, *_t(dt, dA, B, C))
    assert y.dtype == tx.dtype and h.dtype == torch.float32
    assert y.shape == (b, s, nh, dh) and h.shape == (b, nh, dh, st)
    tol = Y_TOL if dt_name == "float32" else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **H_TOL)


@pytest.mark.parametrize("s,chunk,h0", [(23, 64, True), (23, 8, False),
                                        (150, 64, True), (1, 64, True)])
def test_plain_scan_matches_oracle_with_ragged_tiles_and_state(s, chunk, h0):
    """A last tile shorter than the chunk, and a carried initial state,
    against the reference's sequential oracle."""
    rng = np.random.default_rng(s + chunk)
    x, dt, dA, B, C, hz = _scan_inputs(rng, 2, s, 3, 16, 8, h0=h0)
    want_y, want_h = JR.mamba2_scan_ref(*map(jnp.asarray,
                                             (x, dt, dA, B, C, hz)))
    y, h = TM.mamba2_scan_ref(*_t(x, dt, dA, B, C, hz), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **H_TOL)
    if not h0:  # h0=None is the zero state (through the wrapper: chunk 64)
        y0, h_0 = TM.mamba2_scan(*_t(x, dt, dA, B, C))
        np.testing.assert_allclose(y0.numpy(), np.asarray(want_y), **Y_TOL)
        np.testing.assert_allclose(h_0.numpy(), np.asarray(want_h), **H_TOL)


def _chunk_parallel(x, dt, dA, B, C, h0, chunk=TM.CHUNK):
    """The CUDA kernel's three-part form in plain PyTorch: every chunk's
    intra-chunk y and own state S_c from a zero state; the states passed
    along the chunks, h_c = exp(T_c) h_{c-1} + S_c from h0; then each
    chunk's y gains exp(cum_t) C_t . h_{c-1}^T. fp32, the cumsums in fp64."""
    b, s, nh, dh = x.shape
    ys, states, totals, cums = [], [], [], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        cum = torch.cumsum(dA[:, sl].double(), dim=1)            # [b, n, nh]
        total = cum[:, -1]
        n = xc.shape[1]
        tri = torch.ones((n, n), dtype=torch.bool).tril()
        decay = torch.exp((cum[:, :, None] - cum[:, None, :]).float())
        w = torch.where(tri[None, :, :, None],
                        torch.einsum("bts,bus->btu", Cc, Bc)[..., None] * decay,
                        0.0)
        ys.append(torch.einsum("btuh,buh,buhd->bthd", w, dtc, xc))
        sw = torch.exp((total[:, None] - cum).float()) * dtc
        states.append(torch.einsum("buh,buhd,bus->bhds", sw, xc, Bc))
        totals.append(total.float())
        cums.append(cum)
    h = torch.zeros((b, nh, dh, B.shape[2])) if h0 is None else h0
    out = []
    for yc, sc, tc, cum, c0 in zip(ys, states, totals, cums,
                                   range(0, s, chunk)):
        Cc = C[:, c0:c0 + chunk]
        out.append(yc + torch.einsum("bts,bth,bhds->bthd", Cc,
                                     torch.exp(cum.float()), h))
        h = torch.exp(tc)[..., None, None] * h + sc
    return torch.cat(out, dim=1), h


@pytest.mark.parametrize("s", [1, 63, 64, 65, 150])
@pytest.mark.parametrize("h0", [False, True])
def test_chunk_parallel_form_matches_plain(s, h0):
    """The kernel's algebra: chunk states from zero, passed along the
    chunks, equal the plain (sequential) version at fp32 1e-5, with ragged
    last chunks and a carried initial state."""
    rng = np.random.default_rng(s * 3 + h0)
    x, dt, dA, B, C, hz = _t(*_scan_inputs(rng, 2, s, 3, 16, 8, h0=h0))
    y, h = _chunk_parallel(x, dt, dA, B, C, hz)
    want_y, want_h = TM.mamba2_scan_ref(x, dt, dA, B, C, hz)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,s,nh,dh,st,chunk", [(2, 96, 2, 16, 8, 32),
                                                (1, 128, 2, 8, 4, 64)])
def test_chunk_parallel_form_matches_pallas_interpret(b, s, nh, dh, st,
                                                      chunk):
    """The same form against the reference's Pallas kernel in interpret
    mode (zero initial state, which is all that kernel takes), fp32 1e-5."""
    rng = np.random.default_rng(s + nh)
    x, dt, dA, B, C, _ = _scan_inputs(rng, b, s, nh, dh, st)
    want_y, want_h = j_scan(*map(jnp.asarray, (x, dt, dA, B, C)),
                            chunk=chunk, interpret=True)
    y, h = _chunk_parallel(*_t(x, dt, dA, B, C), None)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)


def test_scan_wrapper_takes_the_plain_version_on_cpu_and_checks_inputs():
    rng = np.random.default_rng(0)
    x, dt, dA, B, C, hz = _t(*_scan_inputs(rng, 1, 5, 2, 8, 4, h0=True))
    _build.reset_launches()
    TM.mamba2_scan(x, dt, dA, B, C, hz)
    assert _build.launches["mamba2_scan"] == 0
    with pytest.raises(TypeError):
        TM.mamba2_scan(x, dt, dA, B, C, hz[:, :1])
    with pytest.raises(TypeError):
        TM.mamba2_scan(x, dt.double(), dA, B, C)
    with pytest.raises(TypeError):
        TM.mamba2_scan(x, dt, dA, B[:, :4], C)


@pytest.fixture(scope="module")
def smoke():
    """zamba2 SMOKE's first Mamba2 layer, drawn by the reference and
    carried across (with A_log, D and dt_bias made nonzero so that the
    decay and skip paths are exercised)."""
    jcfg, tcfg = JC.get_smoke("zamba2-2.7b"), TC.get_smoke("zamba2-2.7b")
    jp = split(JS.init_mamba2(KeyGen(jax.random.PRNGKey(0)), jcfg))[0]
    rng = np.random.default_rng(7)
    for name in TS.FP32_LEAVES:
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * 0.5,
                               jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, atol=ATOL):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_and_conv_step_match_reference(with_tail):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jt = jnp.asarray(tail) if with_tail else None
    tt = torch.from_numpy(tail) if with_tail else None
    jy, jtail = JS.causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), jt)
    ty, ttail = TS.causal_conv(*_t(x, w, b), tt)
    _close(ty, jy)
    _close(ttail, jtail)
    jy1, jt1 = JS.conv_step(jnp.asarray(x[:, 0]), jnp.asarray(w),
                            jnp.asarray(b), jnp.asarray(tail))
    ty1, tt1 = TS.conv_step(*_t(x[:, 0], w, b, tail))
    _close(ty1, jy1)
    _close(tt1, jt1)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_forward_and_decode_match_reference(smoke, carried):
    jcfg, tcfg, jp, tp = smoke
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if carried:  # a state carried from an earlier prompt chunk
        x0 = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
        _, jstate = j_forward(jp, jcfg, jnp.asarray(x0))
        _, tstate = TS.mamba2_forward(tp, tcfg, torch.from_numpy(x0))
        _close(tstate, jstate)
    jy, jst = j_forward(jp, jcfg, jnp.asarray(x), jstate)
    ty, tst = TS.mamba2_forward(tp, tcfg, torch.from_numpy(x), tstate)
    _close(ty, jy)
    _close(tst, jst)
    for t in range(3):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = j_decode(jp, jcfg, jnp.asarray(x1), jst)
        ty, tst = TS.mamba2_decode(tp, tcfg, torch.from_numpy(x1), tst)
        _close(ty, jy)
        _close(tst, jst)


def test_mamba2_prefill_then_decode_continues(smoke):
    """As tests/test_models_ssm.py holds the reference: prefill(x[:8]) and
    decoding tokens 8..11 gives prefill(x[:12])'s tail."""
    _, tcfg, _, tp = smoke
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    y_full, _ = TS.mamba2_forward(tp, tcfg, x)
    _, st = TS.mamba2_forward(tp, tcfg, x[:, :8])
    outs = []
    for t in range(8, 12):
        y, st = TS.mamba2_decode(tp, tcfg, x[:, t:t + 1], st)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               y_full[:, 8:].numpy(), rtol=3e-4, atol=3e-4)


def test_mamba1_is_not_ported():
    """Mamba1 runs in an attention-free stack of its own (falcon-mamba,
    tests/test_torch_mamba1.py); a stack that mixes it with Mamba2 or with
    attention layers is not ported, and the stack refuses it."""
    import dataclasses

    from repro_torch.models import transformer as TTF
    from repro_torch.models.config import GLOBAL, MAMBA1, MAMBA2
    cfg = TC.get_smoke("zamba2-2.7b")
    for pattern in ((MAMBA1, MAMBA2, MAMBA2, MAMBA2),
                    (MAMBA1, GLOBAL, MAMBA1, GLOBAL)):
        mixed = dataclasses.replace(cfg, layer_pattern=pattern,
                                    shared_attn_every=0, scan_group=1)
        for call in (lambda: TTF.init_model(torch.Generator(), mixed, "cpu"),
                     lambda: TTF.init_cache(mixed, 1, 8, "cpu")):
            with pytest.raises(NotPorted):
                call()
