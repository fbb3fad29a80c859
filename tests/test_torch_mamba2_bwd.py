"""The Mamba2 scan's plain backward (``mamba2_scan_bwd_ref``, what the
backward kernel is held against on the card) on the CPU: against autograd
of the port's plain forward ``mamba2_scan_ref`` (each gradient within 1e-5
of its largest entry: the same fp32 tile math, summed in another order),
and against ``jax.vjp`` of the reference's sequential oracle
``repro.kernels.ref.mamba2_scan_ref`` (within 1e-4: a step-by-step scan
against the chunked form), for all six gradients. Lengths 1, 5, 64, 65 and
130 cover one step, a short tile, one whole tile, a tile and a step, and a
ragged third tile; h0 zero and random, dh_last absent and random. Inputs
come from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import mamba_scan as MS

NAMES = ("dx", "ddt", "ddA", "dB", "dC", "dh0")
SHAPE = (2, 3, 8, 4)   # b, nh, dh, st


def _inputs(s, h0, dh_last, seed):
    b, nh, dh, st = SHAPE
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    sp = np.logaddexp(0.0, n(b, s, nh)).astype(np.float32)
    return {"x": n(b, s, nh, dh), "dt": sp,
            "dA": -np.logaddexp(0.0, n(b, s, nh)).astype(np.float32),
            "B": n(b, s, st), "C": n(b, s, st),
            "h0": n(b, nh, dh, st) if h0 else np.zeros((b, nh, dh, st),
                                                        np.float32),
            "dy": n(b, s, nh, dh),
            "dh_last": n(b, nh, dh, st) if dh_last else None}


def _plain_bwd(a, h0):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    return MS.mamba2_scan_bwd_ref(t["x"], t["dt"], t["dA"], t["B"], t["C"],
                                  t["h0"] if h0 else None, t["dy"],
                                  t["dh_last"])


def _close(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        top = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * top, name


CASES = [(s, h0, dl) for s in (1, 5, 64, 65, 130)
         for h0, dl in ((False, False), (True, True), (False, True),
                        (True, False))]


@pytest.mark.parametrize("s,h0,dh_last", CASES)
def test_plain_backward_matches_autograd(s, h0, dh_last):
    a = _inputs(s, h0, dh_last, seed=s)
    ins = [torch.from_numpy(a[k]).requires_grad_()
           for k in ("x", "dt", "dA", "B", "C", "h0")]
    y, h = MS.mamba2_scan_ref(*ins)
    loss = (y * torch.from_numpy(a["dy"])).sum()
    if dh_last:
        loss = loss + (h * torch.from_numpy(a["dh_last"])).sum()
    want = torch.autograd.grad(loss, ins)
    got = _plain_bwd(a, True)
    _close([g.detach() for g in got], [w.detach() for w in want], 1e-5)
    # h0 absent is h0 zero
    if not h0:
        _close([g.detach() for g in _plain_bwd(a, False)],
               [g.detach() for g in got], 0.0)


@pytest.mark.parametrize("s,h0,dh_last", CASES)
def test_plain_backward_matches_reference_oracle_vjp(s, h0, dh_last):
    a = _inputs(s, h0, dh_last, seed=100 + s)
    prim = tuple(jnp.asarray(a[k]) for k in ("x", "dt", "dA", "B", "C",
                                              "h0"))
    (y, h), vjp = jax.vjp(JREF.mamba2_scan_ref, *prim)
    dhl = (jnp.zeros_like(h) if a["dh_last"] is None
           else jnp.asarray(a["dh_last"]))
    want = vjp((jnp.asarray(a["dy"]), dhl))
    got = _plain_bwd(a, h0)
    _close([g.numpy() for g in got], want, 1e-4)


def test_wrapper_takes_the_plain_backward_on_the_cpu():
    a = _inputs(70, True, True, seed=7)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = MS.mamba2_scan_bwd(t["x"], t["dt"], t["dA"], t["B"], t["C"],
                             t["h0"], t["dy"], t["dh_last"])
    want = _plain_bwd(a, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # bf16 x: dx in x's dtype, the rest fp32
    got = MS.mamba2_scan_bwd(t["x"].bfloat16(), t["dt"], t["dA"], t["B"],
                             t["C"], None, t["dy"].bfloat16(), None)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
