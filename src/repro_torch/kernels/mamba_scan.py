"""Chunked Mamba2 SSD scan (port of ``repro.kernels.mamba_scan``, with
the initial state of the reference oracle ``repro.kernels.ref.
mamba2_scan_ref``), and its gradient.

The kernel is ``csrc/mamba_scan.cu``; :func:`mamba2_scan_ref` beside it
is its plain PyTorch version: the same chunked dual form, in torch. The
wrapper serves a CPU tensor with the plain version and a CUDA tensor with
the kernel; there is no other route. Unlike the TPU wrapper, which halves
its chunk until it divides ``s``, any ``s`` is taken: both versions walk
tiles of ``CHUNK`` steps and the last one may be short (the math does not
depend on the tile length). For ``s > CHUNK`` a call is two device
launches: the states entering every chunk (walked along the chunks) and
``C B^T`` of every chunk, into a scratch this wrapper allocates; then every
chunk's ``y`` at once. For ``s <= CHUNK`` it is one.

The gradient (the reference takes ``jax.grad`` of its jnp chunked scan):
on CUDA tensors a call that autograd has to differentiate goes through
:class:`Mamba2Scan`, whose backward is ``csrc/mamba_scan_bwd.cu`` (three
launches, :func:`mamba2_scan_bwd`); its plain version is
:func:`mamba2_scan_bwd_ref`, written out tile by tile. On the CPU the
plain forward is differentiated by autograd.

On ``meta`` tensors (a dry run) the wrappers allocate what their CUDA
branch allocates (outputs and scratch, sized by :func:`scan_scratch_floats`
and :func:`bwd_scratch_floats`, the libraries' size functions in Python)
and launch nothing (under an open cost counter, CPU tensors take the
same route, the plain versions computing uncounted); :func:`scan_cost`
and :func:`scan_bwd_cost` are a
call's work, for the dry run's cost counter and ``chip_smoke.py``'s
bounds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 64          # steps a tile, in the kernel and by default in the plain version
MAX_STATE = 256     # the kernel's largest ``st`` (shared memory)
MAX_HEAD_DIM = 64   # the backward's largest ``dh`` (one 64-row block)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, dA, B, C, h0):
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3:
        raise TypeError("x must be [b, s, nh, dh], dt/dA [b, s, nh] and "
                        "B/C [b, s, st]")
    b, s, nh, dh = x.shape
    st = B.shape[2]
    if dt.shape != (b, s, nh) or dA.shape != (b, s, nh) \
            or B.shape != (b, s, st) or C.shape != (b, s, st):
        raise TypeError(f"shapes do not fit: x {tuple(x.shape)}, dt "
                        f"{tuple(dt.shape)}, dA {tuple(dA.shape)}, B "
                        f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if h0 is not None and h0.shape != (b, nh, dh, st):
        raise TypeError(f"h0 must be [b, nh, dh, st], not {tuple(h0.shape)}")
    f32 = [t for t in (dt, dA, B, C, h0) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("dt, dA, B, C and h0 must be float32")
    if any(t.device != x.device for t in f32):
        raise ValueError("x, dt, dA, B, C and h0 must share a device")


def mamba2_scan_ref(x, dt, dA, B, C, h0=None, *, chunk: int = CHUNK):
    """Plain version. x: [b, s, nh, dh]; dt/dA: [b, s, nh]; B/C: [b, s, st]
    (one group); h0: [b, nh, dh, st] or None (zeros). Returns (y [b, s, nh,
    dh] in x's dtype, h_last [b, nh, dh, st] fp32); fp32 math, but the
    tile's cumsum of dA and its differences in fp64, as in the kernel (an
    fp32 prefix sum of ~-50 keeps only ~4e-6 of absolute precision)."""
    _check(x, dt, dA, B, C, h0)
    b, s, nh, dh = x.shape
    st = B.shape[2]
    xf = x.float()
    h = (torch.zeros((b, nh, dh, st), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        xc, dtc, dAc, Bc, Cc = xf[:, sl], dt[:, sl], dA[:, sl], B[:, sl], C[:, sl]
        n = xc.shape[1]
        cum = torch.cumsum(dAc.double(), dim=1)                  # [b, n, nh]
        cb = torch.einsum("bts,bus->btu", Cc, Bc)
        decay = torch.exp((cum[:, :, None, :] - cum[:, None, :, :]).float())
        tri = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        w = torch.where(tri[None, :, :, None], cb[..., None] * decay, 0.0)
        y_intra = torch.einsum("btuh,buh,buhd->bthd", w, dtc, xc)
        y_inter = torch.einsum("bts,bth,bhds->bthd", Cc,
                               torch.exp(cum.float()), h)
        total = cum[:, -1]                                       # [b, nh]
        sdecay = torch.exp((total[:, None] - cum).float())
        s_new = torch.einsum("buh,buh,buhd,bus->bhds", sdecay, dtc, xc, Bc)
        h = torch.exp(total.float())[..., None, None] * h + s_new
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) if ys else xf
    return y.to(x.dtype), h


def mamba2_scan_bwd_ref(x, dt, dA, B, C, h0, dy, dh_last, *,
                        chunk: int = CHUNK):
    """Plain version of the gradient of :func:`mamba2_scan_ref`: for the
    gradients ``dy`` of y and ``dh_last`` of h_last (None = zeros), returns
    (dx in x's dtype, ddt, ddA, dB, dC, dh0), the rest fp32. The states
    entering each tile are walked forward again, then the tiles in reverse.
    Within a tile (cum the inclusive cumsum of dA, T its total, H the state
    entering, G the gradient of the state leaving; dec_tu = exp(cum_t -
    cum_u) for u <= t, else 0):

      dx_u   = dt_u Z_u,  Z_u = sum_t (C_t.B_u) dec_tu dy_t
                                + exp(T - cum_u) G B_u;  ddt_u = x_u . Z_u
      Q_tu   = dec_tu dt_u (dy_t . x_u)
      dC_t   = sum_u Q_tu B_u + exp(cum_t) dy_t^T H          (over heads)
      dB_u   = sum_t Q_tu C_t + exp(T - cum_u) dt_u x_u^T G  (over heads)
      dcum_t = sum_u S_tu - sum_u S_ut + exp(cum_t) C_t.(dy_t^T H) - V_t,
               S = Q (C.B), V_u = exp(T - cum_u) dt_u B_u.(x_u^T G),
               and on the last step dT = exp(T) <G, H> + sum_u V_u
      ddA    = the reverse cumsum of dcum over the tile
      G_prev = exp(T) G + sum_t exp(cum_t) dy_t C_t^T   (the last is dh0)

    fp32 math, the cumsum and its differences in fp64 as in the forward."""
    _check(x, dt, dA, B, C, h0)
    b, s, nh, dh = x.shape
    st = B.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    xf, dyf = x.float(), dy.float()
    h = torch.zeros((b, nh, dh, st), **f32) if h0 is None else h0.float()
    tiles = []
    for c0 in range(0, s, chunk):    # the state entering every tile
        sl = slice(c0, min(c0 + chunk, s))
        cum = torch.cumsum(dA[:, sl].double(), dim=1)            # [b, n, nh]
        tiles.append((sl, cum, h))
        total = cum[:, -1]
        sdecay = torch.exp((total[:, None] - cum).float())
        h = (torch.exp(total.float())[..., None, None] * h
             + torch.einsum("buh,buh,buhd,bus->bhds", sdecay, dt[:, sl],
                            xf[:, sl], B[:, sl]))
    g = (torch.zeros((b, nh, dh, st), **f32) if dh_last is None
         else dh_last.float())
    parts = []
    for sl, cum, H in reversed(tiles):
        xc, dyc, dtc, Bc, Cc = xf[:, sl], dyf[:, sl], dt[:, sl], B[:, sl], \
            C[:, sl]
        n = xc.shape[1]
        total = cum[:, -1]                                       # [b, nh]
        tri = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        dec = torch.where(tri[None, :, :, None], torch.exp(
            (cum[:, :, None, :] - cum[:, None, :, :]).float()), 0.0)
        ec = torch.exp(cum.float())                              # [b, t, nh]
        sdec = torch.exp((total[:, None] - cum).float())         # [b, u, nh]
        e_t = torch.exp(total.float())
        sw = sdec * dtc
        cb = torch.einsum("bts,bus->btu", Cc, Bc)
        P = cb[..., None] * dec                                  # [b,t,u,nh]
        Q = dec * dtc[:, None] * torch.einsum("bthd,buhd->btuh", dyc, xc)
        Z = (torch.einsum("btuh,bthd->buhd", P, dyc)
             + sdec[..., None] * torch.einsum("bus,bhds->buhd", Bc, g))
        dyH = torch.einsum("bthd,bhds->bths", dyc, H)
        xG = torch.einsum("buhd,bhds->buhs", xc, g)
        dC = (torch.einsum("btuh,bus->bts", Q, Bc)
              + torch.einsum("bth,bths->bts", ec, dyH))
        dB = (torch.einsum("btuh,bts->bus", Q, Cc)
              + torch.einsum("buh,buhs->bus", sw, xG))
        S = Q * cb[..., None]
        V = sw * torch.einsum("bus,buhs->buh", Bc, xG)
        dcum = (S.sum(dim=2) - S.sum(dim=1) - V
                + ec * torch.einsum("bts,bths->bth", Cc, dyH))
        dcum[:, -1] += e_t * (g * H).sum(dim=(-2, -1)) + V.sum(dim=1)
        ddA = torch.flip(torch.cumsum(torch.flip(dcum.double(), [1]), 1),
                         [1]).float()
        parts.append((dtc[..., None] * Z, (xc * Z).sum(dim=-1), ddA, dB, dC))
        g = e_t[..., None, None] * g + torch.einsum("bth,bthd,bts->bhds",
                                                    ec, dyc, Cc)
    dx, ddt, ddA, dB, dC = (torch.cat(t, dim=1) for t in zip(*parts[::-1]))
    return dx.to(x.dtype), ddt, ddA, dB, dC, g


def _tile_pairs(s: int, chunk: int = CHUNK) -> int:
    """Causal (step, step) pairs inside the tiles of ``chunk`` steps."""
    tiles = [chunk] * (s // chunk) + ([s % chunk] if s % chunk else [])
    return sum(n * (n + 1) // 2 for n in tiles)


def scan_cost(b, s, nh, dh, st, elem, *, h0=True) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward call: x, dt, dA, B, C (and h0) read
    once, y and h_last written once; per tile the causal C B^T (shared by
    the heads) and W x products, and per step and head the two [dh, st]
    state products (C h^T for y, x B^T for h)."""
    nbytes = (2 * b * s * nh * dh * elem + 4 * (2 * b * s * nh + 2 * b * s
              * st + (1 + int(h0)) * b * nh * dh * st))
    flop = (2 * b * _tile_pairs(s) * (st + nh * dh)
            + 2 * 2 * b * s * nh * dh * st)
    return float(flop), float(nbytes)


def scan_bwd_cost(b, s, nh, dh, st, elem, *, h0=True,
                  dh_last=False) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward call: x, dy, dt, dA, B, C (and h0,
    dh_last) read once, dx, ddt, ddA, dB, dC, dh0 written once; per tile
    the causal pairs' products (C B^T, shared by the heads; dy x^T and
    P^T dy over dh; Q B and Q^T C over st, a head each), and per step and
    head five [dh, st] products (the states walked forward again, the
    gradients walked back, B G^T, dy H, x G)."""
    nbytes = (3 * b * s * nh * dh * elem + 4 * (4 * b * s * nh + 4 * b * s
              * st + (1 + int(h0) + int(dh_last)) * b * nh * dh * st))
    flop = (2 * b * _tile_pairs(s) * (st + nh * (2 * dh + 2 * st))
            + 5 * 2 * b * s * nh * dh * st)
    return float(flop), float(nbytes)


def scan_scratch_floats(b, s, nh, dh, st) -> int:
    """``mamba2_scan_scratch`` of csrc/mamba_scan.cu: C B^T of every chunk
    and the states entering every chunk but the first (0 for one chunk)."""
    nch = -(-s // CHUNK)
    if nch <= 1:
        return 0
    return b * nch * CHUNK * CHUNK + b * (nch - 1) * nh * (
        -(-dh // 64) * 64) * st


def bwd_scratch_floats(b, s, nh, dh, st) -> int:
    """``mamba2_scan_bwd_scratch`` of csrc/mamba_scan_bwd.cu: C B^T, the
    entering states and the leaving gradients, the dB / dC partials."""
    del dh
    nch = -(-s // CHUNK)
    return (b * nch * CHUNK * CHUNK + 2 * b * (nch - 1) * nh * 64 * st
            + 2 * b * nh * s * st)


def _kernel_args(x, dt, dA, B, C, h0):
    _build.require_cuda(x, "mamba2_scan", meta=True)
    _check(x, dt, dA, B, C, h0)
    st = B.shape[2]
    if x.dtype not in DTYPE_CODES or st > MAX_STATE:
        raise TypeError(f"mamba2_scan takes fp32/bf16 x and st <= "
                        f"{MAX_STATE}, not {x.dtype} / {st}")
    return tuple(t.contiguous() for t in (x, dt, dA, B, C)) + (
        None if h0 is None else h0.contiguous(),)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(x, dt, dA, B, C, h0):
    """One kernel call on contiguous, checked CUDA inputs."""
    b, s, nh, dh = x.shape
    st = B.shape[2]
    y = torch.empty_like(x)
    h_last = torch.empty((b, nh, dh, st), dtype=torch.float32,
                         device=x.device)
    _build.reckon("mamba2_scan", *scan_cost(b, s, nh, dh, st,
                                            x.element_size(),
                                            h0=h0 is not None), x)
    if _build.on_meta(x):
        if s > CHUNK:
            torch.empty(scan_scratch_floats(b, s, nh, dh, st),
                        dtype=torch.float32, device=x.device)
        return y, h_last
    if x.device.type == "cpu":   # under a cost counter: the plain version
        with _build.uncounted():
            yr, hr = mamba2_scan_ref(x, dt, dA, B, C, h0)
            y.copy_(yr)
            h_last.copy_(hr)
        return y, h_last
    lib = _build.lib("mamba_scan")
    scratch = None  # one chunk needs none; more: C B^T and the chunk states
    if s > CHUNK:
        scratch = torch.empty(lib.mamba2_scan_scratch(b, s, nh, dh, st),
                              dtype=torch.float32, device=x.device)
    err = lib.mamba2_scan(
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
        C.data_ptr(), _ptr(h0), y.data_ptr(), h_last.data_ptr(),
        _ptr(scratch), b, s, nh, dh, st, DTYPE_CODES[x.dtype],
        _build.stream_ptr(x.device))
    _build.check(err, "mamba2_scan")
    _build.count_launch("mamba2_scan")
    return y, h_last


def mamba2_scan_bwd(x, dt, dA, B, C, h0, dy, dh_last):
    """(dx, ddt, ddA, dB, dC, dh0) by the contract of
    :func:`mamba2_scan_bwd_ref` (the kernels on CUDA tensors: x fp32 or
    bf16, ``s >= 1``, ``dh <= MAX_HEAD_DIM``, ``st <= MAX_STATE``; dy is
    read in x's dtype). One call is three launches: the walks and C B^T; every tile's
    gradients with per-head partials of dB and dC; their sum over the
    heads (fixed order: repeats are bit-equal)."""
    if x.device.type == "cpu" and not _build.counting():
        return mamba2_scan_bwd_ref(x, dt, dA, B, C, h0, dy, dh_last)
    x, dt, dA, B, C, h0 = _kernel_args(x, dt, dA, B, C, h0)
    b, s, nh, dh = x.shape
    st = B.shape[2]
    if dh > MAX_HEAD_DIM:
        raise TypeError(f"mamba2_scan_bwd takes dh <= {MAX_HEAD_DIM}, not "
                        f"{dh}")
    if dy.shape != x.shape or (dh_last is not None
                               and dh_last.shape != (b, nh, dh, st)):
        raise TypeError("dy must be shaped as x and dh_last as h0")
    if any(t is not None and t.device != x.device for t in (dy, dh_last)):
        raise ValueError("dy and dh_last must be on x's device")
    dy = dy.to(x.dtype).contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt, ddA = torch.empty((b, s, nh), **f32), torch.empty((b, s, nh), **f32)
    dB, dC = torch.empty((b, s, st), **f32), torch.empty((b, s, st), **f32)
    dh0 = torch.empty((b, nh, dh, st), **f32)
    _build.reckon("mamba2_scan_bwd", *scan_bwd_cost(
        b, s, nh, dh, st, x.element_size(), h0=h0 is not None,
        dh_last=dh_last is not None), x)
    if _build.on_meta(x):
        torch.empty(bwd_scratch_floats(b, s, nh, dh, st), **f32)
        return dx, ddt, ddA, dB, dC, dh0
    if x.device.type == "cpu":   # under a cost counter: the plain version
        with _build.uncounted():
            for t, g in zip((dx, ddt, ddA, dB, dC, dh0), mamba2_scan_bwd_ref(
                    x, dt, dA, B, C, h0, dy, dh_last)):
                t.copy_(g)
        return dx, ddt, ddA, dB, dC, dh0
    lib = _build.lib("mamba_scan_bwd")
    scratch = torch.empty(lib.mamba2_scan_bwd_scratch(b, s, nh, dh, st),
                          **f32)
    err = lib.mamba2_scan_bwd(
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
        C.data_ptr(), _ptr(h0), dy.data_ptr(), _ptr(dh_last), dx.data_ptr(),
        ddt.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dh0.data_ptr(), scratch.data_ptr(), b, s, nh, dh, st,
        DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "mamba2_scan_bwd")
    _build.count_launch("mamba2_scan_bwd")
    return dx, ddt, ddA, dB, dC, dh0


class Mamba2Scan(torch.autograd.Function):
    """The scan kernel, and the backward kernels for its gradient (CUDA
    tensors). The inputs are saved only when a gradient is needed (under
    ``torch.utils.checkpoint`` the recompute launches the forward again);
    the backward walks the entering states again rather than keep the
    forward's scratch."""

    @staticmethod
    def forward(ctx, x, dt, dA, B, C, h0):
        x, dt, dA, B, C, h0 = _kernel_args(x, dt, dA, B, C, h0)
        y, h_last = _forward(x, dt, dA, B, C, h0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, dt, dA, B, C, h0)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, dA, B, C, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = mamba2_scan_bwd(x, dt, dA, B, C, h0, dy, dh_last)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def mamba2_scan(x, dt, dA, B, C, h0=None):
    """Contract of :func:`mamba2_scan_ref` (kernel on CUDA tensors: x fp32
    or bf16, ``st <= MAX_STATE``), with its gradient through
    :class:`Mamba2Scan` (``dh <= MAX_HEAD_DIM``)."""
    if x.device.type == "cpu" and not _build.counting():
        return mamba2_scan_ref(x, dt, dA, B, C, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, dA, B, C, h0)):
        return Mamba2Scan.apply(x, dt, dA, B, C, h0)
    return _forward(*_kernel_args(x, dt, dA, B, C, h0))
