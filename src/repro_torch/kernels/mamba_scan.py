"""Chunked Mamba2 SSD scan (port of ``repro.kernels.mamba_scan``, with
the initial state of the reference oracle ``repro.kernels.ref.
mamba2_scan_ref``).

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

The kernel has no backward yet: on CUDA tensors a call that autograd would
have to differentiate (grad mode on and an input that requires a
gradient) raises :class:`~repro_torch.models.config.NotPorted` rather than
return a result detached from its inputs. On the CPU the plain version is
differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.models.config import NotPorted

CHUNK = 64          # steps a tile, in the kernel and by default in the plain version
MAX_STATE = 256     # the kernel's largest ``st`` (shared memory)
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


def mamba2_scan(x, dt, dA, B, C, h0=None):
    """Contract of :func:`mamba2_scan_ref` (kernel on CUDA tensors: x fp32
    or bf16, ``st <= MAX_STATE``)."""
    if x.device.type == "cpu":
        return mamba2_scan_ref(x, dt, dA, B, C, h0)
    _build.require_cuda(x, "mamba2_scan")
    _check(x, dt, dA, B, C, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, dA, B, C, h0)):
        raise NotPorted("a gradient through the Mamba2 scan kernel (the "
                        "Mamba2 scan has no backward kernel yet)")
    b, s, nh, dh = x.shape
    st = B.shape[2]
    if x.dtype not in DTYPE_CODES or st > MAX_STATE:
        raise TypeError(f"mamba2_scan takes fp32/bf16 x and st <= "
                        f"{MAX_STATE}, not {x.dtype} / {st}")
    x, dt, dA, B, C = (t.contiguous() for t in (x, dt, dA, B, C))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(x)
    h_last = torch.empty((b, nh, dh, st), dtype=torch.float32,
                         device=x.device)
    lib = _build.lib("mamba_scan")
    scratch = None  # one chunk needs none; more: C B^T and the chunk states
    if s > CHUNK:
        scratch = torch.empty(lib.mamba2_scan_scratch(b, s, nh, dh, st),
                              dtype=torch.float32, device=x.device)
    err = lib.mamba2_scan(
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, s, nh, dh, st, DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "mamba2_scan")
    _build.count_launch("mamba2_scan")
    return y, h_last
