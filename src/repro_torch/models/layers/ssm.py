"""SSM blocks (port of ``repro.models.layers.ssm``): Mamba1
(falcon-mamba-7b) and Mamba2 / SSD (zamba2-2.7b).

Prefill (``mamba2_forward``) computes the chunked SSD scan where the
reference computes it in jnp (``ssm.py:264-285``): here it calls the
wrapper of the port's scan kernel (``kernels/mamba_scan.py``), which
launches the CUDA kernel for CUDA tensors and takes its plain version for
CPU tensors, with the carried state as the scan's initial state. ``D x``
and the gated norm stay outside the kernel, as in the reference.

Decode (``mamba2_decode``) is the reference's O(1) recurrence in plain
PyTorch: the state ``h [b, nh, dh, st]`` (fp32) plus a depthwise-conv
tail of ``conv_width - 1`` tokens; the reference has no kernel there
either.

Mamba1 has no kernel in the reference: its selective scan is jnp (an
associative scan within fixed chunks), and here plain PyTorch
(:func:`linear_scan`, a doubling scan within chunks of
``cfg.ssm_chunk``; any length is tiled, where the reference shrinks the
chunk until it divides the length). Its decode is the O(1) recurrence
over ``h [b, d_inner, state]`` (fp32) and a conv tail.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba2_scan
from repro_torch.models.params import dense_init, ones_init, zeros_init

# leaves the reference keeps in fp32 whatever the model's dtype
FP32_LEAVES = ("A_log", "D", "dt_bias")


# --------------------------------------------------------------- common ops
def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def causal_conv(x, w, b, tail=None):
    """Depthwise causal conv. x: [b, s, c]; w: [c, width]; b: [c].

    ``tail``: [b, width-1, c] previous tokens (decode/chunk carry) or None
    (zero history). Returns (y [b, s, c], new_tail [b, width-1, c]). The
    taps are unrolled in fp32, as the reference's (no ``conv1d``: cuDNN
    would take TF32 on the card)."""
    bsz, s, c = x.shape
    width = w.shape[1]
    if tail is None:
        tail = torch.zeros((bsz, width - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                  # [b, s+width-1, c]
    wf = w.float()
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for k in range(width):
        y = y + xp[:, k:k + s].float() * wf[:, k]
    y = y + b.float()
    new_tail = xp[:, s:].to(x.dtype) if width > 1 else tail
    return y.to(x.dtype), new_tail


def conv_step(x1, w, b, tail):
    """One-token conv update. x1: [b, c]; tail: [b, width-1, c]."""
    xp = torch.cat([tail, x1[:, None]], dim=1)       # [b, width, c]
    y = torch.einsum("bwc,cw->bc", xp.float(), w.float()) + b.float()
    return y.to(x1.dtype), xp[:, 1:]


# ============================================================= Mamba1 block
def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t along axis 1, given h0.

    a, b: [b, s, ...] fp32; h0: [b, ...]. Returns (h [b, s, ...],
    h_last). A log-depth doubling (Hillis-Steele) scan over the
    reference's combine ``(A1, B1) then (A2, B2) = (A1 A2, B2 + A2 B1)``:
    ceil(log2 s) elementwise steps, after which (A_t, B_t) is the prefix
    and h_t = A_t h0 + B_t. Nothing is divided, so a decay that underflows
    fp32 gives 0, never inf or NaN (a ``cumprod`` then a division would).
    Each step builds new tensors, so autograd can record the scan
    (training): nothing its backward needs is overwritten."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def init_mamba1(gen, cfg, device, *, layers: int = 0) -> dict:
    d, di, st, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    cw, dt, f32 = cfg.ssm_conv, cfg.dtype, torch.float32
    kw = dict(layers=layers)
    # S4D-real init for A: A[n] = -(n + 1), stored as its log (fp32)
    a0 = torch.log(torch.arange(1, st + 1, dtype=f32, device=device))
    a_log = a0.expand(((layers,) if layers else ()) + (di, st)).contiguous()
    return {
        "in_x": dense_init(gen, (d, di), dt, device, **kw),
        "in_z": dense_init(gen, (d, di), dt, device, **kw),
        "conv_w": dense_init(gen, (di, cw), dt, device, **kw),
        "conv_b": zeros_init((di,), dt, device, **kw),
        "x_proj": dense_init(gen, (di, dr + 2 * st), dt, device, **kw),
        "dt_proj": dense_init(gen, (dr, di), dt, device, **kw),
        "dt_bias": zeros_init((di,), f32, device, **kw),
        "A_log": a_log,
        "D": ones_init((di,), f32, device, **kw),
        "out_proj": dense_init(gen, (di, d), dt, device, **kw),
    }


def mamba1_init_state(cfg, batch: int, device) -> dict:
    di, st, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros((batch, di, st), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, di), dtype=cfg.dtype,
                            device=device),
    }


def _mamba1_ssm_inputs(params, cfg, xc):
    """Shared pre-scan math. xc: [b, s, di] (post-conv, post-silu).
    Returns (dt [b, s, di] fp32 after softplus, B, C [b, s, st] fp32)."""
    dr, st = cfg.ssm_dt_rank, cfg.ssm_state
    dbc = (xc @ params["x_proj"]).float()
    dt_lr, B, C = dbc.split([dr, st, st], dim=-1)
    dt = dt_lr @ params["dt_proj"].float()
    return F.softplus(dt + params["dt_bias"]), B, C


def mamba1_forward(params, cfg, x, state=None):
    """Selective scan over the prompt. x: [b, s, d] -> (y [b, s, d],
    new_state); ``state`` None = zeros. Any ``s`` is taken in chunks of
    ``cfg.ssm_chunk`` (the last one ragged), each one :func:`linear_scan`
    over a ``[b, chunk, d_inner, state]`` working set carrying h."""
    bsz, s, _ = x.shape
    if state is None:
        state = mamba1_init_state(cfg, bsz, x.device)
    xi, z = x @ params["in_x"], x @ params["in_z"]
    xc, conv_tail = causal_conv(xi, params["conv_w"], params["conv_b"],
                                state["conv"])
    xc = silu(xc)
    dt, B, C = _mamba1_ssm_inputs(params, cfg, xc)
    A = -torch.exp(params["A_log"].float())             # [di, st]
    xcf = xc.float()
    h, ys = state["h"], []
    for c0 in range(0, s, cfg.ssm_chunk):
        c = slice(c0, c0 + cfg.ssm_chunk)
        a = torch.exp(dt[:, c, :, None] * A)            # [b, c, di, st]
        bx = (dt[:, c] * xcf[:, c])[..., None] * B[:, c, None, :]
        hs, h = linear_scan(a, bx, h)
        ys.append(torch.einsum("bcis,bcs->bci", hs, C[:, c]))
    y = torch.cat(ys, dim=1) + params["D"] * xcf
    y = (y * silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], {"h": h, "conv": conv_tail}


def mamba1_decode(params, cfg, x1, state):
    """One token. x1: [b, 1, d] -> (y [b, 1, d], new_state)."""
    xi, z = (x1 @ params["in_x"])[:, 0], (x1 @ params["in_z"])[:, 0]
    xc, conv_tail = conv_step(xi, params["conv_w"], params["conv_b"],
                              state["conv"])
    xc = silu(xc)
    dt, B, C = (t[:, 0] for t in _mamba1_ssm_inputs(params, cfg, xc[:, None]))
    A = -torch.exp(params["A_log"].float())
    xf = xc.float()
    h = torch.exp(dt[..., None] * A) * state["h"] + (dt * xf)[..., None] * \
        B[:, None, :]
    y = torch.einsum("bis,bs->bi", h, C) + params["D"] * xf
    y = (y * silu(z.float())).to(x1.dtype)
    return (y @ params["out_proj"])[:, None], {"h": h, "conv": conv_tail}


# ========================================================= Mamba2 (SSD) block
def init_mamba2(gen, cfg, device, *, layers: int = 0) -> dict:
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, cw, dt = cfg.ssm_heads, cfg.ssm_conv, cfg.dtype
    f32 = torch.float32
    kw = dict(layers=layers)
    return {
        "in_z": dense_init(gen, (d, di), dt, device, **kw),
        "in_x": dense_init(gen, (d, di), dt, device, **kw),
        "in_bc": dense_init(gen, (d, 2 * st), dt, device, **kw),
        "in_dt": dense_init(gen, (d, nh), dt, device, **kw),
        "conv_x_w": dense_init(gen, (di, cw), dt, device, **kw),
        "conv_x_b": zeros_init((di,), dt, device, **kw),
        "conv_bc_w": dense_init(gen, (2 * st, cw), dt, device, **kw),
        "conv_bc_b": zeros_init((2 * st,), dt, device, **kw),
        "A_log": zeros_init((nh,), f32, device, **kw),
        "D": ones_init((nh,), f32, device, **kw),
        "dt_bias": zeros_init((nh,), f32, device, **kw),
        "gate_norm": ones_init((di,), dt, device, **kw),
        "out_proj": dense_init(gen, (di, d), dt, device, **kw),
    }


def mamba2_init_state(cfg, batch: int, device) -> dict:
    di, st, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh, dh = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "h": torch.zeros((batch, nh, dh, st), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros((batch, cw - 1, di), dtype=cfg.dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, cw - 1, 2 * st), dtype=cfg.dtype,
                               device=device),
    }


def _mamba2_proj(params, cfg, x):
    return (x @ params["in_z"], x @ params["in_x"], x @ params["in_bc"],
            x @ params["in_dt"])


def _gated_norm(y, z, gain, eps):
    """Mamba2 output: RMSNorm(y * silu(z)) * gain, fp32 internals."""
    g = y * silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    return g / torch.sqrt(var + eps) * gain.float()


def _ssm_inputs(params, cfg, bcc, dt):
    """(B, C [.., st] fp32, dt [.., nh] fp32 after softplus, dA = dt * a)."""
    B, C = bcc.float().chunk(2, dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    return B, C, dt, dt * -torch.exp(params["A_log"])


def mamba2_forward(params, cfg, x, state=None):
    """SSD scan over the prompt. x: [b, s, d] -> (y, new_state);
    ``state`` None = zeros."""
    bsz, s, _ = x.shape
    nh, dh = cfg.ssm_heads, cfg.ssm_head_dim
    if state is None:
        state = mamba2_init_state(cfg, bsz, x.device)
    z, xi, BC, dt = _mamba2_proj(params, cfg, x)
    xc, tail_x = causal_conv(xi, params["conv_x_w"], params["conv_x_b"],
                             state["conv_x"])
    bcc, tail_bc = causal_conv(BC, params["conv_bc_w"], params["conv_bc_b"],
                               state["conv_bc"])
    xc, bcc = silu(xc), silu(bcc)
    B, C, dt, dA = _ssm_inputs(params, cfg, bcc, dt)
    xh = xc.float().reshape(bsz, s, nh, dh)
    y, h_last = mamba2_scan(xh, dt, dA, B, C, h0=state["h"])
    y = y + params["D"][:, None] * xh
    y = _gated_norm(y.reshape(bsz, s, -1), z, params["gate_norm"],
                    cfg.norm_eps).to(x.dtype)
    return y @ params["out_proj"], {"h": h_last, "conv_x": tail_x,
                                    "conv_bc": tail_bc}


def mamba2_decode(params, cfg, x1, state):
    """One token. x1: [b, 1, d] -> (y [b, 1, d], new_state)."""
    bsz = x1.shape[0]
    nh, dh = cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, BC, dt = (t[:, 0] for t in _mamba2_proj(params, cfg, x1))
    xc, tail_x = conv_step(xi, params["conv_x_w"], params["conv_x_b"],
                           state["conv_x"])
    bcc, tail_bc = conv_step(BC, params["conv_bc_w"], params["conv_bc_b"],
                             state["conv_bc"])
    xc, bcc = silu(xc), silu(bcc)
    B, C, dt, dA = _ssm_inputs(params, cfg, bcc, dt)
    xh = xc.float().reshape(bsz, nh, dh)
    h = (torch.exp(dA)[..., None, None] * state["h"]
         + torch.einsum("bh,bhd,bs->bhds", dt, xh, B))
    y = torch.einsum("bhds,bs->bhd", h, C) + params["D"][:, None] * xh
    y = _gated_norm(y.reshape(bsz, -1), z, params["gate_norm"],
                    cfg.norm_eps).to(x1.dtype)
    return (y @ params["out_proj"])[:, None], {"h": h, "conv_x": tail_x,
                                              "conv_bc": tail_bc}
