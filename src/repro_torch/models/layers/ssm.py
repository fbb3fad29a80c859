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

Over placed weights (``parallel/sharding.place_params``) each coordinate
runs its slice of ``d_inner`` and of the SSM heads: Mamba2's ``in_z`` /
``in_x`` / ``conv_x_*`` / ``gate_norm`` by ``inner``, ``in_dt`` /
``A_log`` / ``D`` / ``dt_bias`` by ``ssm_heads`` (``in_bc`` / ``conv_bc_*``
whole), the gated norm's mean of squares summed over the shards
(``psum``), and ``out_proj``'s rows summed (``psum``); Mamba1's
``x_proj`` rows summed before ``dt_proj``, which is cut by columns. The
decode states are placed by the reference's serving spec; a state the
computation needs whole at a coordinate (Mamba2's ``conv_bc`` tail) is
gathered and only the coordinate's slice written back.

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
from repro_torch.parallel.collectives import Shards, partial_product
from repro_torch.parallel.sharding import local_tree

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


def _mamba1_ssm_inputs(params, cfg, dbc):
    """Shared pre-scan math from ``dbc`` = x_proj of the post-conv,
    post-silu input (fp32 [b, s, dt_rank + 2 state]). Returns (dt [b, s,
    di] fp32 after softplus, B, C [b, s, st] fp32)."""
    dr, st = cfg.ssm_dt_rank, cfg.ssm_state
    dt_lr, B, C = dbc.split([dr, st, st], dim=-1)
    dt = dt_lr @ params["dt_proj"].float()
    return F.softplus(dt + params["dt_bias"]), B, C


def _mamba1_pre(params, x, conv):
    """The input projections and the causal conv of the prompt (the
    conv's carried tail ``conv``): (xc post-conv post-silu, z, new
    tail)."""
    xi, z = x @ params["in_x"], x @ params["in_z"]
    xc, conv_tail = causal_conv(xi, params["conv_w"], params["conv_b"], conv)
    return silu(xc), z, conv_tail


def _mamba1_scan(params, cfg, xc, z, dbc, h, dtype):
    """The selective scan from ``dbc`` (:func:`_mamba1_ssm_inputs`) in
    chunks of ``cfg.ssm_chunk`` carrying ``h``: (y [b, s, di] in
    ``dtype`` before ``out_proj``, the last state)."""
    s = xc.shape[1]
    dt, B, C = _mamba1_ssm_inputs(params, cfg, dbc)
    A = -torch.exp(params["A_log"].float())             # [di, st]
    xcf = xc.float()
    ys = []
    for c0 in range(0, s, cfg.ssm_chunk):
        c = slice(c0, c0 + cfg.ssm_chunk)
        a = torch.exp(dt[:, c, :, None] * A)            # [b, c, di, st]
        bx = (dt[:, c] * xcf[:, c])[..., None] * B[:, c, None, :]
        hs, h = linear_scan(a, bx, h)
        ys.append(torch.einsum("bcis,bcs->bci", hs, C[:, c]))
    y = torch.cat(ys, dim=1) + params["D"] * xcf
    return (y * silu(z.float())).to(dtype), h


def mamba1_forward(params, cfg, x, state=None):
    """Selective scan over the prompt. x: [b, s, d] -> (y [b, s, d],
    new_state); ``state`` None = zeros. Any ``s`` is taken in chunks of
    ``cfg.ssm_chunk`` (the last one ragged), each one :func:`linear_scan`
    over a ``[b, chunk, d_inner, state]`` working set carrying h."""
    bsz = x.shape[0]
    if state is None:
        state = mamba1_init_state(cfg, bsz, x.device)
    xc, z, conv_tail = _mamba1_pre(params, x, state["conv"])
    dbc = (xc @ params["x_proj"]).float()
    y, h = _mamba1_scan(params, cfg, xc, z, dbc, state["h"], x.dtype)
    return y @ params["out_proj"], {"h": h, "conv": conv_tail}


def _mamba1_step_pre(params, x1, conv):
    xi, z = (x1 @ params["in_x"])[:, 0], (x1 @ params["in_z"])[:, 0]
    xc, conv_tail = conv_step(xi, params["conv_w"], params["conv_b"], conv)
    return silu(xc), z, conv_tail


def _mamba1_step(params, cfg, xc, z, dbc, h0, dtype):
    """One token's recurrence from ``dbc`` [b, 1, dt_rank + 2 state]:
    (y [b, di] in ``dtype`` before ``out_proj``, the new state)."""
    dt, B, C = (t[:, 0] for t in _mamba1_ssm_inputs(params, cfg, dbc))
    A = -torch.exp(params["A_log"].float())
    xf = xc.float()
    h = torch.exp(dt[..., None] * A) * h0 + (dt * xf)[..., None] * \
        B[:, None, :]
    y = torch.einsum("bis,bs->bi", h, C) + params["D"] * xf
    return (y * silu(z.float())).to(dtype), h


def mamba1_decode(params, cfg, x1, state):
    """One token. x1: [b, 1, d] -> (y [b, 1, d], new_state)."""
    xc, z, conv_tail = _mamba1_step_pre(params, x1, state["conv"])
    dbc = (xc[:, None] @ params["x_proj"]).float()
    y, h = _mamba1_step(params, cfg, xc, z, dbc, state["h"], x1.dtype)
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
    if state is None:
        state = mamba2_init_state(cfg, x.shape[0], x.device)
    y, z, new = _mamba2_inner(params, cfg, x, state)
    y = _gated_norm(y, z, params["gate_norm"], cfg.norm_eps).to(x.dtype)
    return y @ params["out_proj"], new


def _mamba2_inner(params, cfg, x, state):
    """The SSD block up to its gated norm: (y [b, s, di] fp32, z [b, s,
    di], new_state). The heads are ``params["A_log"]``'s (a placed
    block's own)."""
    bsz, s, _ = x.shape
    nh, dh = params["A_log"].shape[-1], cfg.ssm_head_dim
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
    return y.reshape(bsz, s, -1), z, {"h": h_last, "conv_x": tail_x,
                                      "conv_bc": tail_bc}


def mamba2_decode(params, cfg, x1, state):
    """One token. x1: [b, 1, d] -> (y [b, 1, d], new_state)."""
    y, z, new = _mamba2_step_inner(params, cfg, x1, state)
    y = _gated_norm(y, z, params["gate_norm"], cfg.norm_eps).to(x1.dtype)
    return (y @ params["out_proj"])[:, None], new


def _mamba2_step_inner(params, cfg, x1, state):
    """One token up to the gated norm: (y [b, di] fp32, z [b, di],
    new_state)."""
    bsz = x1.shape[0]
    nh, dh = params["A_log"].shape[-1], cfg.ssm_head_dim
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
    return y.reshape(bsz, -1), z, {"h": h, "conv_x": tail_x,
                                   "conv_bc": tail_bc}


# ============================================================ tensor parallel
def _local_states(state: dict, needs: dict, tp, origin: str):
    """One layer's placed decode state (name -> ``Placed`` [b_local, ...])
    as the coordinates compute on it: ``needs`` maps a name to (dim,
    key -> the global [start, stop) the coordinate computes along dim).
    Returns ({key: {name: tensor}}, write(news)) where ``write`` stores
    each coordinate's new state in place (only the slice a gathered leaf
    holds)."""
    views: dict = {k: {} for k in tp.keys}
    gathered = {}
    for name, leaf in state.items():
        dim, want = needs[name]
        held = {k: leaf.range_of(dim, k) for k in tp.keys}
        if all(held[k][0] <= want(k)[0] and want(k)[1] <= held[k][1]
               for k in tp.keys):
            src = {k: (leaf[k], held[k][0]) for k in tp.keys}
        else:
            full = tp.all_gather(Shards(leaf), leaf.axes_of(dim), dim,
                                 f"{origin}.{name}")
            src = {k: (full[k], 0) for k in tp.keys}
            gathered[name] = held
        for k in tp.keys:
            r0, r1 = want(k)
            t, base = src[k]
            views[k][name] = t.narrow(dim, r0 - base, r1 - r0)

    def write(news: dict) -> None:
        for name, leaf in state.items():
            dim, want = needs[name]
            for k in tp.keys:
                new = news[k][name]
                if name in gathered:
                    h0, h1 = gathered[name][k]
                    leaf[k].copy_(new.narrow(dim, h0 - want(k)[0], h1 - h0))
                else:
                    views[k][name].copy_(new)

    return views, write


def _gated_norm_tp(P: dict, cfg, ys: Shards, zs: Shards, tp, origin: str,
                   dtype) -> dict:
    """:func:`_gated_norm` over ``d_inner`` shards: the sum of squares
    summed over the axes that cut ``gate_norm``, then divided by the
    whole ``d_inner``."""
    g = {k: ys[k] * silu(zs[k].float()) for k in tp.keys}
    ss = tp.psum(Shards({k: t.square().sum(dim=-1, keepdim=True)
                         for k, t in g.items()}),
                 P["gate_norm"].axes_of(-1), origin + ".gate_norm")
    di = P["gate_norm"].shape[-1]
    return {k: (g[k] / torch.sqrt(ss[k] / di + cfg.norm_eps)
                * P["gate_norm"][k].float()).to(dtype) for k in tp.keys}


def _out_tp(P: dict, ys: dict, tp, origin: str) -> Shards:
    return tp.rows(Shards(ys), P["out_proj"], P["out_proj"].axes_of(-2),
                   origin + ".out_proj", next(iter(ys.values())).dtype)


def _mamba2_needs(P: dict) -> dict:
    return {"h": (1, lambda k: P["A_log"].range_of(-1, k)),
            "conv_x": (2, lambda k: P["conv_x_b"].range_of(-1, k)),
            "conv_bc": (2, lambda k: P["conv_bc_b"].range_of(-1, k))}


def _mamba1_needs(P: dict) -> dict:
    return {"h": (1, lambda k: P["D"].range_of(-1, k)),
            "conv": (2, lambda k: P["conv_b"].range_of(-1, k))}


def mamba2_forward_tp(P: dict, cfg, x: Shards, tp, *, origin: str):
    """:func:`mamba2_forward` over placed weights ``P`` from zero states:
    each coordinate's heads through the scan kernel. Returns (y Shards
    [b_local, s, d], Shards of each coordinate's final state)."""
    ys, zs, news = Shards(), Shards(), Shards()
    for k in tp.keys:
        p = local_tree(P, k)
        b, cw = x[k].shape[0], cfg.ssm_conv
        zero = {"h": torch.zeros((b, p["A_log"].shape[-1], cfg.ssm_head_dim,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=x[k].device),
                "conv_x": x[k].new_zeros((b, cw - 1, p["conv_x_b"].shape[-1])),
                "conv_bc": x[k].new_zeros((b, cw - 1,
                                           p["conv_bc_b"].shape[-1]))}
        ys[k], zs[k], news[k] = _mamba2_inner(p, cfg, x[k], zero)
    y = _gated_norm_tp(P, cfg, ys, zs, tp, origin, x[tp.keys[0]].dtype)
    return _out_tp(P, y, tp, origin), news


def mamba2_decode_tp(P: dict, cfg, x1: Shards, state: dict, tp, *,
                     origin: str) -> Shards:
    """One token over placed weights and a placed state (updated in
    place). Returns y Shards [b_local, 1, d]."""
    views, write = _local_states(state, _mamba2_needs(P), tp, origin)
    ys, zs, news = Shards(), Shards(), {}
    for k in tp.keys:
        ys[k], zs[k], news[k] = _mamba2_step_inner(local_tree(P, k), cfg,
                                                   x1[k], views[k])
    write(news)
    y = _gated_norm_tp(P, cfg, ys, zs, tp, origin, x1[tp.keys[0]].dtype)
    return Shards({k: t[:, None] for k, t in _out_tp(P, y, tp,
                                                     origin).items()})


def mamba1_forward_tp(P: dict, cfg, x: Shards, tp, *, origin: str):
    """:func:`mamba1_forward` over placed weights ``P`` from zero states.
    Returns (y Shards [b_local, s, d], Shards of the final states)."""
    pre, dbc = {}, Shards()
    for k in tp.keys:
        p = local_tree(P, k)
        conv = x[k].new_zeros((x[k].shape[0], cfg.ssm_conv - 1,
                               p["conv_b"].shape[-1]))
        pre[k] = _mamba1_pre(p, x[k], conv)
        dbc[k] = partial_product(pre[k][0], p["x_proj"])
    dbc = tp.psum(dbc, P["x_proj"].axes_of(-2), origin + ".x_proj")
    ys, news = {}, Shards()
    for k in tp.keys:
        p = local_tree(P, k)
        xc, z, tail = pre[k]
        h0 = torch.zeros(xc.shape[:1] + tuple(p["A_log"].shape),
                         dtype=torch.float32, device=xc.device)
        ys[k], h = _mamba1_scan(p, cfg, xc, z, dbc[k].float(), h0,
                                x[k].dtype)
        news[k] = {"h": h, "conv": tail}
    return _out_tp(P, ys, tp, origin), news


def mamba1_decode_tp(P: dict, cfg, x1: Shards, state: dict, tp, *,
                     origin: str) -> Shards:
    """One token of Mamba1 over placed weights and a placed state."""
    views, write = _local_states(state, _mamba1_needs(P), tp, origin)
    pre, dbc = {}, Shards()
    for k in tp.keys:
        p = local_tree(P, k)
        pre[k] = _mamba1_step_pre(p, x1[k], views[k]["conv"])
        dbc[k] = partial_product(pre[k][0][:, None], p["x_proj"])
    dbc = tp.psum(dbc, P["x_proj"].axes_of(-2), origin + ".x_proj")
    ys, news = {}, {}
    for k in tp.keys:
        xc, z, tail = pre[k]
        ys[k], h = _mamba1_step(local_tree(P, k), cfg, xc, z, dbc[k].float(),
                                views[k]["h"], x1[k].dtype)
        news[k] = {"h": h, "conv": tail}
    write(news)
    return Shards({k: t[:, None] for k, t in _out_tp(P, ys, tp,
                                                     origin).items()})
