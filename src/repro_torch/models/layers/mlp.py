"""Feed-forward (port of ``repro.models.layers.mlp``): gated (SwiGLU /
GeGLU) or plain, per config."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import dense_init

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_mlp(gen, cfg, device, *, layers: int = 0) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    kw = dict(layers=layers)
    p = {"w_up": dense_init(gen, (d, f), dt, device, **kw),
         "w_down": dense_init(gen, (f, d), dt, device, **kw)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (d, f), dt, device, **kw)
    return p


def mlp_forward(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: [b, s, d] -> [b, s, d]."""
    act = _ACTS[cfg.mlp_act]
    up = x @ params["w_up"]
    if cfg.mlp_gated:
        h = act(x @ params["w_gate"]) * up
    else:
        h = act(up)
    return h @ params["w_down"]
