"""Feed-forward (port of ``repro.models.layers.mlp``): gated (SwiGLU /
GeGLU) or plain, per config. Over placed weights (:func:`mlp_tp`)
``w_gate`` / ``w_up`` are cut by columns and ``w_down`` by rows over
'mlp''s mesh axes, and the rows' partial outputs are summed (``psum``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import dense_init
from repro_torch.parallel.collectives import Shards
from repro_torch.parallel.sharding import local_tree

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
    return mlp_hidden(params, cfg, x) @ params["w_down"]


def mlp_hidden(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The activation before ``w_down``: x [b, s, d] -> [b, s, f]."""
    act = _ACTS[cfg.mlp_act]
    up = x @ params["w_up"]
    if cfg.mlp_gated:
        return act(x @ params["w_gate"]) * up
    return act(up)


def mlp_tp(P: dict, cfg, x: Shards, tp, *, origin: str) -> Shards:
    """:func:`mlp_forward` over placed weights ``P`` at every coordinate
    of ``tp``, ``w_down``'s partial products summed over the axes that
    cut its rows (``TP.rows``)."""
    h = Shards({key: mlp_hidden(local_tree(P, key), cfg, x[key])
                for key in tp.keys})
    return tp.rows(h, P["w_down"], P["w_down"].axes_of(-2),
                   origin + ".w_down", next(iter(x.values())).dtype)
