"""Parameter initialisation (port of ``repro.models.params``).

A parameter tree is a nested dict of tensors with the reference's names
and its stacked-over-layers layout (``transformer.init_model``), so that
carrying weights across is one mapping (``repro_torch.convert``).
:func:`param_axes` gives the reference's logical sharding axes beside it:
a tree of the same structure with, at every leaf, one axis name a
dimension (the reference keeps them beside each initializer as
``Annot``), from which ``parallel/sharding.place_params`` places the
weights over a mesh.

Every initializer draws from an explicit ``torch.Generator`` on the target
device; the numbers differ from the reference's ``jax.random`` draws for
the same seed, so tests carry the reference's weights across instead.
"""
from __future__ import annotations

import math

import torch


def fan_in(shape: tuple[int, ...]) -> int:
    """The reference's heuristic: the last axis is the output, the rest
    the input; a 1-d shape is its own fan."""
    if len(shape) == 1:
        return shape[0]
    return math.prod(shape[:-1])


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype,
               device, *, scale: float = 1.0, layers: int = 0) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) drawn in fp32 and cast to ``dtype``.
    ``layers > 0`` stacks that many independent draws on a leading axis
    (one layer at a time, so the fp32 draw never exceeds one layer)."""
    std = scale / math.sqrt(max(fan_in(shape), 1))
    out = torch.empty(((layers,) if layers else ()) + tuple(shape),
                      dtype=dtype, device=device)
    for i in range(max(layers, 1)):
        draw = torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)
        (out[i] if layers else out).copy_(draw)
    return out


def zeros_init(shape: tuple[int, ...], dtype, device, *,
               layers: int = 0) -> torch.Tensor:
    """Zeros in ``dtype`` (the reference's ``zeros_init``; ``layers > 0``
    stacks them on a leading axis)."""
    return torch.zeros(((layers,) if layers else ()) + tuple(shape),
                       dtype=dtype, device=device)


def ones_init(shape: tuple[int, ...], dtype, device, *,
              layers: int = 0) -> torch.Tensor:
    """Ones in ``dtype`` (the reference's ``ones_init``)."""
    return torch.ones(((layers,) if layers else ()) + tuple(shape),
                      dtype=dtype, device=device)


# ------------------------------------------------------- logical axes
def _norm_axes() -> dict:
    return {"scale": ("embed",)}


def _attention_axes(cfg) -> dict:
    p = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qk_norm:
        p["q_norm"] = p["k_norm"] = ("head_dim",)
    return p


def _mlp_axes(cfg) -> dict:
    p = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.mlp_gated:
        p["w_gate"] = ("embed", "mlp")
    return p


def _moe_axes(cfg) -> dict:
    p = {"router": ("embed", "expert"),
         "w_up": ("expert", "embed", "mlp"),
         "w_down": ("expert", "mlp", "embed")}
    if cfg.mlp_gated:
        p["w_gate"] = ("expert", "embed", "mlp")
    return p


def _mamba1_axes() -> dict:
    return {"in_x": ("embed", "inner"), "in_z": ("embed", "inner"),
            "conv_w": ("inner", "conv"), "conv_b": ("inner",),
            "x_proj": ("inner", "lowrank"), "dt_proj": ("lowrank", "inner"),
            "dt_bias": ("inner",), "A_log": ("inner", "state"),
            "D": ("inner",), "out_proj": ("inner", "embed")}


def _mamba2_axes() -> dict:
    return {"in_z": ("embed", "inner"), "in_x": ("embed", "inner"),
            "in_bc": ("embed", None), "in_dt": ("embed", "ssm_heads"),
            "conv_x_w": ("inner", "conv"), "conv_x_b": ("inner",),
            "conv_bc_w": (None, "conv"), "conv_bc_b": (None,),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "dt_bias": ("ssm_heads",), "gate_norm": ("inner",),
            "out_proj": ("inner", "embed")}


def block_axes(cfg, kind: str, *, cross: bool = False) -> dict:
    """The axes of one layer of ``kind`` (``transformer.init_block``'s
    tree)."""
    from repro_torch.models.config import MAMBA1, MAMBA2
    if kind in (MAMBA1, MAMBA2):
        return {"norm1": _norm_axes(),
                "mamba": _mamba1_axes() if kind == MAMBA1 else _mamba2_axes()}
    p = {"norm1": _norm_axes(), "attn": _attention_axes(cfg),
         "norm2": _norm_axes(),
         "mlp": _moe_axes(cfg) if cfg.is_moe else _mlp_axes(cfg)}
    if cfg.sandwich_norm:
        p["norm1_post"] = _norm_axes()
        p["norm2_post"] = _norm_axes()
    if cross:
        p["norm_x"] = _norm_axes()
        p["cross"] = _attention_axes(cfg)
    return p


def _stacked(tree: dict) -> dict:
    return {k: _stacked(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in tree.items()}


def param_axes(cfg) -> dict:
    """The reference's logical axes of ``transformer.init_model(cfg)``'s
    tree: the same structure, a tuple of axis names (or None) at every
    leaf, the stacked layers' first axis ``"layers"``."""
    from repro_torch.models.config import GLOBAL
    gs = max(cfg.scan_group, 1)
    ng = cfg.n_layers // gs
    cross = cfg.is_encdec
    tree: dict = {"embed": ("vocab", "embed"), "final_norm": _norm_axes()}
    if ng > 0:
        tree["layers"] = _stacked(block_axes(cfg, cfg.layer_pattern[0],
                                             cross=cross))
    for t in range(cfg.n_layers - ng * gs):
        tree[f"tail_{t}"] = block_axes(cfg, cfg.layer_pattern[ng * gs + t],
                                       cross=cross)
    if cfg.shared_attn_every > 0:
        tree["shared"] = block_axes(cfg, GLOBAL)
    if cross:
        tree["encoder"] = {"layers": _stacked(block_axes(cfg, GLOBAL)),
                           "final_norm": _norm_axes()}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree
