"""Dense decoder stack (port of ``repro.models.transformer``, the dense
path).

The reference runs a ``lax.scan`` over layer groups with stacked
parameters; here a Python loop walks the same stacked tensors layer by
layer (``params["layers"][...][i]``), so the parameter tree keeps the
reference's layout and names. Layers past the last full scan unit live
in ``tail_<t>`` as in the reference.

Ported: dense decoders with global and sliding-window attention layers,
attention and logit softcaps, scaled or tied embeddings. An MoE, SSM,
encoder-decoder, frontend, shared-block, sandwich-norm or q/k-norm config
raises :class:`~repro_torch.models.config.NotPorted`.

Entry points
    init_model(gen, cfg, device)     -> parameter tree
    prefill(params, cfg, batch)      -> (last-token logits, cache)
    init_cache(cfg, batch, max_len, device) -> dense decode cache
    decode_step(params, cfg, tokens, cache, lengths) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import (GLOBAL, LOCAL, ModelConfig,
                                       NotPorted)
from repro_torch.models.layers.attention import (NEG_INF, _softcap,
                                                 attention_decode,
                                                 attention_prefill,
                                                 init_attention)
from repro_torch.models.layers.mlp import init_mlp, mlp_forward
from repro_torch.models.layers.norms import init_rmsnorm, rms_norm
from repro_torch.models.params import dense_init


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder this port runs."""
    unsupported = {
        "MoE layers": cfg.is_moe,
        "SSM layers": bool(cfg.ssm_layer_ids),
        "encoder-decoder": cfg.is_encdec,
        f"the {cfg.frontend!r} frontend": cfg.frontend != "none",
        "the shared attention block": cfg.shared_attn_every > 0,
        "sandwich norms": cfg.sandwich_norm,
        "q/k norms": cfg.qk_norm,
    }
    for what, on in unsupported.items():
        if on:
            raise NotPorted(f"{cfg.name}: {what}")


# ======================================================== pattern utilities
def scan_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(group_size, n_groups, n_tail)."""
    gs = max(cfg.scan_group, 1)
    ng = cfg.n_layers // gs
    return gs, ng, cfg.n_layers - ng * gs


def _unit_pattern(cfg: ModelConfig) -> tuple[str, ...]:
    gs, ng, _ = scan_layout(cfg)
    unit = cfg.layer_pattern[:gs]
    for g in range(ng):
        if cfg.layer_pattern[g * gs:(g + 1) * gs] != unit:
            raise ValueError(f"layer_pattern of {cfg.name} does not tile "
                             f"with scan_group={gs}")
    return unit


def attn_positions(cfg: ModelConfig) -> tuple[int, ...]:
    """Indices (within the unit) of attention layers."""
    return tuple(i for i, k in enumerate(_unit_pattern(cfg))
                 if k in (GLOBAL, LOCAL))


def n_attn_layers(cfg: ModelConfig) -> int:
    """Total attention layers (scan + tail)."""
    return len(cfg.attn_layer_ids)


def layer_attrs(cfg: ModelConfig, i: int) -> tuple[int, float]:
    """(window, rope theta) of layer ``i``."""
    kind = cfg.layer_pattern[i]
    if kind == LOCAL:
        return cfg.window, cfg.rope_theta
    return 0, cfg.rope_theta_global or cfg.rope_theta


def layer_params(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s parameters: a slice of the stacked ``layers`` tree, or
    its ``tail_<t>`` tree."""
    gs, ng, _ = scan_layout(cfg)
    if i < ng * gs:
        return _index_tree(params["layers"], i)
    return params[f"tail_{i - ng * gs}"]


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ============================================================== init model
def _init_block(gen, cfg: ModelConfig, device, layers: int) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    return {
        "norm1": init_rmsnorm(d, dt, device, layers=layers),
        "attn": init_attention(gen, cfg, device, layers=layers),
        "norm2": init_rmsnorm(d, dt, device, layers=layers),
        "mlp": init_mlp(gen, cfg, device, layers=layers),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Parameter tree with the reference's names and layout, drawn from
    ``gen`` on ``device`` in ``cfg.dtype``."""
    check_supported(cfg)
    d, dt = cfg.d_model, cfg.dtype
    tree: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.padded_vocab, d), dt, device),
        "final_norm": init_rmsnorm(d, dt, device),
    }
    gs, ng, tail = scan_layout(cfg)
    _unit_pattern(cfg)
    if ng > 0:
        tree["layers"] = _init_block(gen, cfg, device, ng * gs)
    for t in range(tail):
        tree[f"tail_{t}"] = _init_block(gen, cfg, device, 0)
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (d, cfg.padded_vocab), dt, device)
    return tree


# ======================================================= embeddings / logits
def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def assemble_inputs(params: dict, cfg: ModelConfig, batch: dict):
    """tokens -> hidden [b, s, d] (frontends are not ported)."""
    return embed_tokens(params, cfg, batch["tokens"])


def logits_fn(params: dict, cfg: ModelConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., d] -> fp32 logits [..., padded_vocab] (softcapped,
    padded ids masked). The product runs in fp32, as the reference's."""
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = hidden.float() @ head.float()
    logits = _softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(ids < cfg.vocab, logits, NEG_INF)
    return logits


# ========================================================== stack (forward)
def attn_block_fwd(p: dict, cfg: ModelConfig, x, positions, *, window: int,
                   theta: float):
    """One attention + MLP block over the prompt. Returns (x, (k, v))."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    a, kv = attention_prefill(p["attn"], cfg, h, positions, theta=theta,
                              window=window)
    x = x + a
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_forward(p["mlp"], cfg, h), kv


def run_stack(params: dict, cfg: ModelConfig, x, positions, *,
              collect: bool = False):
    """Decoder stack. Returns (hidden, collected); ``collect=True``
    gathers every attention layer's KV as ``{"k", "v": [La, b, s, kh,
    hd]}`` (the prefill cache)."""
    check_supported(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        window, theta = layer_attrs(cfg, i)
        x, (k, v) = attn_block_fwd(layer_params(params, cfg, i), cfg, x,
                                   positions, window=window, theta=theta)
        if collect:
            ks.append(k)
            vs.append(v)
    collected = {}
    if collect and ks:
        collected = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, collected


# ============================================================== public API
def prefill(params: dict, cfg: ModelConfig, batch: dict):
    """Run the full prompt; returns (last-token logits [b, V], cache) with
    cache ``{"k", "v": [La, b, s, kh, hd]}``. The serving engine re-blocks
    k/v into the paged arena."""
    x = assemble_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, cache = run_stack(params, cfg, x, positions, collect=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x[:, -1]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Dense decode cache (the paged layout lives in ``serving/``)."""
    check_supported(cfg)
    la, kh, hd = n_attn_layers(cfg), cfg.n_kv_heads, cfg.head_dim
    shape = (la, batch, max_len, kh, hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def attn_block_decode(p: dict, cfg: ModelConfig, x1, cache_k, cache_v,
                      lengths, *, window: int, theta: float):
    """One-token decode through an attention block (dense cache, updated
    in place). Returns x1."""
    h = rms_norm(x1, p["norm1"], cfg.norm_eps)
    a, _, _ = attention_decode(p["attn"], cfg, h, cache_k, cache_v, lengths,
                               theta=theta, window=window)
    x1 = x1 + a
    h = rms_norm(x1, p["norm2"], cfg.norm_eps)
    return x1 + mlp_forward(p["mlp"], cfg, h)


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, lengths: torch.Tensor):
    """One decode token for the whole batch (dense-cache reference path).

    tokens: [b] int; lengths: [b] tokens already in cache. Returns
    (logits [b, V], cache); the cache's tensors are written in place."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])
    lengths = lengths.long()
    for i in range(cfg.n_layers):
        window, theta = layer_attrs(cfg, i)
        x = attn_block_decode(layer_params(params, cfg, i), cfg, x,
                              cache["k"][i], cache["v"][i], lengths,
                              window=window, theta=theta)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), cache
