"""GQA attention (port of ``repro.models.layers.attention``, the parts the
dense decoder uses): projections, prefill through the flash-attention
kernel, and dense-cache decode.

``attention_prefill`` is where the reference calls its chunked jnp flash
attention (``chunked_attention``, whose contract the Pallas kernel in
``repro.kernels.flash_attention`` implements); here it calls the wrapper
of the port's flash-attention kernel (``kernels/flash_attention.py``),
which launches the CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors. Decode against the paged pool lives in
``serving/paged.py``.

Not in this port yet: sequence parallelism, cross attention,
``attention_decode_paged`` and the q/k norms (``qk_norm``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.params import dense_init

NEG_INF = -1e30


def init_attention(gen, cfg, device, *, layers: int = 0) -> dict:
    d, h, kh, hd, dt = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.dtype)
    kw = dict(layers=layers)
    return {
        "wq": dense_init(gen, (d, h, hd), dt, device, **kw),
        "wk": dense_init(gen, (d, kh, hd), dt, device, **kw),
        "wv": dense_init(gen, (d, kh, hd), dt, device, **kw),
        "wo": dense_init(gen, (h, hd, d), dt, device, **kw),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[b, s, d] x [d, n, hd] -> [b, s, n, hd]."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def qkv_project(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                theta: float):
    """x: [b, s, d] -> q [b, s, h, hd], k/v [b, s, kh, hd] (roped)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def out_project(params: dict, attn: torch.Tensor) -> torch.Tensor:
    """attn: [b, s, h, hd] -> [b, s, d]."""
    wo = params["wo"]
    return attn.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale > 0 else cfg.head_dim ** -0.5


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def attention_prefill(params: dict, cfg, x: torch.Tensor,
                      positions: torch.Tensor, *, theta: float,
                      window: int = 0):
    """Causal self-attention over the prompt + its KV contribution.
    Returns (out [b, s, d], (k, v) [b, s, kh, hd])."""
    q, k, v = qkv_project(params, cfg, x, positions, theta)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=_scale(cfg), causal=True,
                        window=window, softcap=cfg.attn_softcap)
    return out_project(params, o.transpose(1, 2)), (k, v)


def attention_decode(params: dict, cfg, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, *, theta: float, window: int = 0):
    """One-token decode against a dense cache, in plain PyTorch (the
    reference's dense path; it reaches no kernel there either).

    x: [b, 1, d]; cache_k/v: [b, L, kh, hd]; lengths: [b] current cached
    length (the new token is written at ``lengths``). The caches are
    updated in place (the reference donates them to its jitted step).
    Returns (out [b, 1, d], cache_k, cache_v)."""
    b, L, kh, hd = cache_k.shape
    q, k, v = qkv_project(params, cfg, x, lengths[:, None], theta)
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, lengths] = k[:, 0]
    cache_v[bidx, lengths] = v[:, 0]

    h = cfg.n_heads
    g = h // kh
    qg = q.reshape(b, kh, g, hd).float() * _scale(cfg)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())
    s = _softcap(s, cfg.attn_softcap)
    k_pos = torch.arange(L, device=x.device)
    mask = k_pos[None, :] <= lengths[:, None]  # causal: includes the new token
    if window and window > 0:
        mask &= (lengths[:, None] - k_pos[None, :]) < window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    o = o.reshape(b, 1, h, hd).to(x.dtype)
    return out_project(params, o), cache_k, cache_v
