"""GQA attention (port of ``repro.models.layers.attention``, the parts the
dense decoder uses): projections with the optional per-head q/k norms,
prefill through the flash-attention kernel, and dense-cache and
paged-pool decode in plain PyTorch.

``attention_prefill`` is where the reference calls its chunked jnp flash
attention (``chunked_attention``, whose contract the Pallas kernel in
``repro.kernels.flash_attention`` implements); here it calls the wrapper
of the port's flash-attention kernel (``kernels/flash_attention.py``),
which launches the CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors. The serving engine decodes against the paged
arena through ``serving/paged.py``'s island and the paged-attention
kernel; :func:`attention_decode_paged` is the reference's plain
counterpart over the pool's own layout, which neither main path calls.

Not in this port yet: sequence parallelism and cross attention.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers.norms import rms_norm_gain
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.params import dense_init, ones_init

NEG_INF = -1e30


def init_attention(gen, cfg, device, *, layers: int = 0) -> dict:
    d, h, kh, hd, dt = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.dtype)
    kw = dict(layers=layers)
    p = {
        "wq": dense_init(gen, (d, h, hd), dt, device, **kw),
        "wk": dense_init(gen, (d, kh, hd), dt, device, **kw),
        "wv": dense_init(gen, (d, kh, hd), dt, device, **kw),
        "wo": dense_init(gen, (h, hd, d), dt, device, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones_init((hd,), dt, device, **kw)
        p["k_norm"] = ones_init((hd,), dt, device, **kw)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[b, s, d] x [d, n, hd] -> [b, s, n, hd]."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def qkv_project(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                theta: float):
    """x: [b, s, d] -> q [b, s, h, hd], k/v [b, s, kh, hd] (q and k
    normed per head when ``cfg.qk_norm``, then roped)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm_gain(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm_gain(k, params["k_norm"], cfg.norm_eps)
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


def attention_decode_paged(params: dict, cfg, x: torch.Tensor,
                           pool_kv: torch.Tensor, pages: torch.Tensor,
                           lengths: torch.Tensor, *, theta: float,
                           layer_idx: int, window: int = 0):
    """One-token decode against the paged pool in its table layout, in
    plain PyTorch (the reference's pure-JAX ``attention_decode_paged``).

    pool_kv: [capacity, layers, 2, block, kh, hd]; pages: [b, max_blocks]
    pool row ids (``capacity`` = missing); lengths: [b] tokens already in
    the pool. The new token attends to itself as a separate term (its KV
    is returned for the caller to append), and with ``window > 0`` to the
    pool positions with ``lengths - pos <= window``, as in the reference.
    One masked softmax over the gathered blocks and the self term computes
    the reference's online softmax over blocks. Returns (out [b, 1, d],
    new_k [b, kh, hd], new_v [b, kh, hd])."""
    cap, block = pool_kv.shape[0], pool_kv.shape[3]
    b = x.shape[0]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nblocks = pages.shape[1]
    q, k, v = qkv_project(params, cfg, x, lengths[:, None], theta)
    qg = q.reshape(b, kh, h // kh, hd).float() * _scale(cfg)
    safe = torch.minimum(pages, torch.full_like(pages, cap - 1)).long()
    blk = pool_kv[:, layer_idx][safe].float()    # [b, nb, 2, block, kh, hd]
    kb = torch.cat([blk[:, :, 0].reshape(b, nblocks * block, kh, hd),
                    k.float()], dim=1)            # the self term last
    vb = torch.cat([blk[:, :, 1].reshape(b, nblocks * block, kh, hd),
                    v.float()], dim=1)
    s = _softcap(torch.einsum("bkgd,btkd->bkgt", qg, kb), cfg.attn_softcap)
    k_pos = torch.arange(nblocks * block, device=x.device)
    ok = (k_pos[None] < lengths[:, None]) & (pages < cap).repeat_interleave(
        block, dim=1)
    if window and window > 0:
        ok &= (lengths[:, None] - k_pos[None]) <= window
    ok = torch.cat([ok, torch.ones_like(ok[:, :1])], dim=1)
    p = torch.softmax(torch.where(ok[:, None, None], s, NEG_INF), dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, vb).reshape(b, 1, h, hd)
    return out_project(params, o.to(x.dtype)), k[:, 0], v[:, 0]
