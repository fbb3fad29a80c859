"""Rotary position embeddings (port of ``repro.models.layers.rope``):
GPT-NeoX convention (split halves), fp32 angles."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exp = torch.arange(0, head_dim, 2, dtype=torch.float32,
                       device=device) / head_dim
    # a fill kernel: a host scalar copied to a card would sync
    return torch.full((), theta, dtype=torch.float32, device=device) ** (-exp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int).
    Rotates (x[i], x[i + hd/2]) pairs; the output keeps ``x``'s dtype."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * inv              # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                    # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
