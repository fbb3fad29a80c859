"""Parameter initialisation (port of ``repro.models.params``).

A parameter tree is a nested dict of tensors with the reference's names
and its stacked-over-layers layout (``transformer.init_model``), so that
carrying weights across is one mapping (``repro_torch.convert``). The
reference's logical sharding axes have no counterpart here: the port runs
on one card.

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
