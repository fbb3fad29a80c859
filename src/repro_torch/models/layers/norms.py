"""RMSNorm (port of ``repro.models.layers.norms``): the block norms and the
per-head q/k norms (:func:`rms_norm_gain`)."""
from __future__ import annotations

import torch


def init_rmsnorm(d: int, dtype, device, *, layers: int = 0) -> dict:
    shape = ((layers,) if layers else ()) + (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, params: dict, eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics, output in ``x``'s dtype (the reference's math)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xn = xf / torch.sqrt(var + eps)
    return (xn * params["scale"].float()).to(x.dtype)


def rms_norm_gain(x: torch.Tensor, gain: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Norm over the last axis with a raw gain vector (the per-head q/k
    norms): fp32 statistics, output in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf / torch.sqrt(var + eps) * gain.float()).to(x.dtype)
