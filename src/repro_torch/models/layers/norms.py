"""RMSNorm (port of ``repro.models.layers.norms``)."""
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
