"""The training step (port of ``repro.training.step``): microbatched
gradient accumulation, the remat policy, the cosine schedule and AdamW;
plus the int8 gradient compression helpers.

The reference lowers a pure step under ``jit``; here the step runs
eagerly: autograd takes the gradient of ``train_loss`` with respect to
every parameter leaf (``torch.autograd.grad``, so no ``.grad`` is kept on
the leaves), microbatch gradients are summed in fp32, and
:func:`~repro_torch.optim.adamw.adamw_update` updates the parameters and
moments in place. On the card every attention layer's forward and
backward are the flash kernels (``kernels/flash_attention.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWState, adamw_update, tree_leaves
from repro_torch.optim.schedule import cosine_schedule


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """[b, ...] leaves -> n dicts of [b / n, ...] slices."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        for i, part in enumerate(x.split(b // n)):
            out[i][k] = part
    return out


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization: (q, scale)."""
    absmax = g.abs().max()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def make_train_step(cfg: ModelConfig, *, remat: str = "dots",
                    microbatches: int = 1, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns ``train_step(params, opt, batch, step) -> (params, opt,
    metrics)``; ``batch`` is a dict of tensors on the parameters' device,
    ``step`` a host int. ``params`` and the moments are updated in place.
    ``microbatches`` > 1 sums the gradients of batch slices in fp32 (the
    loss and gradients are their means)."""

    def grads_of(leaves, params, mb):
        loss, _ = TF.train_loss(params, cfg, mb, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt: AdamWState, batch: dict, step: int):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches > 1:
            g_sum, loss_sum = None, 0.0
            for mb in _split_microbatches(batch, microbatches):
                loss, g = grads_of(leaves, params, mb)
                g = [x.float() for x in g]
                g_sum = g if g_sum is None else [
                    a.add_(b) for a, b in zip(g_sum, g)]
                loss_sum = loss_sum + loss
                del g
            grads = [a.div_(microbatches) for a in g_sum]
            loss = loss_sum / microbatches
        else:
            loss, grads = grads_of(leaves, params, batch)
        for p in leaves:
            p.requires_grad_(False)
        lr = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        params, opt, om = adamw_update(grads, opt, params, lr,
                                       weight_decay=weight_decay,
                                       max_grad_norm=max_grad_norm)
        return params, opt, {"loss": loss, "lr": lr, **om}

    return train_step
