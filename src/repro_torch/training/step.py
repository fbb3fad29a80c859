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

Over a mesh the step takes parameters and moments placed by
``TRAIN_PARAM_RULES`` (``parallel/sharding.place_params``, moments by
``optim/adamw.adamw_init`` of the placed tree): ``train_loss`` runs them
coordinate by coordinate with the batch cut over 'data' where it divides
(``models/transformer.train_loss_tp``: FSDP's gathers, the tensor-parallel
``psum`` calls, and autograd's transposes of them in the backward); each
leaf's gradient is then summed over the axes it is copied over (an
``all-reduce``, GSPMD's data-parallel reduction), the global norm counts
each distinct element once (a replicated copy adds nothing), and AdamW
updates every coordinate's slice in place.

``parallel/compression.py`` holds the int8 cross-pod reduction
(``compress_psum_pod``, ``make_compressed_grad_fn``);
:func:`make_loss_grad_fn` gives it the ``loss_grad_fn`` it wraps.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWState, adamw_update, tree_leaves
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.parallel import sharding as SHD
from repro_torch.parallel.collectives import Shards, psum


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """[b, ...] leaves -> n dicts of [b / n, ...] slices. A leaf already
    scattered over the mesh (``sharding.Scattered``) is cut coordinate by
    coordinate: microbatch ``i`` holds slice ``i`` of every coordinate's
    rows (the same rows in all, grouped otherwise than slices of the
    global batch)."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        if isinstance(x, SHD.Scattered):
            parts = {c: t.split(t.shape[0] // n) for c, t in x.items()}
            for i in range(n):
                out[i][k] = SHD.Scattered(
                    {c: p[i] for c, p in parts.items()},
                    shape=(b // n,) + x.shape[1:], batch_axes=x.batch_axes)
            continue
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


def _placed_leaves(tree, path: str = "") -> list:
    """(path, Placed) of every leaf of a placed tree, in
    ``tree_leaves``'s order."""
    if isinstance(tree, SHD.Placed):
        return [(path, tree)]
    return [x for k, v in tree.items()
            for x in _placed_leaves(v, f"{path}.{k}" if path else k)]


def reduce_placed_grads(params, grads: list) -> tuple[list, torch.Tensor]:
    """The gradients of a placed tree's coordinate tensors (``grads`` in
    ``tree_leaves(params)``'s order) -> (each leaf's summed over the mesh
    axes it is copied over, the global norm: each distinct element once,
    on the mesh's home entry)."""
    out, i = [], 0
    mesh = SHD.placed_mesh(params)
    norms = Shards({k: torch.zeros((), dtype=torch.float32,
                                   device=mesh.devices[k])
                    for k in SHD.coord_keys(mesh)})
    for path, leaf in _placed_leaves(params):
        keys = list(leaf)
        sh = Shards(zip(keys, grads[i:i + len(keys)]))
        i += len(keys)
        sh = psum(sh, mesh, leaf.replicated_axes(), f"grad.{path}")
        for k in keys:
            if leaf.owns(k):
                norms[k] = norms[k] + sh[k].float().square().sum()
        out.extend(sh[k] for k in keys)
    total = psum(norms, mesh, tuple(mesh.axis_names), "grad_norm")
    return out, torch.sqrt(total[SHD.coord_keys(mesh)[0]])


def make_loss_grad_fn(cfg: ModelConfig, *, remat: str = "none"):
    """``loss_grad_fn(params, batch) -> ((loss, metrics), grads)``, the
    reference's ``jax.value_and_grad(train_loss, has_aux=True)``: grads a
    tree like ``params`` (a placed tree's reduced by
    :func:`reduce_placed_grads`)."""

    def fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = TF.train_loss(params, cfg, batch, remat=remat)
            grads = list(torch.autograd.grad(loss, leaves))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if SHD.is_placed(params):
            grads = reduce_placed_grads(params, grads)[0]
        it = iter(grads)
        return (loss.detach(), metrics), _rebuild(params, it)

    return fn


def _rebuild(tree, it):
    if isinstance(tree, SHD.Placed):
        return tree.with_parts({k: next(it) for k in tree})
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def make_train_step(cfg: ModelConfig, *, remat: str = "dots",
                    microbatches: int = 1, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                    unroll: bool = False):
    """Returns ``train_step(params, opt, batch, step) -> (params, opt,
    metrics)``; ``batch`` is a dict of tensors on the parameters' device
    (placed parameters: on the mesh's home entry), ``step`` a host int.
    ``params`` and the moments are updated in place. ``microbatches`` > 1
    sums the gradients of batch slices in fp32 (the loss and gradients
    are their means). ``unroll`` is the reference's analysis switch (its
    scans unrolled); the port's loops are always unrolled, so both values
    give the same step."""
    del unroll

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
        gn = None
        if SHD.is_placed(params):
            grads, gn = reduce_placed_grads(params, list(grads))
        lr = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        params, opt, om = adamw_update(grads, opt, params, lr,
                                       weight_decay=weight_decay,
                                       max_grad_norm=max_grad_norm,
                                       grad_norm=gn)
        return params, opt, {"loss": loss, "lr": lr, **om}

    return train_step
