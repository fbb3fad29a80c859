"""AdamW (port of ``repro.optim.adamw``): fp32 moments, parameters kept
in their own dtype (bf16 at full width) and updated in fp32, rounded
once.

Unlike the reference, which is functional (its jitted step donates the
old state), :func:`adamw_update` updates the moments and the parameters
IN PLACE, leaf by leaf, and returns the same tensors: at gemma2-2b's
width a second copy of the moments would be 20.9 GB. The global norm is
taken first, then each leaf is clipped and updated on its own, so an
fp32 copy of every gradient (10.5 GB there) never exists at once.
Parameter trees are nested dicts of tensors, or of ``Placed`` leaves
(``parallel/sharding.place_params``): then every coordinate's slice is a
leaf of its own here, updated on its device with the same clip scale, and
the moments are placed as the parameters are (:func:`adamw_init`). The
caller gives the global norm of a placed tree (``grad_norm=``:
``training/step.py`` counts each distinct element once, not once a copy).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.parallel.sharding import Placed


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def tree_leaves(tree) -> list:
    """The leaves of a nested dict (in the order of its keys), list or
    tuple."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` of every leaf; a ``Placed`` leaf maps coordinate by
    coordinate and stays placed."""
    if isinstance(tree, Placed):
        parts = {k: fn(v) for k, v in tree.items()}
        return tree.with_parts(parts, dtype=next(iter(parts.values())).dtype)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def adamw_init(params) -> AdamWState:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamWState(mu=tree_map(zeros32, params),
                      nu=tree_map(zeros32, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (one leaf's fp32
    copy at a time)."""
    total = None
    for g in tree_leaves(grads):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads in fp32 scaled to a global norm of at most ``max_norm``,
    the global norm): the reference's function, for a tree small enough to
    hold in fp32 (:func:`adamw_update` clips leaf by leaf instead)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 grad_norm=None):
    """Returns (params, state, metrics); ``params``, ``state.mu`` and
    ``state.nu`` are updated in place (the returned trees are the same
    tensors), the count is a new tensor. ``grad_norm``: the global norm
    when the caller has it (a placed tree's), else :func:`global_norm`
    of ``grads``."""
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gn, max_norm=max_grad_norm)
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        g32 = g.float() * scale.to(g.device)
        m.mul_(b1).add_((1.0 - b1) * g32)
        v.mul_(b2).add_((1.0 - b2) * g32.square_())
        del g32
        upd = (m / bc1.to(m.device)).div_((v / bc2.to(m.device)).sqrt_()
                                          .add_(eps))
        p32 = p.float()
        upd.add_(weight_decay * p32)
        p.copy_(p32.sub_(lr * upd))
    return params, AdamWState(state.mu, state.nu, count), {"grad_norm": gn}
