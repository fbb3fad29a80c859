"""Mixture-of-Experts feed-forward (port of ``repro.models.layers.moe``:
granite-moe 32 experts / top-8, phi3.5-moe 16 experts / top-2).

The default path is the reference's **dense dispatch**: every token goes
through every expert, and the experts' outputs are combined with the
router's sparse top-k weights. :func:`moe_forward_ragged` is its
sort-based dispatch: tokens are placed in per-expert buffers of bounded
capacity, one ``[cap, d]`` batch an expert, and gathered back; a token
past its expert's capacity is dropped from that expert (Switch's rule).
The reference computes both in jnp outside any Pallas kernel; here they
are plain PyTorch products (``matmul`` / ``einsum``).

**Routing ties.** The router's logits are a product in the model's dtype
(bf16 logits often tie) before the fp32 softmax. ``jax.lax.top_k`` breaks
a tie toward the lower expert index, while ``torch.topk`` promises no
order on CUDA; :func:`top_k` takes the first k of a stable descending
sort, which keeps equal values in index order.

Over placed weights (:func:`moe_tp`) the experts are cut over 'model'
(``expert`` takes 'model', so ``mlp`` stays whole: a mesh axis cuts one
dimension). Each coordinate's router columns give its experts' logits,
which an ``all_gather`` joins before the fp32 softmax and the stable-sort
``top_k`` (the same logits at every coordinate, so the ties rule holds);
each coordinate runs its experts, and a ``psum`` combines them. The
load-balance fractions are summed over the batch axes first. The ragged
dispatch is not placed (it raises ``NotPorted`` over a mesh).

Both dispatches keep every shape static for a given token count (the
ragged buffer is ``[e * cap + 1, d]``, its last row the drop target), so
either one can run inside the captured decode graph.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers.mlp import _ACTS
from repro_torch.models.params import dense_init
from repro_torch.parallel.collectives import Shards
from repro_torch.parallel.sharding import local_tree

CAPACITY_FACTOR = 1.25   # the reference's default, the one its callers use


def init_moe(gen, cfg, device, *, layers: int = 0) -> dict:
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    kw = dict(layers=layers)
    p = {"router": dense_init(gen, (d, e), dt, device, **kw),
         "w_up": dense_init(gen, (e, d, f), dt, device, **kw),
         "w_down": dense_init(gen, (e, f, d), dt, device, **kw)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (e, d, f), dt, device, **kw)
    return p


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, a tie
    going to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: dict, cfg, xf: torch.Tensor):
    """xf [..., d] -> (fp32 probs [..., e], renormalised top-k values and
    their expert ids [..., k])."""
    return _route_logits((xf @ params["router"]).float(), cfg)


def _route_logits(logits: torch.Tensor, cfg):
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, cfg.top_k)
    return probs, topv / topv.sum(dim=-1, keepdim=True), topi


def _weights_fracs(probs, topv, topi):
    """(top-k weights [b, s, e] fp32, the fractions of tokens and of
    probability each expert takes, [2, e])."""
    weights = torch.zeros_like(probs).scatter(-1, topi, topv)
    frac_tokens = (weights > 0).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return weights, torch.stack([frac_tokens, frac_probs])


def router_probs(params: dict, cfg, x: torch.Tensor):
    """x [b, s, d] -> (weights [b, s, e] in x's dtype, only the top k
    nonzero; the Switch load-balance aux loss, fp32 scalar)."""
    weights, fr = _weights_fracs(*_route(params, cfg, x))
    aux = cfg.n_experts * (fr[0] * fr[1]).sum()
    return weights.to(x.dtype), aux


def _experts(params: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN over its own rows: h [e, n, d] (or [n, d],
    broadcast to every expert) -> [e, n, d]."""
    act = _ACTS[cfg.mlp_act]
    up = h @ params["w_up"]
    a = act(h @ params["w_gate"]) * up if cfg.mlp_gated else act(up)
    return a @ params["w_down"]


def moe_forward_dense(params: dict, cfg, x: torch.Tensor):
    """Dense dispatch: O(n_experts) compute a token (the reference's
    default). Returns (out [b, s, d], aux)."""
    b, s, d = x.shape
    weights, aux = router_probs(params, cfg, x)
    y = _experts(params, cfg, x.reshape(b * s, d))        # [e, n, d]
    out = torch.einsum("end,ne->nd", y, weights.reshape(b * s, -1))
    return out.reshape(b, s, d), aux


def moe_forward_ragged(params: dict, cfg, x: torch.Tensor):
    """Sort-based dispatch with ``cap = min(max(8, int(CAPACITY_FACTOR *
    n * k / e)), n)`` rows an expert; a (token, slot) past its expert's
    capacity goes to the scratch row ``e * cap`` and contributes 0.
    Returns (out [b, s, d], aux)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    cap = min(max(8, int(CAPACITY_FACTOR * n * k / e)), n)
    xf = x.reshape(n, d)
    probs, topv, topi = _route(params, cfg, xf)           # [n, e], [n, k]

    # each (token, slot)'s position in its expert's buffer: a running count
    flat_e = topi.reshape(-1)                             # [n * k]
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)).long()
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, e * cap)
    # only the scratch row can be written twice: the copy is deterministic
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, xf.repeat_interleave(k, dim=0))
    y = _experts(params, cfg, buf[:-1].reshape(e, cap, d)).reshape(e * cap,
                                                                   d)
    safe = torch.clamp(dest, max=e * cap - 1)
    gathered = torch.where(keep[:, None], y[safe], 0.0)   # [n * k, d]
    combined = (gathered.reshape(n, k, d)
                * topv[..., None].to(x.dtype)).sum(dim=1)

    frac_tokens = onehot.float().reshape(n, k, e).mean(dim=(0, 1)) * k
    frac_probs = probs.mean(dim=0)
    aux = e * (frac_tokens / k * frac_probs).sum()
    return combined.reshape(b, s, d), aux


def moe_forward(params: dict, cfg, x: torch.Tensor, *, ragged: bool = False):
    if ragged:
        return moe_forward_ragged(params, cfg, x)
    return moe_forward_dense(params, cfg, x)


def moe_tp(P: dict, cfg, x: Shards, tp, *, origin: str):
    """The dense dispatch over placed weights ``P``: each coordinate's
    router columns -> ``all_gather`` of the logits over the axes that cut
    ``expert`` -> routing at every coordinate -> its experts (``w_up``'s
    expert slice) -> ``psum`` of the weighted outputs. Returns (out
    Shards [b_local, s, d], aux Shards of the load-balance loss: the
    fractions averaged over the batch axes first, as over the global
    batch)."""
    ex_axes = P["w_up"].axes_of(-3)
    logits = tp.all_gather(
        Shards({k: (x[k] @ P["router"][k]).float() for k in tp.keys}),
        P["router"].axes_of(-1), -1, origin + ".router")
    outs, fracs, weights = Shards(), Shards(), {}
    for k in tp.keys:
        w, fracs[k] = _weights_fracs(*_route_logits(logits[k], cfg))
        weights[k] = w.to(x[k].dtype)
    n_dp = 1
    for a in tp.batch_axes:
        n_dp *= int(tp.mesh.shape[a])
    fracs = tp.psum(fracs, tp.batch_axes, origin + ".router_fractions")
    aux = Shards({k: cfg.n_experts * (f[0] * f[1]).sum() / (n_dp * n_dp)
                  for k, f in fracs.items()})
    for k in tp.keys:
        b, s, d = x[k].shape
        e0, e1 = P["w_up"].range_of(-3, k)
        y = _experts(local_tree(P, k), cfg, x[k].reshape(b * s, d))
        # the experts' weighted sum as an fp32 partial, rounded once
        # after the psum (collectives.partial_product's rule)
        outs[k] = torch.einsum("end,ne->nd", y.float(), weights[k].reshape(
            b * s, -1)[:, e0:e1].float()).reshape(b, s, d)
    out = tp.psum(outs, ex_axes, origin + ".experts")
    return Shards({k: t.to(x[k].dtype) for k, t in out.items()}), aux
