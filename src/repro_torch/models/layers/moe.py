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
dispatch over placed weights (:func:`moe_ragged_tp`) keeps the
reference's global buffers: the capacity comes from the global token
count and each (token, slot)'s place in its expert's buffer from the
global running count (the counts of the batch slices before this one,
``all_gather``-ed over the batch axes), so the same tokens drop; each
coordinate fills its experts' rows with its own tokens and runs them, and
a ``psum`` over the experts' axes combines the slots.

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


def _router_tp(P: dict, cfg, x: Shards, tp, origin: str) -> Shards:
    """Each coordinate's fp32 router logits of every expert: its router
    columns' logits ``all_gather``-ed over the axes that cut ``expert``."""
    return tp.all_gather(
        Shards({k: (x[k] @ P["router"][k]).float() for k in tp.keys}),
        P["router"].axes_of(-1), -1, origin + ".router")


def _n_dp(tp) -> int:
    n = 1
    for a in tp.batch_axes:
        n *= int(tp.mesh.shape[a])
    return n


def moe_ragged_tp(P: dict, cfg, x: Shards, tp, *, origin: str):
    """:func:`moe_forward_ragged` over placed weights (module docstring):
    (out Shards [b_local, s, d], aux Shards)."""
    e, k = cfg.n_experts, cfg.top_k
    ex_axes = P["w_up"].axes_of(-3)
    n_dp = _n_dp(tp)
    k0 = tp.keys[0]
    b, s, d = x[k0].shape
    n = b * s
    n_glob = n * n_dp
    cap = min(max(8, int(CAPACITY_FACTOR * n_glob * k / e)), n_glob)
    logits = _router_tp(P, cfg, Shards({c: t.reshape(n, d) for c, t in
                                        x.items()}), tp, origin)
    route, counts, fracs = {}, Shards(), Shards()
    for c in tp.keys:
        probs, topv, topi = _route_logits(logits[c], cfg)
        flat_e = topi.reshape(-1)
        onehot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)
                  ).long()
        route[c] = (topv, flat_e, onehot)
        counts[c] = onehot.sum(dim=0)[None]
        fracs[c] = torch.stack([onehot.float().reshape(n, k, e).mean(
            dim=(0, 1)), probs.mean(dim=0)])
    # the (token, slot)s of the batch slices before this one, by expert
    before = tp.all_gather(counts, tp.batch_axes, 0, origin + ".counts")
    fracs = tp.psum(fracs, tp.batch_axes, origin + ".router_fractions")
    outs, aux = Shards(), Shards()
    names = tp.mesh.axis_names
    for c in tp.keys:
        topv, flat_e, onehot = route[c]
        i = 0
        for a in tp.batch_axes:
            i = i * int(tp.mesh.shape[a]) + c[names.index(a)]
        offset = before[c][:i].sum(dim=0)
        pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1 + offset[
            flat_e]
        e0, e1 = P["w_up"].range_of(-3, c)
        el = e1 - e0
        mine = (pos < cap) & (flat_e >= e0) & (flat_e < e1)
        dest = torch.where(mine, (flat_e - e0) * cap + pos, el * cap)
        xf = x[c].reshape(n, d)
        buf = torch.zeros((el * cap + 1, d), dtype=xf.dtype,
                          device=xf.device)
        buf.index_copy_(0, dest, xf.repeat_interleave(k, dim=0))
        y = _experts(local_tree(P, c), cfg, buf[:-1].reshape(el, cap, d)
                     ).reshape(el * cap, d)
        safe = torch.clamp(dest, max=el * cap - 1)
        got = torch.where(mine[:, None], y[safe].float(), 0.0)
        # this coordinate's experts' share of each token, an fp32 partial
        # rounded once after the psum (collectives.partial_product's rule)
        outs[c] = (got.reshape(n, k, d) * topv[..., None].float()).sum(
            dim=1).reshape(b, s, d)
        f = fracs[c]
        aux[c] = e * (f[0] * f[1]).sum() / (n_dp * n_dp)
    out = tp.sum_out(outs, ex_axes, origin + ".experts")
    return Shards({c: t.to(x[c].dtype) for c, t in out.items()}), aux


def moe_tp(P: dict, cfg, x: Shards, tp, *, origin: str):
    """The dense dispatch over placed weights ``P``: each coordinate's
    router columns -> ``all_gather`` of the logits over the axes that cut
    ``expert`` -> routing at every coordinate -> its experts (``w_up``'s
    expert slice) -> ``psum`` of the weighted outputs. Returns (out
    Shards [b_local, s, d], aux Shards of the load-balance loss: the
    fractions averaged over the batch axes first, as over the global
    batch)."""
    ex_axes = P["w_up"].axes_of(-3)
    logits = _router_tp(P, cfg, x, tp, origin)
    outs, fracs, weights = Shards(), Shards(), {}
    for k in tp.keys:
        w, fracs[k] = _weights_fracs(*_route_logits(logits[k], cfg))
        weights[k] = w.to(x[k].dtype)
    n_dp = _n_dp(tp)
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
    out = tp.sum_out(outs, ex_axes, origin + ".experts")
    return Shards({k: t.to(x[k].dtype) for k, t in out.items()}), aux
