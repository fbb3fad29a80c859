"""GQA attention (port of ``repro.models.layers.attention``):
projections with the optional per-head q/k norms, causal prefill and
non-causal self and cross attention through the flash-attention kernel,
and dense-cache and paged-pool decode in plain PyTorch.

``attention_prefill``, ``attention_forward`` and ``cross_attention`` are
where the reference calls its chunked jnp flash attention
(``chunked_attention``, whose contract the Pallas kernel in
``repro.kernels.flash_attention`` implements); here they call the wrapper
of the port's flash-attention kernel (``kernels/flash_attention.py``),
which launches the CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors. That kernel has no tail mask over the keys: a
``kv_valid`` (the reference's optional per-sequence count of valid keys,
which neither its prefill nor its training loss passes) is computed by a
plain masked softmax on the CPU and refused on the card. The serving
engine decodes against the paged arena through ``serving/paged.py``'s
island and the paged-attention kernel; :func:`attention_decode_paged` is
the reference's plain counterpart over the pool's own layout, which
neither main path calls. Cross attention (the encoder-decoder) takes no
RoPE and no q/k norms: its K/V come from :func:`cross_kv` of the encoder
output.

Sequence parallelism (the reference's lever for head counts that do not
divide the model axis): with ``cfg.attn_seq_shard``, a current mesh
(``parallel.sharding.axis_rules(rules, mesh)``) with a ``model`` axis and
no ``kv_valid``, :func:`attention_forward` splits the query sequence into
``n_model`` slices and runs each through the flash-attention kernel on
its ``model`` coordinate's device, with ``q_offset`` at the slice's first
position, over the full K/V; the slices meet on the query's device. A
sequence that does not split evenly takes the path without a mesh, as in
the reference. The gradient flows through the kernel's backward
(``FlashAttention``).

Tensor parallelism (weights placed by ``parallel/sharding.place_params``):
:func:`attention_tp` and :func:`cross_attention_tp` run every mesh
coordinate's q / k / v columns (its heads, by ``wq`` / ``wk`` / ``wv``'s
placement over 'model') through the flash kernel on that coordinate, and
sum the rows of ``wo`` with a ``psum`` over the axes that cut its heads.
Where the kv heads do not divide 'model' the reference's ``specs_for_tree``
keeps ``wk`` / ``wv`` whole, and a coordinate's q heads read kv head
``q_head // (h / kh)`` of its whole copy (:func:`kv_slice`). With
``cfg.attn_seq_shard`` the placed self-attention without its KV (the
training loss, the encoder: where the reference's ``attention_forward``
takes its sequence-parallel island) cuts the query sequence over 'model'
instead (:func:`_seqpar_tp`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers.norms import rms_norm_gain
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.params import dense_init, ones_init
from repro_torch.parallel import sharding as SHD
from repro_torch.parallel.collectives import Shards

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
    o = _attend(cfg, q, k, v, causal=True, window=window)
    return out_project(params, o), (k, v)


def _attend(cfg, q, k, v, *, causal: bool, window: int = 0,
            kv_valid=None) -> torch.Tensor:
    """q [b, sq, h, hd], k/v [b, sk, kh, hd] -> [b, sq, h, hd] through the
    flash kernel (the ``[b, heads, s, hd]``-transposed views it reads in
    place); with ``kv_valid`` [b] only each sequence's first
    ``kv_valid`` keys count (plain, CPU tensors only)."""
    if kv_valid is not None:
        if q.device.type != "cpu":
            raise ValueError("kv_valid: the flash kernel has no tail mask "
                             "over the keys")
        return _masked_attention(cfg, q, k, v, causal=causal, window=window,
                                 kv_valid=kv_valid)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=_scale(cfg), causal=causal,
                        window=window, softcap=cfg.attn_softcap)
    return o.transpose(1, 2)


def _masked_attention(cfg, q, k, v, *, causal, window, kv_valid):
    """The reference's ``chunked_attention`` with its ``kv_valid`` tail
    mask, as one masked softmax (fp32 math, output in q's dtype)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd).float() * _scale(cfg)
    s = _softcap(torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()),
                 cfg.attn_softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window and window > 0:
        mask &= (q_pos - k_pos) < window
    mask = mask & (k_pos < kv_valid.reshape(b, 1, 1))   # [b, sq, sk]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _seqpar_attention(cfg, q, k, v, *, causal: bool, window: int, mesh):
    """The query sequence split over the mesh's ``model`` axis: slice
    ``i`` of ``sq / n_model`` queries attends the full K/V through the
    flash kernel with ``q_offset = i * s_local``, on the device of
    ``model`` coordinate ``i`` (the other axes at index 0); the slices are
    concatenated on q's device. None where ``sq`` does not split evenly
    (the caller then takes the path without a mesh)."""
    n_model = int(mesh.shape["model"])
    sq = q.shape[1]
    if sq % n_model:
        return None
    mesh.require_runnable("sequence-parallel attention")
    s_local = sq // n_model
    outs = []
    for i in range(n_model):
        dev = mesh.device_at({"model": i})
        ql = q[:, i * s_local:(i + 1) * s_local].to(dev)
        o = flash_attention(ql.transpose(1, 2), k.to(dev).transpose(1, 2),
                            v.to(dev).transpose(1, 2), scale=_scale(cfg),
                            causal=causal, window=window,
                            softcap=cfg.attn_softcap, q_offset=i * s_local)
        outs.append(o.transpose(1, 2).to(q.device))
    return torch.cat(outs, dim=1)


def attention_forward(params: dict, cfg, x: torch.Tensor,
                      positions: torch.Tensor, *, theta: float,
                      window: int = 0, causal: bool = True, kv_valid=None):
    """Self-attention sub-layer over [b, s, d], causal or not (the
    encoder's), without its KV (no residual or norm here); sequence-
    parallel where ``cfg.attn_seq_shard`` and the current mesh say so
    (module docstring)."""
    q, k, v = qkv_project(params, cfg, x, positions, theta)
    if cfg.attn_seq_shard:
        mesh = SHD.current_mesh()
        if (mesh is not None and "model" in mesh.axis_names
                and kv_valid is None):
            o = _seqpar_attention(cfg, q, k, v, causal=causal,
                                  window=window, mesh=mesh)
            if o is not None:
                return out_project(params, o)
    return out_project(params, _attend(cfg, q, k, v, causal=causal,
                                       window=window, kv_valid=kv_valid))


def attention_decode(params: dict, cfg, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, *, theta: float, window: int = 0):
    """One-token decode against a dense cache, in plain PyTorch (the
    reference's dense path; it reaches no kernel there either).

    x: [b, 1, d]; cache_k/v: [b, L, kh, hd]; lengths: [b] current cached
    length (the new token is written at ``lengths``). The caches are
    updated in place (the reference donates them to its jitted step).
    Returns (out [b, 1, d], cache_k, cache_v)."""
    q, k, v = qkv_project(params, cfg, x, lengths[:, None], theta)
    write_token(cache_k, cache_v, k, v, lengths)
    o = decode_attend(cfg, q, cache_k, cache_v, lengths, window=window)
    return out_project(params, o), cache_k, cache_v


def write_token(cache_k, cache_v, k, v, lengths) -> None:
    """The new token's k / v [b, 1, kh, hd] written at position
    ``lengths`` [b] of the dense caches [b, L, kh, hd], in place."""
    bidx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[bidx, lengths] = k[:, 0]
    cache_v[bidx, lengths] = v[:, 0]


def decode_attend(cfg, q, cache_k, cache_v, lengths, *, window: int = 0):
    """One token's attention in plain PyTorch: q [b, 1, h, hd] against the
    dense caches [b, L, kh, hd] (the new token already written at
    ``lengths``; every position up to it visible, within ``window``) ->
    [b, 1, h, hd] in q's dtype (fp32 math). ``h`` and ``kh`` are the
    heads given (all of them, or one coordinate's)."""
    b, L, kh, hd = cache_k.shape
    h = q.shape[2]
    qg = q.reshape(b, kh, h // kh, hd).float() * _scale(cfg)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())
    s = _softcap(s, cfg.attn_softcap)
    k_pos = torch.arange(L, device=q.device)
    mask = k_pos[None, :] <= lengths[:, None]  # causal: includes the new token
    if window and window > 0:
        mask &= (lengths[:, None] - k_pos[None, :]) < window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


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


# ------------------------------------------------------- cross attention
def init_cross_attention(gen, cfg, device, *, layers: int = 0) -> dict:
    return init_attention(gen, cfg, device, layers=layers)


def cross_attention(params: dict, cfg, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, *, enc_valid=None) -> torch.Tensor:
    """Decoder cross attention over the prompt: q from x [b, sq, d] (no
    RoPE), K/V precomputed from the encoder output [b, se, kh, hd]
    (:func:`cross_kv`), every key visible (non-causal; ``enc_valid``: the
    reference's tail mask, see the module docstring)."""
    q = _proj(x, params["wq"])
    return out_project(params, _attend(cfg, q, enc_k, enc_v, causal=False,
                                       kv_valid=enc_valid))


def cross_kv(params: dict, cfg, enc_out: torch.Tensor):
    """Cross-attention K/V [b, se, kh, hd] of the encoder output (no
    RoPE)."""
    return _proj(enc_out, params["wk"]), _proj(enc_out, params["wv"])


# ------------------------------------------------------ tensor parallel
def kv_slice(cfg, q_range: tuple, k_range: tuple) -> slice:
    """The held kv heads ``k_range`` (global [k0, k1)) that serve the q
    heads ``q_range`` under GQA (q head j reads kv head ``j // (h /
    kh)``), as a slice of the held ones; raises where the q heads do not
    read whole, equal groups of them (the flash kernel's own mapping)."""
    g = cfg.n_heads // cfg.n_kv_heads
    (q0, q1), (k0, k1) = q_range, k_range
    lo, hi = q0 // g, (q1 - 1) // g + 1
    n, nk = q1 - q0, hi - lo
    if (lo < k0 or hi > k1 or n % nk
            or any((q0 + j) // g - lo != j // (n // nk) for j in range(n))):
        raise ValueError(f"q heads [{q0}, {q1}) over kv heads [{k0}, {k1}) "
                         f"with {g} q heads a kv head: not a GQA grouping "
                         f"the kernels take")
    return slice(lo - k0, hi - k0)


def attention_tp(P: dict, cfg, h: Shards, positions: Shards, tp, *,
                 theta: float, window: int = 0, causal: bool = True,
                 collect_kv: bool = False, origin: str):
    """Self-attention over placed weights ``P`` (one layer's ``attn``
    tree of ``Placed`` leaves): each coordinate's heads through the flash
    kernel, then ``wo``'s rows summed over the axes that cut its heads.
    ``h`` [b_local, s, d] and ``positions`` are Shards. Returns (out
    Shards, Shards of each coordinate's (k, v) [b_local, s, kh_local, hd]
    or None)."""
    if cfg.attn_seq_shard and not collect_kv:
        out = _seqpar_tp(P, cfg, h, positions, tp, theta=theta,
                         window=window, causal=causal, origin=origin)
        if out is not None:
            return out, None
    outs, kvs = Shards(), Shards()
    for key in tp.keys:
        p = SHD.local_tree(P, key)
        q, k, v = qkv_project(p, cfg, h[key], positions[key], theta)
        sl = kv_slice(cfg, P["wq"].range_of(-2, key),
                      P["wk"].range_of(-2, key))
        outs[key] = _attend(cfg, q, k[:, :, sl], v[:, :, sl], causal=causal,
                            window=window).flatten(-2)
        if collect_kv:
            kvs[key] = (k, v)
    return wo_tp(P["wo"], outs, tp, origin), (kvs if collect_kv else None)


def _model_cut(leaf, dim: int, origin: str) -> bool:
    """Whether 'model' (alone) cuts ``leaf``'s dimension ``dim``."""
    axes = leaf.axes_of(dim)
    if axes and axes != ("model",):
        raise NotImplementedError(f"{origin}: heads cut over {axes}; the "
                                  f"sequence-parallel island takes 'model'")
    return bool(axes)


def _seqpar_tp(P: dict, cfg, h: Shards, positions: Shards, tp, *,
               theta: float, window: int, causal: bool, origin: str):
    """The reference's ``_seqpar_attention`` over placed weights: the query
    sequence cut over 'model' (slice ``m`` of ``s / n_model`` queries at
    'model' coordinate ``m``, every head), K/V whole, the batch as the
    step cuts it. Each coordinate's q / k / v come from its own heads'
    columns; an ``all_to_all`` over 'model' trades q's heads for its
    sequence slice and an ``all_gather`` joins K/V's heads (where 'model'
    cuts them; whole heads are sliced in place), the flash kernel runs the
    slice with ``q_offset = m * s_local`` over the whole K/V, and the
    output goes back to ``wo``'s layout: an ``all_to_all`` to each
    coordinate's heads and ``wo``'s rows summed, or (``wo`` whole) the
    slice projected and the slices joined by an ``all_gather``. None
    where the sequence does not split evenly (the caller then takes the
    path without sequence parallelism, as the reference does)."""
    mesh = tp.mesh
    n = int(mesh.shape.get("model", 1))
    k0 = tp.keys[0]
    sq = h[k0].shape[1]
    if "model" not in mesh.axis_names or sq % n:
        return None
    s_loc = sq // n
    mpos = mesh.axis_names.index("model")
    q, kk, vv = Shards(), Shards(), Shards()
    for key in tp.keys:
        q[key], kk[key], vv[key] = qkv_project(
            SHD.local_tree(P, key), cfg, h[key], positions[key], theta)
    if _model_cut(P["wq"], -2, origin):
        q = tp.all_to_all(q, "model", 1, 2, origin + ".q")
    else:
        q = Shards({k: t[:, k[mpos] * s_loc:(k[mpos] + 1) * s_loc]
                    for k, t in q.items()})
    if _model_cut(P["wk"], -2, origin):
        kk = tp.all_gather(kk, "model", 2, origin + ".k")
        vv = tp.all_gather(vv, "model", 2, origin + ".v")
    o = Shards()
    for key in tp.keys:
        o[key] = flash_attention(
            q[key].transpose(1, 2), kk[key].transpose(1, 2),
            vv[key].transpose(1, 2), scale=_scale(cfg), causal=causal,
            window=window, softcap=cfg.attn_softcap,
            q_offset=key[mpos] * s_loc).transpose(1, 2)
    heads_cut = _model_cut(P["wo"], -3, origin)
    if heads_cut:
        o = tp.all_to_all(o, "model", 2, 1, origin + ".o")
        return wo_tp(P["wo"], Shards({k: t.flatten(-2) for k, t in
                                      o.items()}), tp, origin)
    # wo whole: each coordinate projects its own slice, which is the slice
    # a residual stream cut over 'model' holds (tp.scatter_out)
    a = wo_tp(P["wo"], Shards({k: t.flatten(-2) for k, t in o.items()}),
              tp.with_seq(()), origin)
    return a if tp.scatter_out else tp.all_gather(a, "model", 1,
                                                  origin + ".seq")


def wo_tp(wo, heads: Shards, tp, origin: str) -> Shards:
    """``out_project`` over placed ``wo`` of each coordinate's heads
    ([..., h_local * hd]): its rows' partials summed over the axes that
    cut its heads, rounded once."""
    w = Shards({k: wo[k].reshape(-1, wo[k].shape[-1]) for k in tp.keys})
    dtype = next(iter(heads.values())).dtype
    return tp.rows(heads, w, wo.axes_of(-3), origin + ".wo", dtype)


def cross_kv_tp(P: dict, enc_out: Shards, tp) -> Shards:
    """Each coordinate's cross K/V (its ``wk`` / ``wv`` columns) of the
    encoder output: Shards of (k, v) [b_local, se, kh_local, hd]."""
    return Shards({key: (_proj(enc_out[key], P["wk"][key]),
                         _proj(enc_out[key], P["wv"][key]))
                   for key in tp.keys})


def cross_attention_tp(P: dict, cfg, h: Shards, enc_kv: Shards, tp, *,
                       origin: str, enc_valid=None) -> Shards:
    """Cross attention over placed weights: each coordinate's q heads
    against its kv heads of ``enc_kv`` (:func:`cross_kv_tp`), non-causal,
    then ``wo``'s rows summed. ``enc_valid``: Shards of [b_local] or
    None."""
    outs = Shards()
    for key in tp.keys:
        q = _proj(h[key], P["wq"][key])
        k, v = enc_kv[key]
        sl = kv_slice(cfg, P["wq"].range_of(-2, key),
                      P["wk"].range_of(-2, key))
        outs[key] = _attend(cfg, q, k[:, :, sl], v[:, :, sl], causal=False,
                            kv_valid=None if enc_valid is None
                            else enc_valid[key]).flatten(-2)
    return wo_tp(P["wo"], outs, tp, origin)
