"""Model stack (port of ``repro.models.transformer``): decoders, the
encoder-decoder, Mamba1 stacks and the zamba2 hybrid.

The reference runs a ``lax.scan`` over layer groups with stacked
parameters; here a Python loop walks the same stacked tensors layer by
layer (``params["layers"][...][i]``), so the parameter tree keeps the
reference's layout and names. Layers past the last full scan unit live
in ``tail_<t>`` as in the reference.

Ported: dense decoders with global and sliding-window attention layers,
attention and logit softcaps, sandwich norms (gemma2/3: a norm after
the attention and after the MLP, before each residual add), per-head q/k
norms (gemma3), scaled or tied embeddings; MoE feed-forwards in place of
the MLP (granite-moe, phi3.5-moe: ``layers/moe.py``, the dispatch picked
by ``REPRO_MOE_RAGGED`` as in the reference; the router's aux loss is
summed over the layers and returned by :func:`run_stack`); frontend
embeddings placed before the tokens (internvl2's vision stub,
``batch["frontend"]``); the encoder-decoder (seamless-m4t: a
bidirectional encoder over ``batch["enc_frames"]``, each decoder layer's
cross-attention K/V precomputed from its output, a cross sublayer between
each decoder layer's attention and MLP); attention-free Mamba1 stacks
(falcon-mamba); Mamba2 layers and zamba2's single shared attention+MLP
block, which closes every scan unit (its KV is collected per application
as ``shared_k/v``). A stack that mixes attention and SSM layers (outside
zamba2's shared-block form) or Mamba1 and Mamba2 layers raises
:class:`~repro_torch.models.config.NotPorted`.

Training: :func:`train_loss` (the frontend, the encoder, the MoE aux
term) runs :func:`run_stack` with the reference's remat policies
(``remat="full"``: ``torch.utils.checkpoint`` of each scan unit;
``"dots"``: a selective checkpoint that saves the outputs of ``mm`` /
``addmm``, as ``dots_with_no_batch_dims_saveable`` does) and
:func:`lm_loss`, the cross entropy one ``loss_block`` of the sequence at
a time, each block checkpointed so that the backward holds one block's
fp32 logits. Autograd differentiates it; on the card each attention
layer's gradient is the flash backward kernel. The stacked ``[L, ...]``
leaves are split with one ``torch.unbind`` a leaf a call (one ``stack``
in the backward, where ``[i]`` would make a full-size zero gradient per
layer). Each Mamba2 layer's gradient on the card is the scan's backward
kernel (``kernels/mamba_scan.py``: ``Mamba2Scan``).

Entry points
    init_model(gen, cfg, device)     -> parameter tree
    train_loss(params, cfg, batch, remat="none") -> (loss, metrics)
    prefill(params, cfg, batch)      -> (last-token logits, cache)
    init_cache(cfg, batch, max_len, device, enc_len=0) -> dense decode cache
    decode_step(params, cfg, tokens, cache, lengths, enc_valid=None)
                                     -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import torch
from torch.utils import checkpoint as CK

from repro_torch.models.config import (GLOBAL, LOCAL, MAMBA1, MAMBA2,
                                       ModelConfig, NotPorted)
from repro_torch.models.layers import ssm
from repro_torch.models.layers.attention import (NEG_INF, _proj, _scale,
                                                 _softcap, attention_decode,
                                                 attention_forward,
                                                 attention_prefill,
                                                 cross_attention, cross_kv,
                                                 init_attention,
                                                 init_cross_attention,
                                                 out_project)
from repro_torch.models.layers.mlp import init_mlp, mlp_forward
from repro_torch.models.layers.moe import init_moe, moe_forward
from repro_torch.models.layers.norms import init_rmsnorm, rms_norm
from repro_torch.models.params import dense_init
from repro_torch.parallel import sharding as SHD


SSM_KINDS = (MAMBA1, MAMBA2)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a config this port runs."""
    kinds = set(cfg.layer_pattern)
    unsupported = {
        "attention and SSM layers in one stack": len(
            {k in SSM_KINDS for k in kinds}) > 1,
        "Mamba1 and Mamba2 layers in one stack": {MAMBA1, MAMBA2} <= kinds,
    }
    for what, on in unsupported.items():
        if on:
            raise NotPorted(f"{cfg.name}: {what}")


# ======================================================== pattern utilities
def scan_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(group_size, n_groups, n_tail)."""
    gs = max(cfg.scan_group, 1)
    ng = cfg.n_layers // gs
    return gs, ng, cfg.n_layers - ng * gs


def _unit_pattern(cfg: ModelConfig) -> tuple[str, ...]:
    gs, ng, _ = scan_layout(cfg)
    unit = cfg.layer_pattern[:gs]
    for g in range(ng):
        if cfg.layer_pattern[g * gs:(g + 1) * gs] != unit:
            raise ValueError(f"layer_pattern of {cfg.name} does not tile "
                             f"with scan_group={gs}")
    return unit


def attn_positions(cfg: ModelConfig) -> tuple[int, ...]:
    """Indices (within the unit) of attention layers."""
    return tuple(i for i, k in enumerate(_unit_pattern(cfg))
                 if k in (GLOBAL, LOCAL))


def n_attn_layers(cfg: ModelConfig) -> int:
    """Total attention layers (scan + tail), the shared block excluded."""
    return len(cfg.attn_layer_ids)


def layer_attrs(cfg: ModelConfig, i: int) -> tuple[int, float]:
    """(window, rope theta) of layer ``i``."""
    kind = cfg.layer_pattern[i]
    if kind == LOCAL:
        return cfg.window, cfg.rope_theta
    return 0, global_theta(cfg)


def global_theta(cfg: ModelConfig) -> float:
    """Rope theta of global attention (the shared block's too)."""
    return cfg.rope_theta_global or cfg.rope_theta


def shared_app(cfg: ModelConfig, i: int) -> int:
    """Index of the shared-block application that follows layer ``i``, or
    -1: the reference's shared block closes every scan unit (never a tail
    layer)."""
    gs, ng, _ = scan_layout(cfg)
    if cfg.shared_attn_every > 0 and i < ng * gs and (i + 1) % gs == 0:
        return i // gs
    return -1


def layer_params(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s parameters: a slice of the stacked ``layers`` tree, or
    its ``tail_<t>`` tree."""
    gs, ng, _ = scan_layout(cfg)
    if i < ng * gs:
        return _index_tree(params["layers"], i)
    return params[f"tail_{i - ng * gs}"]


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ============================================================== init model
def init_block(gen, cfg: ModelConfig, kind: str, device, *,
               layers: int = 0, cross: bool = False) -> dict:
    """One layer of ``kind`` (``layers > 0`` stacks that many; ``cross``:
    with the decoder's cross-attention sublayer and its norm)."""
    d, dt = cfg.d_model, cfg.dtype
    if kind in SSM_KINDS:
        init = ssm.init_mamba1 if kind == MAMBA1 else ssm.init_mamba2
        return {"norm1": init_rmsnorm(d, dt, device, layers=layers),
                "mamba": init(gen, cfg, device, layers=layers)}
    p = {
        "norm1": init_rmsnorm(d, dt, device, layers=layers),
        "attn": init_attention(gen, cfg, device, layers=layers),
        "norm2": init_rmsnorm(d, dt, device, layers=layers),
        "mlp": (init_moe if cfg.is_moe else init_mlp)(gen, cfg, device,
                                                      layers=layers),
    }
    if cfg.sandwich_norm:
        p["norm1_post"] = init_rmsnorm(d, dt, device, layers=layers)
        p["norm2_post"] = init_rmsnorm(d, dt, device, layers=layers)
    if cross:
        p["norm_x"] = init_rmsnorm(d, dt, device, layers=layers)
        p["cross"] = init_cross_attention(gen, cfg, device, layers=layers)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Parameter tree with the reference's names and layout, drawn from
    ``gen`` on ``device`` in ``cfg.dtype`` (the SSM leaves in
    ``ssm.FP32_LEAVES`` in fp32, as the reference's)."""
    check_supported(cfg)
    d, dt = cfg.d_model, cfg.dtype
    tree: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.padded_vocab, d), dt, device),
        "final_norm": init_rmsnorm(d, dt, device),
    }
    gs, ng, tail = scan_layout(cfg)
    _unit_pattern(cfg)
    cross = cfg.is_encdec
    if ng > 0:
        tree["layers"] = init_block(gen, cfg, cfg.layer_pattern[0], device,
                                    layers=ng * gs, cross=cross)
    for t in range(tail):
        tree[f"tail_{t}"] = init_block(gen, cfg, cfg.layer_pattern[ng * gs + t],
                                       device, cross=cross)
    if cfg.shared_attn_every > 0:  # zamba2: one shared attention+MLP block
        tree["shared"] = init_block(gen, cfg, GLOBAL, device)
    if cross:   # the encoder: GLOBAL blocks without a cross sublayer
        tree["encoder"] = {
            "layers": init_block(gen, cfg, GLOBAL, device,
                                 layers=cfg.enc_layers),
            "final_norm": init_rmsnorm(d, dt, device)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (d, cfg.padded_vocab), dt, device)
    return tree


# ======================================================= embeddings / logits
def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def assemble_inputs(params: dict, cfg: ModelConfig, batch: dict):
    """tokens (and the frontend's embeddings [b, fl, d] before them, where
    the config has a frontend and the batch carries them) -> hidden [b,
    s_total, d]."""
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend != "none" and "frontend" in batch:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    return x


def _head(params: dict) -> torch.Tensor:
    """The output projection [d, padded_vocab] (the tied embedding's
    transpose where there is no ``lm_head``)."""
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def logits_fn(params: dict, cfg: ModelConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., d] -> fp32 logits [..., padded_vocab] (softcapped,
    padded ids masked). The product runs in fp32, as the reference's."""
    return _head_logits(_head(params).float(), cfg, hidden)


def _head_logits(head32: torch.Tensor, cfg: ModelConfig,
                 hidden: torch.Tensor) -> torch.Tensor:
    logits = hidden.float() @ head32
    logits = _softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(ids < cfg.vocab, logits, NEG_INF)
    return logits


def _block_ce(head32, cfg: ModelConfig, h, y, m):
    """Summed masked cross entropy of one sequence block: h [b, blk, d],
    labels y [b, blk], fp32 mask m [b, blk]."""
    lg = _head_logits(head32, cfg, h)
    lse = torch.logsumexp(lg, dim=-1)
    # the label's logit where 0 <= y < padded_vocab and 0 elsewhere, as
    # the reference's masked sum gives (a masked label may be -1 or -100)
    y = y.long()
    ok = (y >= 0) & (y < lg.shape[-1])
    ll = lg.gather(-1, torch.where(ok, y, 0)[..., None])[..., 0]
    return ((lse - torch.where(ok, ll, 0.0)) * m).sum()


def lm_loss(params: dict, cfg: ModelConfig, hidden, labels, loss_mask):
    """Chunked-vocab cross entropy: logits made one ``loss_block`` of the
    sequence at a time ([b, blk, padded_vocab] fp32), never the full [b,
    s, V]. With autograd on, each block runs under
    ``torch.utils.checkpoint``: its backward recomputes its logits, so one
    block's are held at a time. The head is cast to fp32 once a call."""
    b, s, _ = hidden.shape
    blk = min(cfg.loss_block, s)
    while s % blk:
        blk //= 2
    mask = loss_mask.float()
    head32 = _head(params).float()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // blk):
        sl = slice(i * blk, (i + 1) * blk)
        args = (head32, cfg, hidden[:, sl], labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            tot = tot + CK.checkpoint(_block_ce, *args, use_reentrant=False)
        else:
            tot = tot + _block_ce(*args)
    return tot / torch.clamp(mask.sum(), min=1.0)


# ========================================================== stack (forward)
def _mlp_or_moe(p: dict, cfg: ModelConfig, h):
    """A block's feed-forward: (out, aux), aux the MoE router's loss (a
    plain 0.0 for an MLP). ``REPRO_MOE_RAGGED=1`` picks the ragged
    dispatch; it is read at every call, as the reference reads it at
    every trace (in the decode graph: at its capture)."""
    if cfg.is_moe:
        ragged = os.environ.get("REPRO_MOE_RAGGED") == "1"
        return moe_forward(p["mlp"], cfg, h, ragged=ragged)
    return mlp_forward(p["mlp"], cfg, h), 0.0


def attn_block_fwd(p: dict, cfg: ModelConfig, x, positions, *, window: int,
                   theta: float, causal: bool = True, collect_kv: bool = True,
                   enc_kv=None, enc_valid=None):
    """One attention + feed-forward block over the sequence (causal, with
    its KV when ``collect_kv``; else causal or not, without), with the
    cross sublayer over ``enc_kv`` ((k, v) [b, se, kh, hd]) between the
    two. Returns (x, aux, (k, v) or None)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if collect_kv:
        a, kv = attention_prefill(p["attn"], cfg, h, positions, theta=theta,
                                  window=window)
    else:
        a, kv = attention_forward(p["attn"], cfg, h, positions, theta=theta,
                                  window=window, causal=causal), None
    x = x + post_norm(p, cfg, "norm1_post", a)
    if enc_kv is not None:
        h = rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + cross_attention(p["cross"], cfg, h, *enc_kv,
                                enc_valid=enc_valid)
    x, aux = mlp_sublayer(p, cfg, x)
    return x, aux, kv


def post_norm(p: dict, cfg: ModelConfig, name: str, y):
    """The sandwich norm ``name`` of ``y`` (gemma2/3), else ``y``."""
    return rms_norm(y, p[name], cfg.norm_eps) if cfg.sandwich_norm else y


def mlp_sublayer(p: dict, cfg: ModelConfig, x):
    """x + post-norm(FFN(norm2(x))), the FFN an MLP or an MoE. Returns
    (x, aux)."""
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    m, aux = _mlp_or_moe(p, cfg, h)
    return x + post_norm(p, cfg, "norm2_post", m), aux


def cross_sublayer(p: dict, cfg: ModelConfig, x1, enc_k, enc_v,
                   enc_valid=None):
    """One token's cross sublayer: x1 + cross attention of norm_x(x1)
    over enc_k / enc_v [b, se, kh, hd] (:func:`_cross_decode`)."""
    h = rms_norm(x1, p["norm_x"], cfg.norm_eps)
    return x1 + _cross_decode(p["cross"], cfg, h, enc_k, enc_v,
                              enc_valid=enc_valid)


def _cross_decode(p: dict, cfg: ModelConfig, x1, enc_k, enc_v, *,
                  enc_valid=None):
    """Single-token cross attention in plain PyTorch (the reference's is
    plain jnp). x1 [b, 1, d]; enc_k/v [b, se, kh, hd]; ``enc_valid`` [b]:
    only each sequence's first ``enc_valid`` encoder positions count."""
    b = x1.shape[0]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = _proj(x1, p["wq"]).reshape(b, kh, h // kh, hd).float() * _scale(cfg)
    s = _softcap(torch.einsum("bkgd,bskd->bkgs", qg, enc_k.float()),
                 cfg.attn_softcap)
    if enc_valid is not None:
        k_pos = torch.arange(enc_k.shape[1], device=x1.device)
        s = torch.where((k_pos[None, :] < enc_valid[:, None])[:, None, None],
                        s, NEG_INF)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1),
                     enc_v.float())
    return out_project(p, o.reshape(b, 1, h, hd).to(x1.dtype))


def mamba_block_fwd(p: dict, cfg: ModelConfig, kind: str, x, state=None):
    """One SSM block of ``kind`` over the prompt. Returns (x,
    new_state)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    fwd = ssm.mamba1_forward if kind == MAMBA1 else ssm.mamba2_forward
    y, st = fwd(p["mamba"], cfg, h, state)
    return x + y, st


def _unbind_tree(tree: dict, n: int) -> list[dict]:
    """The ``n`` per-layer slices of a stacked ``[n, ...]`` tree, one
    ``torch.unbind`` a leaf."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind_tree(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the products without batch dims (``mm``, ``addmm``), recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CK.CheckpointPolicy.MUST_SAVE
    return CK.CheckpointPolicy.PREFER_RECOMPUTE


REMATS = ("none", "dots", "full")


def _remat(fn, remat: str, *args):
    """``fn(*args)`` under the remat policy (plain where autograd is
    off). The recompute runs under the axis rules and mesh of the forward
    (``parallel.sharding.axis_rules``, thread-local): a CUDA backward runs
    on autograd's own thread, where none are installed."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    rules, mesh = SHD.current_rules(), SHD.current_mesh()

    def under_rules(*a):
        with SHD.axis_rules(rules, mesh):
            return fn(*a)
    if remat == "full":
        return CK.checkpoint(under_rules, *args, use_reentrant=False)
    return CK.checkpoint(under_rules, *args, use_reentrant=False,
                         context_fn=functools.partial(
                             CK.create_selective_checkpoint_contexts,
                             _dots_policy))


def run_stack(params: dict, cfg: ModelConfig, x, positions, *,
              collect: bool = False, enc_kv=None, enc_valid=None,
              causal: bool = True, remat: str = "none"):
    """Decoder (or encoder: ``causal=False``) stack. Returns (hidden, aux,
    collected): aux the MoE router losses summed over the layers;
    ``collect=True`` gathers the prefill cache: every attention layer's KV
    as ``{"k", "v": [La, b, s, kh, hd]}``, every SSM layer's final state
    as ``{"ssm": {name: [n_ssm, b, ...]}}`` and each application of the
    shared block's KV as ``{"shared_k", "shared_v": [n_groups, b, s, kh,
    hd]}``. ``enc_kv``: the cross K/V (k, v) stacked [L, b, se, kh,
    hd]. ``remat`` ("none", "dots", "full") wraps each scan unit (its
    layers and the shared block that closes it; not the tail layers, as
    in the reference) for training."""
    check_supported(cfg)
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, not {remat!r}")
    if collect and remat != "none":
        raise ValueError("collect (prefill) runs without remat")
    gs, ng, _ = scan_layout(cfg)
    stacked = _unbind_tree(params["layers"], ng * gs) if ng else []
    kv: dict[str, list] = {"k": [], "v": [], "shared_k": [], "shared_v": []}
    states = []

    def layer(i, x):
        """Layer ``i`` (and the shared block after it): (x, aux)."""
        p = stacked[i] if i < ng * gs else params[f"tail_{i - ng * gs}"]
        kind = cfg.layer_pattern[i]
        aux = 0.0
        if kind in SSM_KINDS:
            x, st = mamba_block_fwd(p, cfg, kind, x)
            if collect:
                states.append(st)
        else:
            window, theta = layer_attrs(cfg, i)
            ek = None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i])
            x, aux, kvi = attn_block_fwd(p, cfg, x, positions, window=window,
                                         theta=theta, causal=causal,
                                         collect_kv=collect, enc_kv=ek,
                                         enc_valid=enc_valid)
            if collect:
                kv["k"].append(kvi[0])
                kv["v"].append(kvi[1])
        if shared_app(cfg, i) >= 0:
            x, a, kvi = attn_block_fwd(params["shared"], cfg, x, positions,
                                       window=0, theta=global_theta(cfg),
                                       causal=causal, collect_kv=collect)
            aux = aux + a
            if collect:
                kv["shared_k"].append(kvi[0])
                kv["shared_v"].append(kvi[1])
        return x, aux

    def unit(u, x):
        aux = 0.0
        for i in range(u * gs, (u + 1) * gs):
            x, a = layer(i, x)
            aux = aux + a
        return x, aux

    aux = 0.0
    for u in range(ng):
        x, a = _remat(functools.partial(unit, u), remat, x)
        aux = aux + a
    for i in range(ng * gs, cfg.n_layers):
        x, a = layer(i, x)
        aux = aux + a
    if not collect:
        return x, aux, {}
    collected = {n: torch.stack(t) for n, t in kv.items() if t}
    if states:
        collected["ssm"] = {n: torch.stack([st[n] for st in states])
                            for n in states[0]}
    return x, aux, collected


# ============================================================ encoder side
def run_encoder(params: dict, cfg: ModelConfig, frames):
    """The bidirectional encoder over precomputed frame embeddings [b, se,
    d] (cast to the model's dtype): :func:`run_stack` with a GLOBAL-only
    view of the config, non-causal, then its final norm. Returns the
    encoder output [b, se, d]."""
    enc = params["encoder"]
    b, se, _ = frames.shape
    positions = torch.arange(se, device=frames.device)[None].expand(b, se)
    enc_cfg = dataclasses.replace(
        cfg, n_layers=cfg.enc_layers, layer_pattern=(GLOBAL,) * cfg.enc_layers,
        scan_group=1, shared_attn_every=0, enc_layers=0, n_experts=0,
        top_k=0)
    x, _, _ = run_stack({"layers": enc["layers"]}, enc_cfg,
                        frames.to(cfg.dtype), positions, causal=False)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def encoder_cross_kv(params: dict, cfg: ModelConfig, enc_out):
    """Each decoder layer's cross K/V of the encoder output: (k, v)
    stacked [L_dec, b, se, kh, hd], the fragment the serving engine keeps
    per request."""
    gs, ng, _ = scan_layout(cfg)
    cross = ((_unbind_tree(params["layers"]["cross"], ng * gs) if ng else [])
             + [params[f"tail_{t}"]["cross"]
                for t in range(cfg.n_layers - ng * gs)])
    ks, vs = zip(*(cross_kv(p, cfg, enc_out) for p in cross))
    return torch.stack(ks), torch.stack(vs)


# ============================================================== public API
def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               remat: str = "none"):
    """batch: tokens [b, st], labels [b, s_total], loss_mask [b, s_total]
    (+ frontend [b, fl, d] | enc_frames [b, se, d]) as tensors on the
    parameters' device. Returns (loss, {"ce", "aux"}): the masked cross
    entropy plus, for an MoE, ``router_aux_coef`` times the router loss
    averaged over the layers."""
    x = assemble_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_kv = None
    if cfg.is_encdec:
        enc_kv = encoder_cross_kv(params, cfg,
                                  run_encoder(params, cfg,
                                              batch["enc_frames"]))
    x, aux, _ = run_stack(params, cfg, x, positions, enc_kv=enc_kv,
                          remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    ce = lm_loss(params, cfg, x, batch["labels"], batch["loss_mask"])
    loss = ce
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux}


def prefill(params: dict, cfg: ModelConfig, batch: dict):
    """Run the full prompt (frontend embeddings first where given; the
    encoder over ``batch["enc_frames"]`` for an encoder-decoder); returns
    (last-token logits [b, V], cache) with the cache of :func:`run_stack`
    plus ``enc_k`` / ``enc_v`` [L, b, se, kh, hd] for an encoder-decoder.
    The serving engine re-blocks the KV into the paged arenas and copies
    the SSM states and the cross K/V into its slots."""
    x = assemble_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_kv = None
    if cfg.is_encdec:
        enc_kv = encoder_cross_kv(params, cfg,
                                  run_encoder(params, cfg,
                                              batch["enc_frames"]))
    x, _, cache = run_stack(params, cfg, x, positions, collect=True,
                            enc_kv=enc_kv)
    if enc_kv is not None:
        cache["enc_k"], cache["enc_v"] = enc_kv
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x[:, -1]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, *,
               enc_len: int = 0) -> dict:
    """Dense decode cache (the paged layout lives in ``serving/``): the
    attention layers' and the shared block's KV, the SSM states, and for
    an encoder-decoder with ``enc_len > 0`` the cross K/V ``enc_k`` /
    ``enc_v`` [L, batch, enc_len, kh, hd]."""
    check_supported(cfg)
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    cache: dict[str, Any] = {}

    def kv(n, length=max_len):
        return torch.zeros((n, batch, length, kh, hd), dtype=cfg.dtype,
                           device=device)
    la = n_attn_layers(cfg)
    if la:
        cache["k"], cache["v"] = kv(la), kv(la)
    if cfg.shared_attn_every > 0:
        na = cfg.n_shared_applications()
        cache["shared_k"], cache["shared_v"] = kv(na), kv(na)
    if cfg.ssm_layer_ids:
        one = ssm_init_state(cfg, batch, device)
        n = len(cfg.ssm_layer_ids)
        cache["ssm"] = {k: a.new_zeros((n,) + a.shape) for k, a in one.items()}
    if cfg.is_encdec and enc_len > 0:
        cache["enc_k"] = kv(cfg.n_layers, enc_len)
        cache["enc_v"] = kv(cfg.n_layers, enc_len)
    return cache


def ssm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    """One SSM layer's zeroed decode state for ``batch`` sequences, of the
    stack's SSM kind (Mamba1: ``h``, ``conv``; Mamba2: ``h``, ``conv_x``,
    ``conv_bc``)."""
    if MAMBA1 in cfg.layer_pattern:
        return ssm.mamba1_init_state(cfg, batch, device)
    return ssm.mamba2_init_state(cfg, batch, device)


def attn_block_decode(p: dict, cfg: ModelConfig, x1, cache_k, cache_v,
                      lengths, *, window: int, theta: float,
                      cross_kv_pair=None, enc_valid=None):
    """One-token decode through an attention block (dense cache, updated
    in place; ``cross_kv_pair``: the layer's (enc_k, enc_v) for the cross
    sublayer). Returns x1."""
    h = rms_norm(x1, p["norm1"], cfg.norm_eps)
    a, _, _ = attention_decode(p["attn"], cfg, h, cache_k, cache_v, lengths,
                               theta=theta, window=window)
    x1 = x1 + post_norm(p, cfg, "norm1_post", a)
    if cross_kv_pair is not None:
        x1 = cross_sublayer(p, cfg, x1, *cross_kv_pair, enc_valid)
    return mlp_sublayer(p, cfg, x1)[0]


def mamba_block_decode(p: dict, cfg: ModelConfig, kind: str, x1,
                       state: dict):
    """One-token decode through an SSM block of ``kind``. ``state`` (one
    layer's tensors, e.g. views into a stacked cache) is updated in
    place. Returns (x1, state)."""
    h = rms_norm(x1, p["norm1"], cfg.norm_eps)
    step = ssm.mamba1_decode if kind == MAMBA1 else ssm.mamba2_decode
    y, new = step(p["mamba"], cfg, h, state)
    for name, t in new.items():
        state[name].copy_(t)
    return x1 + y, state


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, lengths: torch.Tensor, *, enc_valid=None):
    """One decode token for the whole batch (dense-cache reference path;
    it reaches no kernel).

    tokens: [b] int; lengths: [b] tokens already in cache; ``enc_valid``
    [b]: valid encoder positions of each sequence (None: all of
    ``enc_k``). Returns (logits [b, V], cache); the cache's tensors are
    written in place."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])
    lengths = lengths.long()
    ai = si = 0
    for i in range(cfg.n_layers):
        p = layer_params(params, cfg, i)
        kind = cfg.layer_pattern[i]
        if kind in SSM_KINDS:
            x, _ = mamba_block_decode(
                p, cfg, kind, x, {n: t[si] for n, t in cache["ssm"].items()})
            si += 1
        else:
            window, theta = layer_attrs(cfg, i)
            cross = ((cache["enc_k"][i], cache["enc_v"][i])
                     if "enc_k" in cache else None)
            x = attn_block_decode(p, cfg, x, cache["k"][ai], cache["v"][ai],
                                  lengths, window=window, theta=theta,
                                  cross_kv_pair=cross, enc_valid=enc_valid)
            ai += 1
        g = shared_app(cfg, i)
        if g >= 0:
            x = attn_block_decode(params["shared"], cfg, x,
                                  cache["shared_k"][g], cache["shared_v"][g],
                                  lengths, window=0, theta=global_theta(cfg))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), cache
