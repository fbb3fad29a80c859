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

Over a mesh: :func:`train_loss` and :func:`prefill` take a parameter
tree placed by ``parallel/sharding.place_params`` (``TRAIN_PARAM_RULES``
or ``SERVE_PARAM_RULES``) and run it coordinate by coordinate
(``parallel/sharding.TP``): the batch cut over ('pod', 'data') where it
divides them, each layer's weights cut over 'model' as their specs say
(``layers/attention.py``, ``mlp.py``, ``moe.py``, ``ssm.py``: each
coordinate's heads, columns, experts and SSM shards, the rows' partials
summed by ``psum``), a weight cut over 'data' (FSDP) gathered before its
use (its gradient a ``reduce-scatter``). The vocabulary-sharded embedding
is the reference's manual lookup (clamp, mask, ``psum``); the logits are
made on vocabulary shards, their padded ids masked by global id, and
``all_gather``-ed; :func:`lm_loss` over shards is a vocabulary-parallel
cross entropy (``pmax`` of the rows' max, ``psum`` of the exp-sums, the
label's logit from the shard that owns it with a ``psum``). The
sequence-parallel lever (``cfg.attn_seq_shard``: the query sequence cut
over 'model', ``layers/attention._seqpar_tp``) and the ragged MoE dispatch
(``REPRO_MOE_RAGGED=1``: ``layers/moe.moe_ragged_tp``) run over placed
weights too; :func:`decode_step` (the dense-cache reference path) takes
none.

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
                                                 attention_tp,
                                                 cross_attention,
                                                 cross_attention_tp,
                                                 cross_kv, cross_kv_tp,
                                                 init_attention,
                                                 init_cross_attention,
                                                 out_project)
from repro_torch.models.layers.mlp import init_mlp, mlp_forward, mlp_tp
from repro_torch.models.layers.moe import (init_moe, moe_forward,
                                           moe_ragged_tp, moe_tp)
from repro_torch.models.layers.norms import init_rmsnorm, rms_norm
from repro_torch.models.params import dense_init
from repro_torch.parallel import sharding as SHD
from repro_torch.parallel.collectives import Shards, pmax


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
    return out_project(p, _cross_decode_heads(p["wq"], cfg, x1, enc_k,
                                              enc_v, enc_valid))


def _cross_decode_heads(wq, cfg: ModelConfig, x1, enc_k, enc_v, enc_valid):
    """The attention of :func:`_cross_decode` before ``wo``, for the q
    heads of ``wq`` over the kv heads of ``enc_k`` / ``enc_v`` (all of
    them, or one coordinate's): [b, 1, h, hd] in x1's dtype."""
    b = x1.shape[0]
    q = _proj(x1, wq)
    h, kh, hd = q.shape[2], enc_k.shape[2], cfg.head_dim
    qg = q.reshape(b, kh, h // kh, hd).float() * _scale(cfg)
    s = _softcap(torch.einsum("bkgd,bskd->bkgs", qg, enc_k.float()),
                 cfg.attn_softcap)
    if enc_valid is not None:
        k_pos = torch.arange(enc_k.shape[1], device=x1.device)
        s = torch.where((k_pos[None, :] < enc_valid[:, None])[:, None, None],
                        s, NEG_INF)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1),
                     enc_v.float())
    return o.reshape(b, 1, h, hd).to(x1.dtype)


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
    enc_cfg = _encoder_cfg(cfg)
    x, _, _ = run_stack({"layers": enc["layers"]}, enc_cfg,
                        frames.to(cfg.dtype), positions, causal=False)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's view of the config: GLOBAL layers, one a unit."""
    return dataclasses.replace(
        cfg, n_layers=cfg.enc_layers, layer_pattern=(GLOBAL,) * cfg.enc_layers,
        scan_group=1, shared_attn_every=0, enc_layers=0, n_experts=0,
        top_k=0)


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
               remat: str = "none", unroll: bool = False):
    """batch: tokens [b, st], labels [b, s_total], loss_mask [b, s_total]
    (+ frontend [b, fl, d] | enc_frames [b, se, d]) as tensors on the
    parameters' device. Returns (loss, {"ce", "aux"}): the masked cross
    entropy plus, for an MoE, ``router_aux_coef`` times the router loss
    averaged over the layers. Over placed parameters (module docstring)
    the batch lies on the mesh's home entry and the loss comes back
    there. ``unroll`` is the reference's analysis switch; the port's
    loops are always unrolled, so it changes nothing."""
    del unroll
    if SHD.is_placed(params):
        return train_loss_tp(params, cfg, batch, remat=remat)
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


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            unroll: bool = False):
    """Run the full prompt (frontend embeddings first where given; the
    encoder over ``batch["enc_frames"]`` for an encoder-decoder); returns
    (last-token logits [b, V], cache) with the cache of :func:`run_stack`
    plus ``enc_k`` / ``enc_v`` [L, b, se, kh, hd] for an encoder-decoder.
    The serving engine re-blocks the KV into the paged arenas and copies
    the SSM states and the cross K/V into its slots. Over placed
    parameters the batch lies on the mesh's home entry, the logits come
    back there and every cache leaf is a Shards of each coordinate's
    slots and heads (:func:`prefill_tp`). ``unroll`` changes nothing (as
    in :func:`train_loss`)."""
    del unroll
    if SHD.is_placed(params):
        return prefill_tp(params, cfg, batch)
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
    written in place. Over placed parameters (``SERVE_PARAM_RULES``) the
    cache is the placed one of :func:`place_cache` and the step runs at
    every coordinate (:func:`decode_step_tp`)."""
    if SHD.is_placed(params):
        return decode_step_tp(params, cfg, tokens, cache, lengths,
                              enc_valid=enc_valid)
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


# ========================================================= over a mesh (TP)
def _add(a: Shards, b: Shards) -> Shards:
    return Shards({k: a[k] + b[k] for k in a})


def _sum_aux(a, b):
    """Two aux losses, each a Shards or None."""
    if a is None or b is None:
        return b if a is None else a
    return _add(a, b)


def norm_tp(P: dict, cfg: ModelConfig, x: Shards, tp) -> Shards:
    """:func:`rms_norm` at every coordinate with its copy of the scale."""
    return tp.map(lambda t, sc: rms_norm(t, {"scale": sc}, cfg.norm_eps), x,
                  P["scale"])


def _post_norm_tp(P: dict, cfg: ModelConfig, name: str, y: Shards, tp):
    return norm_tp(P[name], cfg, y, tp) if cfg.sandwich_norm else y


def mlp_sublayer_tp(P: dict, cfg: ModelConfig, x: Shards, tp, origin: str):
    """:func:`mlp_sublayer` over placed weights: (x, aux Shards or
    None). With ``tp.seq_axes`` ``x`` is each coordinate's sequence slice:
    the normed slices are gathered, and the FFN's output is
    reduce-scattered back (``tp.out_scattered``)."""
    h = tp.gather_seq(norm_tp(P["norm2"], cfg, x, tp),
                      origin + ".mlp.seq_in")
    to = tp.out_scattered()
    if cfg.is_moe:
        fwd = (moe_ragged_tp if os.environ.get("REPRO_MOE_RAGGED") == "1"
               else moe_tp)
        m, aux = fwd(P["mlp"], cfg, h, to, origin=origin + ".mlp")
    else:
        m, aux = mlp_tp(P["mlp"], cfg, h, to, origin=origin + ".mlp"), None
    return _add(x, _post_norm_tp(P, cfg, "norm2_post", m, tp)), aux


def attn_block_tp(P: dict, cfg: ModelConfig, x: Shards, positions: Shards,
                  tp, *, window: int, theta: float, causal: bool = True,
                  collect_kv: bool = False, enc_kv=None, enc_valid=None,
                  origin: str):
    """:func:`attn_block_fwd` over one layer's placed weights (gathered
    over the batch axes first where FSDP cut them). Returns (x, aux, kv
    Shards or None). With ``tp.seq_axes`` ``x`` is each coordinate's
    sequence slice and ``positions`` the whole sequence's (each sublayer's
    normed input gathered, its output reduce-scattered)."""
    P = tp.use_tree(P, origin)
    h = tp.gather_seq(norm_tp(P["norm1"], cfg, x, tp),
                      origin + ".attn.seq_in")
    a, kv = attention_tp(P["attn"], cfg, h, positions, tp.out_scattered(),
                         theta=theta, window=window, causal=causal,
                         collect_kv=collect_kv, origin=origin + ".attn")
    x = _add(x, _post_norm_tp(P, cfg, "norm1_post", a, tp))
    if enc_kv is not None:
        h = tp.gather_seq(norm_tp(P["norm_x"], cfg, x, tp),
                          origin + ".cross.seq_in")
        x = _add(x, cross_attention_tp(P["cross"], cfg, h, enc_kv,
                                       tp.out_scattered(),
                                       origin=origin + ".cross",
                                       enc_valid=enc_valid))
    x, aux = mlp_sublayer_tp(P, cfg, x, tp, origin)
    return x, aux, kv


def mamba_block_tp(P: dict, cfg: ModelConfig, kind: str, x: Shards, tp, *,
                   origin: str):
    """:func:`mamba_block_fwd` over placed weights from zero states:
    (x, Shards of the final states)."""
    P = tp.use_tree(P, origin)
    h = tp.gather_seq(norm_tp(P["norm1"], cfg, x, tp),
                      origin + ".mamba.seq_in")
    fwd = ssm.mamba1_forward_tp if kind == MAMBA1 else ssm.mamba2_forward_tp
    y, st = fwd(P["mamba"], cfg, h, tp.out_scattered(),
                origin=origin + ".mamba")
    return _add(x, y), st


def unbind_placed(tree: dict) -> list:
    """The per-layer views of a placed stacked ``[L, ...]`` tree (one
    ``unbind`` a leaf a coordinate)."""
    leaves = {k: (unbind_placed(v) if isinstance(v, dict)
                  and not isinstance(v, Shards) else v.unbind())
              for k, v in tree.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def layer_params_tp(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s placed weights (views of the stacked tree or its
    ``tail_<t>``)."""
    gs, ng, _ = scan_layout(cfg)
    if i < ng * gs:
        return _layer_tree(params["layers"], i)
    return params[f"tail_{i - ng * gs}"]


def _layer_tree(tree: dict, i: int) -> dict:
    return {k: v.layer(i) if isinstance(v, Shards) else _layer_tree(v, i)
            for k, v in tree.items()}


def layer_name(cfg: ModelConfig, i: int, prefix: str = "") -> str:
    gs, ng, _ = scan_layout(cfg)
    return (f"{prefix}layers.{i}" if i < ng * gs
            else f"{prefix}tail_{i - ng * gs}")


def run_stack_tp(params: dict, cfg: ModelConfig, x: Shards,
                 positions: Shards, tp, *, collect: bool = False,
                 enc_kv=None, enc_valid=None, causal: bool = True,
                 remat: str = "none", prefix: str = ""):
    """:func:`run_stack` over placed weights; ``x`` / ``positions`` are
    Shards of each coordinate's slots; ``enc_kv`` a list of each decoder
    layer's cross K/V Shards. Returns (hidden Shards, aux Shards or None,
    collected: each cache leaf a Shards of the coordinate's stacked
    [n, b_local, ...] tensors)."""
    check_supported(cfg)
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, not {remat!r}")
    gs, ng, _ = scan_layout(cfg)
    stacked = unbind_placed(params["layers"]) if ng else []
    kv: dict[str, list] = {"k": [], "v": [], "shared_k": [], "shared_v": []}
    states = []

    def keep(name, kvi):
        kv["k" if name == "self" else "shared_k"].append(
            Shards({k: t[0] for k, t in kvi.items()}))
        kv["v" if name == "self" else "shared_v"].append(
            Shards({k: t[1] for k, t in kvi.items()}))

    def layer(i, x):
        p = stacked[i] if i < ng * gs else params[f"tail_{i - ng * gs}"]
        name = layer_name(cfg, i, prefix)
        kind = cfg.layer_pattern[i]
        aux = None
        if kind in SSM_KINDS:
            x, st = mamba_block_tp(p, cfg, kind, x, tp, origin=name)
            if collect:
                states.append(st)
        else:
            window, theta = layer_attrs(cfg, i)
            x, aux, kvi = attn_block_tp(
                p, cfg, x, positions, tp, window=window, theta=theta,
                causal=causal, collect_kv=collect,
                enc_kv=None if enc_kv is None else enc_kv[i],
                enc_valid=enc_valid, origin=name)
            if collect:
                keep("self", kvi)
        if shared_app(cfg, i) >= 0:
            x, a, kvi = attn_block_tp(
                params["shared"], cfg, x, positions, tp, window=0,
                theta=global_theta(cfg), causal=causal, collect_kv=collect,
                origin=f"{prefix}shared.{shared_app(cfg, i)}")
            aux = _sum_aux(aux, a)
            if collect:
                keep("shared", kvi)
        return x, aux

    def unit(u, x):
        aux = None
        for i in range(u * gs, (u + 1) * gs):
            x, a = layer(i, x)
            aux = _sum_aux(aux, a)
        return x, aux

    aux = None
    for u in range(ng):
        x, a = _remat(functools.partial(unit, u), remat, x)
        aux = _sum_aux(aux, a)
    for i in range(ng * gs, cfg.n_layers):
        x, a = layer(i, x)
        aux = _sum_aux(aux, a)
    collected = {}
    if collect:
        collected = {n: Shards({k: torch.stack([s[k] for s in t])
                                for k in tp.keys})
                     for n, t in kv.items() if t}
        if states:
            collected["ssm"] = {n: Shards({k: torch.stack(
                [st[k][n] for st in states]) for k in tp.keys})
                for n in states[0][tp.keys[0]]}
    return x, aux, collected


def embed_tokens_tp(params: dict, cfg: ModelConfig, tokens: Shards, tp,
                    origin: str = "embed") -> Shards:
    """The token lookup over a placed table: where 'model' cuts the
    vocabulary, the reference's manual lookup (each coordinate's rows of
    its own ids, clamped and masked, cast to fp32 after the take, an fp32
    ``psum``; with ``tp.seq_axes`` a ``reduce-scatter`` along the sequence,
    each coordinate keeping its slice), else a plain lookup of the whole
    copy (sliced in place under ``tp.seq_axes``). As in the
    reference, the rows are taken from the table in its own dtype, so the
    lookup's gradient (a scatter-add of one row a token) sums in that
    dtype at each coordinate, over the coordinate's batch slice."""
    emb = tp.use(params["embed"], origin)
    vax = emb.axes_of(0)
    to = tp.out_scattered()   # with tp.seq_axes: each coordinate's slice
    if not vax:
        x = to.sum_out(tp.map(lambda e, t: e[t.long()], emb, tokens), (),
                       origin + ".lookup")
    else:
        parts = Shards()
        for k in tp.keys:
            lo, hi = emb.range_of(0, k)
            t = tokens[k].long()
            out = emb[k][torch.clamp(t - lo, 0, hi - lo - 1)].float()
            parts[k] = torch.where(((t >= lo) & (t < hi))[..., None], out,
                                   0.0)
        x = tp.map(lambda t: t.to(emb.dtype),
                   to.sum_out(parts, vax, origin + ".lookup"))
    if cfg.scale_embeddings:
        x = tp.map(lambda t: t * torch.full((), cfg.d_model ** 0.5,
                                            dtype=t.dtype, device=t.device),
                   x)
    return x


def _assemble_tp(params: dict, cfg: ModelConfig, batch: dict, tp) -> Shards:
    """The inputs' hidden states (each coordinate's sequence slice under
    ``tp.seq_axes``: the frontend's embeddings come first, so there the
    whole sequence is assembled and then sliced)."""
    if cfg.frontend != "none" and "frontend" in batch:
        x = embed_tokens_tp(params, cfg, batch["tokens"], tp.with_seq(()))
        x = tp.map(lambda f, t: torch.cat([f.to(t.dtype), t], dim=1),
                   batch["frontend"], x)
        return tp.seq_slice(x)
    return embed_tokens_tp(params, cfg, batch["tokens"], tp)


def _heads_tp(params: dict, tp):
    """Each coordinate's output head: (fp32 [d, v_local], its vocabulary
    range), and the mesh axes that cut the vocabulary."""
    if "lm_head" in params:
        head = tp.use(params["lm_head"], "lm_head")
        return ({k: (head[k].float(), head.range_of(1, k)) for k in tp.keys},
                head.axes_of(1))
    emb = tp.use(params["embed"], "embed")
    return ({k: (emb[k].T.float(), emb.range_of(0, k)) for k in tp.keys},
            emb.axes_of(0))


def _local_logits(head32, vrange, cfg: ModelConfig, hidden):
    """:func:`_head_logits` on one vocabulary slice: the padded ids
    masked by their global id."""
    logits = _softcap(hidden.float() @ head32, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(*vrange, device=logits.device)
        logits = torch.where(ids < cfg.vocab, logits, NEG_INF)
    return logits


def logits_tp(params: dict, cfg: ModelConfig, hidden: Shards, tp,
              origin: str = "logits") -> Shards:
    """:func:`logits_fn` over placed weights: each coordinate's vocabulary
    slice, then an ``all_gather`` of the slices (every coordinate holds
    its slots' whole fp32 logits)."""
    heads, vax = _heads_tp(params, tp)
    parts = Shards({k: _local_logits(*heads[k], cfg, hidden[k])
                    for k in tp.keys})
    return tp.all_gather(parts, vax, -1, origin)


def lm_loss_tp(params: dict, cfg: ModelConfig, hidden: Shards,
               labels: Shards, loss_mask: Shards, tp):
    """:func:`lm_loss` as a vocabulary-parallel cross entropy: a block's
    logits at each coordinate are its vocabulary slice; ``pmax`` of the
    rows' max and ``psum`` of the exp-sums give the log-sum-exp, the
    label's logit comes from the slice that holds it (a ``psum``), and a
    label outside ``[0, padded_vocab)`` counts 0 (:func:`_block_ce`'s
    rule). The masked sums are summed over the batch axes. Returns the
    loss on the first coordinate's device."""
    heads, vax = _heads_tp(params, tp)
    k0 = tp.keys[0]
    s = hidden[k0].shape[1]
    blk = min(cfg.loss_block, s)
    while s % blk:
        blk //= 2
    masks = tp.map(lambda m: m.float(), loss_mask)

    def block(sl, hidden):
        lg = {k: _local_logits(*heads[k], cfg, hidden[k][:, sl])
              for k in tp.keys}
        mx = pmax(Shards({k: t.max(dim=-1).values for k, t in lg.items()}),
                  tp.mesh, vax, "lm_loss.max")
        se = tp.psum(Shards({k: torch.exp(lg[k] - mx[k][..., None]).sum(
            dim=-1) for k in tp.keys}), vax, "lm_loss.sumexp")
        ll = Shards()
        for k in tp.keys:
            v0, v1 = heads[k][1]
            y = labels[k][:, sl].long()
            own = (y >= v0) & (y < v1)
            got = lg[k].gather(-1, torch.clamp(y - v0, 0, v1 - v0 - 1)[
                ..., None])[..., 0]
            ll[k] = torch.where(own, got, 0.0)
        ll = tp.psum(ll, vax, "lm_loss.label")
        out = Shards()
        for k in tp.keys:
            y = labels[k][:, sl].long()
            ok = (y >= 0) & (y < cfg.padded_vocab)
            lse = torch.log(se[k]) + mx[k]
            out[k] = ((lse - torch.where(ok, ll[k], 0.0))
                      * masks[k][:, sl]).sum()
        return out

    tot = None
    for i in range(s // blk):
        sl = slice(i * blk, (i + 1) * blk)
        part = (CK.checkpoint(block, sl, hidden, use_reentrant=False)
                if torch.is_grad_enabled() else block(sl, hidden))
        tot = part if tot is None else _add(tot, part)
    tot = tp.psum(tot, tp.batch_axes, "lm_loss.total")
    cnt = tp.psum(tp.map(lambda m: m.sum(), masks), tp.batch_axes,
                  "lm_loss.count")
    return tot[k0] / torch.clamp(cnt[k0], min=1.0)


def _encoder_tp(params: dict, cfg: ModelConfig, frames: Shards, tp):
    """:func:`run_encoder` and :func:`encoder_cross_kv` over placed
    weights: a list of each decoder layer's cross K/V Shards."""
    enc = params["encoder"]
    pos = tp.map(lambda f: torch.arange(f.shape[1], device=f.device)[
        None].expand(f.shape[0], f.shape[1]), frames)
    if frames[tp.keys[0]].shape[1] % tp.seq_parts():
        tp = tp.with_seq(())
    x, _, _ = run_stack_tp({"layers": enc["layers"]}, _encoder_cfg(cfg),
                           tp.seq_slice(tp.map(lambda f: f.to(cfg.dtype),
                                               frames)), pos,
                           tp, causal=False, prefix="encoder.")
    x = norm_tp(tp.use_tree(enc["final_norm"], "encoder.final_norm"), cfg, x,
                tp)
    x = tp.gather_seq(x, "encoder.final_norm.seq")
    tp = tp.with_seq(())
    return [cross_kv_tp(tp.use_tree(layer_params_tp(params, cfg, i)["cross"],
                                    layer_name(cfg, i) + ".cross"), x, tp)
            for i in range(cfg.n_layers)]


def _batch_tp(batch: dict, tp) -> dict:
    return {k: tp.scatter(v) for k, v in batch.items()}


def _positions(x: Shards, tp) -> Shards:
    """The whole sequence's positions (``x`` may hold slices of it:
    ``tp.seq_axes``)."""
    n = tp.seq_parts()
    return tp.map(lambda t: torch.arange(t.shape[1] * n, device=t.device)[
        None].expand(t.shape[0], t.shape[1] * n), x)


def train_loss_tp(params: dict, cfg: ModelConfig, batch: dict, *,
                  remat: str = "none", tp=None):
    """:func:`train_loss` over placed weights (``batch`` on the mesh's home
    entry, cut over the batch axes where it divides them).

    It reads the activation rules in force (``parallel.sharding.
    axis_rules``), as the reference's ``shard_act`` does: where they map
    ``"seq"`` to 'model' (``REPRO_SEQ_ACT=model``), the residual stream is
    cut along the sequence over 'model' between sublayers (Megatron-style
    sequence parallelism, ``TP.seq_axes``): norms run on each coordinate's
    slice, an ``all-gather`` over 'model' joins the normed slices before the
    column-parallel projections, and a ``reduce-scatter`` along the
    sequence replaces the ``psum`` after the row-parallel ones and after
    the embedding lookup. The loss gathers the sequence (an ``all-gather``
    of the final norm's output) and runs the vocabulary-parallel cross
    entropy as without the rule. A sequence that does not split evenly
    keeps the stream whole."""
    if tp is None:
        tp = SHD.TP.for_batch(SHD.placed_mesh(params),
                              batch["tokens"].shape[0])
    seq = SHD.seq_axes_in_force(tp.mesh)
    if seq:
        s = batch["tokens"].shape[1] + (
            batch["frontend"].shape[1] if cfg.frontend != "none"
            and "frontend" in batch else 0)
        tp = tp.with_seq(seq)
        if s % tp.seq_parts():
            tp = tp.with_seq(())
    bt = _batch_tp(batch, tp)
    x = _assemble_tp(params, cfg, bt, tp)
    enc_kv = (_encoder_tp(params, cfg, bt["enc_frames"], tp)
              if cfg.is_encdec else None)
    x, aux, _ = run_stack_tp(params, cfg, x, _positions(x, tp), tp,
                             enc_kv=enc_kv, remat=remat)
    x = norm_tp(tp.use_tree(params["final_norm"], "final_norm"), cfg, x, tp)
    x = tp.gather_seq(x, "final_norm.seq")
    ce = lm_loss_tp(params, cfg, x, bt["labels"], bt["loss_mask"], tp)
    loss = ce
    aux0 = 0.0 if aux is None else aux[tp.keys[0]]
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux0 / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux0}


def prefill_tp(params: dict, cfg: ModelConfig, batch: dict, *, tp=None):
    """:func:`prefill` over placed weights. Returns (last-token logits [b,
    V] on the home entry, cache: each leaf a Shards of the coordinate's
    slots and heads, stacked over the layers as :func:`prefill`'s)."""
    if tp is None:
        tp = SHD.TP.for_batch(SHD.placed_mesh(params),
                              batch["tokens"].shape[0])
    bt = _batch_tp(batch, tp)
    x = _assemble_tp(params, cfg, bt, tp)
    enc_kv = (_encoder_tp(params, cfg, bt["enc_frames"], tp)
              if cfg.is_encdec else None)
    x, _, cache = run_stack_tp(params, cfg, x, _positions(x, tp), tp,
                               collect=True, enc_kv=enc_kv)
    if enc_kv is not None:
        cache["enc_k"] = Shards({k: torch.stack([e[k][0] for e in enc_kv])
                                 for k in tp.keys})
        cache["enc_v"] = Shards({k: torch.stack([e[k][1] for e in enc_kv])
                                 for k in tp.keys})
    x = norm_tp(tp.use_tree(params["final_norm"], "final_norm"), cfg, x, tp)
    last = tp.map(lambda t: t[:, -1], x)
    return tp.join_batch(logits_tp(params, cfg, last, tp)), cache


def cross_sublayer_tp(P: dict, cfg: ModelConfig, x1: Shards, enc_k, enc_v,
                      enc_valid, tp, *, origin: str) -> Shards:
    """:func:`cross_sublayer` of one token over placed weights: each
    coordinate's q heads against the kv heads it holds of ``enc_k`` /
    ``enc_v`` (one layer's ``Placed`` [b_local, se, kh_local, hd]), then
    ``wo``'s rows summed."""
    from repro_torch.models.layers.attention import kv_slice, wo_tp
    h = norm_tp(P["norm_x"], cfg, x1, tp)
    wq = P["cross"]["wq"]
    heads = Shards()
    for k in tp.keys:
        sl = kv_slice(cfg, wq.range_of(-2, k), enc_k.range_of(-2, k))
        heads[k] = _cross_decode_heads(
            wq[k], cfg, h[k], enc_k[k][:, :, sl], enc_v[k][:, :, sl],
            None if enc_valid is None else enc_valid[k]).flatten(-2)
    return _add(x1, wo_tp(P["cross"]["wo"], heads, tp, origin + ".cross"))


def mamba_block_decode_tp(P: dict, cfg: ModelConfig, kind: str, x1: Shards,
                          state: dict, tp, *, origin: str) -> Shards:
    """:func:`mamba_block_decode` over placed weights and one layer's
    placed state (updated in place)."""
    h = norm_tp(P["norm1"], cfg, x1, tp)
    step = ssm.mamba1_decode_tp if kind == MAMBA1 else ssm.mamba2_decode_tp
    return _add(x1, step(P["mamba"], cfg, h, state, tp,
                         origin=origin + ".mamba"))


# ============================================ dense decode over a mesh (TP)
def _ssm_state_spec(shape: tuple, batch_axes: tuple, mesh) -> tuple:
    """A stacked SSM state [n, b, ...] placed as the serving engine places
    its own (``serving/engine._ssm_spec``): the slots over the batch axes,
    'model' on Mamba2's heads or on Mamba1's (and the conv tails') larger
    trailing dimension where it divides."""
    nm = int(mesh.shape.get("model", 1))
    parts = [None, SHD.spec_entry(batch_axes)] + [None] * (len(shape) - 2)
    if len(shape) == 5:   # Mamba2 h [n, b, nh, dh, st]
        if shape[2] % nm == 0:
            parts[2] = "model"
    else:   # Mamba1 h [n, b, di, st] / conv tails [n, b, cw - 1, di]
        big = -1 if shape[-1] >= shape[-2] else -2
        if shape[big] % nm == 0:
            parts[big] = "model"
    return tuple(parts)


def cache_specs(cfg: ModelConfig, cache: dict, params: dict) -> dict:
    """The dense cache's placement over the mesh of placed ``params``, by
    ``SERVE_PARAM_RULES``' layout: the slots over the batch axes
    (``TP.for_batch``'s rule), the kv heads of ``k`` / ``v`` /
    ``shared_k`` / ``shared_v`` / ``enc_k`` / ``enc_v`` [L, b, len, kh, hd]
    cut as the weights' ``wk`` cuts them (over 'model' where it divides),
    the SSM states as the serving engine's."""
    mesh = SHD.placed_mesh(params)
    some = next(v for v in cache.values() if not isinstance(v, dict))
    ssm_b = (next(iter(cache["ssm"].values())).shape[1]
             if "ssm" in cache else None)
    b = ssm_b if ssm_b is not None else some.shape[1]
    bax = SHD.TP.for_batch(mesh, b).batch_axes
    wk = _kv_weight(params, cfg)
    heads = () if wk is None else wk.axes_of(-2)
    out = {}
    for name, t in cache.items():
        if name == "ssm":
            out[name] = {n: _ssm_state_spec(tuple(a.shape), bax, mesh)
                         for n, a in t.items()}
        else:
            out[name] = (None, SHD.spec_entry(bax), None,
                         SHD.spec_entry(heads), None)
    return out


def _kv_weight(params: dict, cfg: ModelConfig):
    """A placed ``wk`` of the model (its kv heads' placement), or None for
    an attention-free stack."""
    for i in range(cfg.n_layers):
        if cfg.layer_pattern[i] not in SSM_KINDS:
            return layer_params_tp(params, cfg, i)["attn"]["wk"]
    if "shared" in params:
        return params["shared"]["attn"]["wk"]
    return None


def place_cache(cfg: ModelConfig, cache: dict, params: dict) -> dict:
    """A dense cache (:func:`init_cache`, whole tensors) placed over the
    mesh of placed ``params`` by :func:`cache_specs`: each leaf a
    ``Placed`` of each coordinate's slots and heads (a copy of its own)."""
    specs = cache_specs(cfg, cache, params)
    mesh = SHD.placed_mesh(params)
    return {name: ({n: SHD.split_by_spec(a, specs[name][n], mesh)
                    for n, a in t.items()} if name == "ssm"
                   else SHD.split_by_spec(t, specs[name], mesh))
            for name, t in cache.items()}


def join_cache(cache: dict, device=None) -> dict:
    """The inverse of :func:`place_cache`: every leaf whole on ``device``
    (None: the mesh's home entry)."""
    return {name: ({n: SHD.join_placed(a, device) for n, a in t.items()}
                   if name == "ssm" else SHD.join_placed(t, device))
            for name, t in cache.items()}


def attn_block_decode_tp(P: dict, cfg: ModelConfig, x1: Shards, cache_k,
                         cache_v, lengths: Shards, tp, *, window: int,
                         theta: float, cross=None, enc_valid=None,
                         origin: str) -> Shards:
    """:func:`attn_block_decode` over one layer's placed weights and its
    placed dense caches (``Placed`` [b, L, kh, hd], written in place):
    each coordinate projects its q / k / v heads, writes its k / v into
    the caches' heads it holds and attends its q heads to them
    (:func:`~repro_torch.models.layers.attention.decode_attend`, plain),
    then ``wo``'s rows are summed (``psum``), as the paged ``_tp_step``
    does around its island. ``cross``: the layer's placed (enc_k,
    enc_v)."""
    from repro_torch.models.layers.attention import (decode_attend, kv_slice,
                                                     qkv_project, wo_tp,
                                                     write_token)
    h = norm_tp(P["norm1"], cfg, x1, tp)
    at = P["attn"]
    heads = Shards()
    for k in tp.keys:
        if at["wk"].range_of(-2, k) != cache_k.range_of(-2, k):
            raise ValueError(f"{origin}: the cache's kv heads "
                             f"{cache_k.range_of(-2, k)} at {k} are not "
                             f"wk's {at['wk'].range_of(-2, k)}: place it "
                             f"with place_cache")
        q, kk, vv = qkv_project(SHD.local_tree(at, k), cfg, h[k],
                                lengths[k][:, None], theta)
        write_token(cache_k[k], cache_v[k], kk, vv, lengths[k])
        sl = kv_slice(cfg, at["wq"].range_of(-2, k), cache_k.range_of(-2, k))
        heads[k] = decode_attend(cfg, q, cache_k[k][:, :, sl],
                                 cache_v[k][:, :, sl], lengths[k],
                                 window=window).flatten(-2)
    a = wo_tp(at["wo"], heads, tp, origin + ".attn")
    x1 = _add(x1, _post_norm_tp(P, cfg, "norm1_post", a, tp))
    if cross is not None:
        x1 = cross_sublayer_tp(P, cfg, x1, *cross, enc_valid, tp,
                               origin=origin)
    return mlp_sublayer_tp(P, cfg, x1, tp, origin)[0]


def decode_step_tp(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: dict, lengths: torch.Tensor, *, enc_valid=None,
                   tp=None):
    """:func:`decode_step` over placed weights (``SERVE_PARAM_RULES``) and
    a placed dense cache (:func:`place_cache`, updated in place): tokens,
    lengths and ``enc_valid`` [b] on the mesh's home entry, cut over the
    batch axes where they divide them; every coordinate runs its heads,
    columns and SSM shards with the collectives of the paged
    ``serving/engine._tp_step`` (``psum`` of the rows, the vocabulary-
    sharded lookup and logits). Like the mesh-free step it reaches no
    kernel. Returns (logits [b, V] fp32 on the home entry, cache)."""
    check_supported(cfg)
    for t in cache.values():
        for leaf in (t.values() if isinstance(t, dict)
                     and not isinstance(t, Shards) else (t,)):
            if not isinstance(leaf, SHD.Placed):
                raise TypeError("decode over placed weights takes a cache "
                                "placed by transformer.place_cache")
    if tp is None:
        tp = SHD.TP.for_batch(SHD.placed_mesh(params), tokens.shape[0])
    toks = tp.scatter(tokens)
    lens = tp.map(lambda t: t.long(), tp.scatter(lengths))
    ev = None if enc_valid is None else tp.scatter(enc_valid)
    x = embed_tokens_tp(params, cfg, tp.map(lambda t: t[:, None], toks), tp)
    ai = si = 0
    for i in range(cfg.n_layers):
        name = layer_name(cfg, i)
        P = tp.use_tree(layer_params_tp(params, cfg, i), name)
        kind = cfg.layer_pattern[i]
        if kind in SSM_KINDS:
            x = mamba_block_decode_tp(
                P, cfg, kind, x, {n: t.layer(si) for n, t in
                                  cache["ssm"].items()}, tp, origin=name)
            si += 1
        else:
            window, theta = layer_attrs(cfg, i)
            cross = ((cache["enc_k"].layer(i), cache["enc_v"].layer(i))
                     if "enc_k" in cache else None)
            x = attn_block_decode_tp(P, cfg, x, cache["k"].layer(ai),
                                     cache["v"].layer(ai), lens, tp,
                                     window=window, theta=theta, cross=cross,
                                     enc_valid=ev, origin=name)
            ai += 1
        g = shared_app(cfg, i)
        if g >= 0:
            x = attn_block_decode_tp(
                tp.use_tree(params["shared"], f"shared.{g}"), cfg, x,
                cache["shared_k"].layer(g), cache["shared_v"].layer(g), lens,
                tp, window=0, theta=global_theta(cfg), origin=f"shared.{g}")
    x = norm_tp(tp.use_tree(params["final_norm"], "final_norm"), cfg, x, tp)
    logits = tp.join_batch(logits_tp(params, cfg, tp.map(
        lambda t: t[:, 0], x), tp))
    return logits, cache
