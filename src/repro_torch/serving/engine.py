"""Serving engine: continuous batching on top of the paged KV pool (port
of ``repro.serving.engine``: dense and MoE decoders, the vision-frontend
decoder, the encoder-decoder, Mamba1 stacks and the zamba2 hybrid; the
engine on one device, the serve step also over a device mesh).

Layering (top to bottom):

- ``ServeEngine`` (host): request lifecycle + the SQLcached *management
  plane*: every block allocation is an INSERT into the ``kv`` metadata
  table of the port's ``SQLCached`` (``DELETE FROM kv WHERE seq_id=?``
  finishes a request; ``... WHERE user_id=?`` ends a session; ``FLUSH``
  is the memcached strawman the paper benchmarks against).
- ``ServeGraph`` (device): the decode round as one captured CUDA graph,
  the counterpart of the reference's jitted step. Its inputs are static
  buffers shaped by ``serve_input_specs``; the engine writes them in
  place (the page table and tail rows from the SQL plane, the tokens,
  lengths and write offsets through one staged copy a round), and a warm
  round is one copy in, one ``cudaGraphLaunch`` and one copy of the next
  tokens back. ``lower_serve_step`` builds one outside an engine.
- ``make_serve_step`` (device): one decode token for every slot. Each
  attention layer, and each application of zamba2's shared block, writes
  the new token's K/V into its arena and reads the pool through the page
  table with the paged-attention kernel (``serving/paged.py``); an
  encoder-decoder's layer then attends its slot's cross K/V (``enc_k`` /
  ``enc_v`` in the state, plain PyTorch as in the reference) before its
  MLP; the MLP is an MoE where the config has experts; SSM layers advance
  their O(1) states. Prefill runs the flash-attention and Mamba2 scan
  kernels (``models/transformer.prefill``: the encoder, the decoder's
  self and cross attention) eagerly.
- Over a device mesh (``launch/mesh.Mesh``), ``make_serve_step`` takes
  parameters placed by ``SERVE_PARAM_RULES``
  (``parallel/sharding.place_params``) and runs every coordinate's part
  on its device: its slots (cut over the batch axes), its vocabulary rows
  of the embedding (the reference's clamp, mask and ``psum``), its heads'
  q / k / v columns, the island over its arena shard
  (``serving/paged.py``: each arena a
  :class:`~repro_torch.parallel.collectives.Shards`, one tensor a
  coordinate; where the island's heads are not the ones the weights made,
  as with striped blocks, q is gathered over 'model' first), ``wo``'s and
  ``w_down``'s rows and the MoE's experts with a ``psum`` after them, its
  Mamba shards with their states placed by the reference's spec, and its
  vocabulary slice of the logits, ``all_gather``-ed. The logits and next
  tokens come back to the home entry. ``serve_state_specs`` /
  ``serve_input_specs`` give the reference's specs beside the shapes,
  ``init_serve_state(mesh=)`` / ``place_state`` / ``join_state`` build and
  move a placed state, and ``lower_serve_step(mesh=)`` returns a
  :class:`MeshServeStep` (eager: no CUDA graph; over the production
  mesh's ``meta`` plan, shapes only). The live ``ServeEngine`` stays
  mesh-free, as the reference's does.

An attention-free stack (falcon-mamba) has no arena, no page-table
inputs and no block to allocate: as in the reference, its requests
INSERT nothing into the ``kv`` table, and finishing, evicting or
flushing them still runs the DELETE / FLUSH (a count of 0) and keeps the
page table and tail rows that no step reads.

``cfg.kv_quant_int8`` (reached as the reference reaches it, through
``dataclasses.replace(cfg, kv_quant_int8=True)``) makes every arena int8
with fp32 scales beside it (``arena_scale`` / ``shared_arena_scale``,
``[L, rows + 1, 2, block, kh]``): the island quantizes the new token at
write time, and a prefill's K/V are quantized in one pass on the device
as they are installed.

Host syncs are the reference's: the first token of a prefill
(``argmax``), the tokens of a decode round, and the count of a DELETE or
FLUSH. Block allocation (``_insert_blocks``) and the round's prime,
capture and replay do not wait on the device: parameters travel through
pinned non-blocking uploads and row ids stay on the device. Every state
tensor (arenas, SSM states) is updated in place.

A request's ``extras`` are the reference's: ``frontend`` ([frontend_len,
d] patch embeddings placed before the prompt: the sequence holds
``frontend_len + n`` positions) and ``enc_frames`` ([frontend_len, d]
frames for the encoder, whose cross K/V are copied into the slot's rows of
the static ``enc_k`` / ``enc_v`` state).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import execache as EC
from repro_torch.core import kvpool
from repro_torch.core import table as T
from repro_torch.core.daemon import SQLCached, resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.mesh import check_mesh, is_walking
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import (_scale, out_project,
                                                 qkv_project, wo_tp)
from repro_torch.models.layers.norms import rms_norm
from repro_torch.models.params import param_axes
from repro_torch.parallel import sharding as SHD
from repro_torch.parallel.sharding import spec_entry
from repro_torch.serving.paged import (PagedGeom, Shards, build_blk_start,
                                       coordinates, join_arena, localize,
                                       make_paged_island, plan_geometry,
                                       quantize_kv, split_arena, zero_shards)


# ============================================================== serve step
def _layer(t, i: int):
    """Layer ``i`` of a layer-major arena, whole or placed."""
    return t.layer(i) if isinstance(t, Shards) else t[i]


def make_serve_step(cfg: ModelConfig, geom: PagedGeom, mesh=None):
    """Build serve_step(params, state, inputs) -> (next_tokens, state,
    logits): one new token per slot against the paged arenas. The arenas
    and SSM states in ``state`` are updated in place. Over ``mesh`` (with
    ``geom`` planned on it) the step takes ``params`` placed by
    ``SERVE_PARAM_RULES`` (``parallel/sharding.place_params``), a state
    placed by :func:`place_state` and the mesh's inputs
    (:func:`serve_input_specs`) on its home entry, and runs coordinate by
    coordinate (:func:`_tp_step`)."""
    TF.check_supported(cfg)
    check_mesh(mesh)
    if mesh is not None:
        mesh.require_runnable("the serve step")
    quant = cfg.kv_quant_int8
    islands: dict[int, object] = {}

    def island_for(window: int):
        if window not in islands:
            islands[window] = make_paged_island(
                geom, mesh, scale=_scale(cfg),
                softcap=cfg.attn_softcap, window=window, quant=quant)
        return islands[window]

    def attn_mlp(p, x, arena_l, scale_l, inputs, *, window, theta,
                 cross=None):
        """Attention through the paged island, the cross sublayer over
        ``cross`` ((enc_k, enc_v) of the layer, an encoder-decoder's),
        then the MLP or MoE, each with its sandwich norm where the config
        has them (``scale_l``: the int8 arena's scales, else None). The
        arena receives the new token's k as ``qkv_project`` gives it:
        normed (q/k norms), then roped."""
        lengths = inputs["lengths"]
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = qkv_project(p["attn"], cfg, h, lengths[:, None], theta)
        extra = (scale_l,) if quant else ()
        a = island_for(window)(
            q[:, 0], k[:, 0], v[:, 0], arena_l, inputs["pt"],
            inputs["blk_start"], lengths, inputs["write_rows"],
            inputs["write_off"], *extra)[0]
        x = x + TF.post_norm(p, cfg, "norm1_post",
                             out_project(p["attn"], a[:, None]))
        if cross is not None:
            x = TF.cross_sublayer(p, cfg, x, *cross, inputs["enc_valid"])
        return TF.mlp_sublayer(p, cfg, x)[0]

    def serve_step(params, state, inputs):
        x = TF.embed_tokens(params, cfg, inputs["tokens"][:, None])
        ai = si = 0
        for i in range(cfg.n_layers):
            p = TF.layer_params(params, cfg, i)
            kind = cfg.layer_pattern[i]
            if kind in TF.SSM_KINDS:
                x, _ = TF.mamba_block_decode(
                    p, cfg, kind, x,
                    {n: t[si] for n, t in state["ssm"].items()})
                si += 1
            else:
                window, theta = TF.layer_attrs(cfg, i)
                cross = ((state["enc_k"][i], state["enc_v"][i])
                         if "enc_k" in state else None)
                x = attn_mlp(p, x, _layer(state["arena"], ai),
                             _layer(state["arena_scale"], ai) if quant
                             else None, inputs, window=window, theta=theta,
                             cross=cross)
                ai += 1
            g = TF.shared_app(cfg, i)
            if g >= 0:
                x = attn_mlp(params["shared"], x,
                             _layer(state["shared_arena"], g),
                             _layer(state["shared_arena_scale"], g) if quant
                             else None, inputs, window=0,
                             theta=TF.global_theta(cfg))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = TF.logits_fn(params, cfg, x[:, 0])
        return torch.argmax(logits, dim=-1).to(torch.int32), state, logits

    if mesh is None:
        return serve_step
    return _tp_step(cfg, geom, mesh, island_for)


def _cut_heads(tp, vals: dict, leaf, want, origin: str) -> dict:
    """Each coordinate's heads ``want(key)`` (global [h0, h1)) of ``vals``
    ([b, n, hd]: the heads ``leaf``'s placement gave it along its dim -2),
    gathered over the axes that cut them where a coordinate lacks some."""
    held = {k: leaf.range_of(-2, k) for k in tp.keys}
    if not all(held[k][0] <= want(k)[0] and want(k)[1] <= held[k][1]
               for k in tp.keys):
        vals = tp.all_gather(Shards(vals), leaf.axes_of(-2), 1, origin)
        held = {k: (0, leaf.shape[-2]) for k in tp.keys}
    return Shards({k: vals[k][:, want(k)[0] - held[k][0]:
                              want(k)[1] - held[k][0]] for k in tp.keys})


def _tp_step(cfg: ModelConfig, geom: PagedGeom, mesh, island_for):
    """The serve step over placed weights (:func:`make_serve_step`)."""
    quant = cfg.kv_quant_int8
    tp = SHD.TP(mesh, geom.batch_axes)
    if len(coordinates(geom, mesh)) != mesh.size:
        raise ValueError(f"the paged plan {geom.manual_axes} leaves mesh "
                         f"axes of {mesh.shape} unused")

    def attn_mlp(P, x, arena_l, scale_l, inputs, local, *, window, theta,
                 cross, origin):
        P = tp.use_tree(P, origin)
        lengths = inputs["lengths"]
        h = TF.norm_tp(P["norm1"], cfg, x, tp)
        qkv = {k: qkv_project(SHD.local_tree(P["attn"], k), cfg, h[k],
                              lengths[k][:, None], theta) for k in tp.keys}
        at = P["attn"]
        cs = {c.index: c for c in local.coords}
        q = _cut_heads(tp, {k: t[0][:, 0] for k, t in qkv.items()}, at["wq"],
                       lambda k: (cs[k].h0, cs[k].h1), origin + ".attn.q")
        kn = _cut_heads(tp, {k: t[1][:, 0] for k, t in qkv.items()},
                        at["wk"], lambda k: (cs[k].k0, cs[k].k1),
                        origin + ".attn.k")
        vn = _cut_heads(tp, {k: t[2][:, 0] for k, t in qkv.items()},
                        at["wv"], lambda k: (cs[k].k0, cs[k].k1),
                        origin + ".attn.v")
        extra = (scale_l,) if quant else ()
        out = island_for(window)(q, kn, vn, arena_l, None, None, None, None,
                                 None, *extra, local=local)[0]
        heads = Shards()
        for k in tp.keys:
            o0, o1 = at["wo"].range_of(-3, k)
            heads[k] = out[k][:, None, o0 - cs[k].h0:o1 - cs[k].h0].flatten(-2)
        a = wo_tp(at["wo"], heads, tp, origin + ".attn")
        x = TF._add(x, TF._post_norm_tp(P, cfg, "norm1_post", a, tp))
        if cross is not None:
            x = TF.cross_sublayer_tp(P, cfg, x, *cross, inputs.get(
                "enc_valid"), tp, origin=origin)
        return TF.mlp_sublayer_tp(P, cfg, x, tp, origin)[0]

    def serve_step(params, state, inputs):
        if not SHD.is_placed(params):
            raise TypeError("over a mesh the serve step takes params placed "
                            "by SERVE_PARAM_RULES (parallel/sharding."
                            "place_params)")
        for t in state.get("ssm", {}).values():
            if not isinstance(t, SHD.Placed):
                raise TypeError("the serve step over a mesh takes a state "
                                "placed by place_state")
        local = (localize(geom, mesh, inputs["pt"], inputs["blk_start"],
                          inputs["lengths"], inputs["write_rows"],
                          inputs["write_off"])
                 if has_attention(cfg) else None)
        loc = {n: tp.scatter(inputs[n]) for n in ("tokens", "lengths",
                                                  "enc_valid")
               if n in inputs}
        x = TF.embed_tokens_tp(params, cfg,
                               tp.map(lambda t: t[:, None], loc["tokens"]),
                               tp)
        ai = si = 0
        for i in range(cfg.n_layers):
            P = TF.layer_params_tp(params, cfg, i)
            name = TF.layer_name(cfg, i)
            kind = cfg.layer_pattern[i]
            if kind in TF.SSM_KINDS:
                x = TF.mamba_block_decode_tp(
                    tp.use_tree(P, name), cfg, kind, x,
                    {n: t.layer(si) for n, t in state["ssm"].items()}, tp,
                    origin=name)
                si += 1
            else:
                window, theta = TF.layer_attrs(cfg, i)
                cross = ((state["enc_k"].layer(i), state["enc_v"].layer(i))
                         if "enc_k" in state else None)
                x = attn_mlp(P, x, _layer(state["arena"], ai),
                             _layer(state["arena_scale"], ai) if quant
                             else None, loc, local, window=window,
                             theta=theta, cross=cross, origin=name)
                ai += 1
            g = TF.shared_app(cfg, i)
            if g >= 0:
                x = attn_mlp(params["shared"], x,
                             _layer(state["shared_arena"], g),
                             _layer(state["shared_arena_scale"], g) if quant
                             else None, loc, local, window=0,
                             theta=TF.global_theta(cfg), cross=None,
                             origin=f"shared.{g}")
        x = TF.norm_tp(tp.use_tree(params["final_norm"], "final_norm"), cfg,
                       x, tp)
        logits = tp.join_batch(TF.logits_tp(
            params, cfg, tp.map(lambda t: t[:, 0], x), tp))
        return torch.argmax(logits, dim=-1).to(torch.int32), state, logits

    return serve_step


# =========================================================== state builders
def serve_state_specs(cfg: ModelConfig, geom: PagedGeom, mesh=None,
                      enc_len: int = 0) -> dict:
    """{name: (shape, dtype)} of the serve state at ``geom.cap`` arena rows
    (the engine adds its slack and the arenas' scratch row); ``"ssm"`` maps
    each SSM state (Mamba1: ``h [n_ssm, b, d_inner, state]`` fp32, ``conv
    [n_ssm, b, conv - 1, d_inner]``; Mamba2: ``h``, ``conv_x``,
    ``conv_bc``) to its (shape, dtype), stacked over the SSM layers and
    batched over the slots. An attention-free stack has no arena. With
    ``kv_quant_int8`` the arenas are int8 and ``arena_scale`` /
    ``shared_arena_scale`` hold their fp32 scales (one a row, k/v,
    position and kv head), as in the reference. An encoder-decoder with
    ``enc_len > 0`` adds each slot's cross K/V, ``enc_k`` / ``enc_v``
    ``[L, b, enc_len, kh, hd]``.

    With a ``mesh`` each entry is ``(shape, dtype, spec)`` (``"ssm"``: a
    dict of them), ``spec`` the reference's spec of that leaf as a tuple:
    the arenas and their scales by ``geom.arena_spec()``, the Mamba states
    and ``enc_k`` / ``enc_v`` by the reference's specs: where the port
    places them (:func:`place_state`)."""
    TF.check_supported(cfg)
    check_mesh(mesh)
    row = (2, geom.block, cfg.n_kv_heads, cfg.head_dim)
    quant = cfg.kv_quant_int8
    kv_dtype = torch.int8 if quant else cfg.dtype
    la = TF.n_attn_layers(cfg)
    specs = {}
    if la:
        specs["arena"] = ((la, geom.cap) + row, kv_dtype)
        if quant:
            specs["arena_scale"] = ((la, geom.cap) + row[:-1], torch.float32)
    if cfg.shared_attn_every > 0:
        napps = cfg.n_shared_applications()
        specs["shared_arena"] = ((napps, geom.cap) + row, kv_dtype)
        if quant:
            specs["shared_arena_scale"] = ((napps, geom.cap) + row[:-1],
                                           torch.float32)
    if cfg.ssm_layer_ids:
        n = len(cfg.ssm_layer_ids)
        one = TF.ssm_init_state(cfg, geom.batch, "meta")
        specs["ssm"] = {k: ((n,) + tuple(a.shape), a.dtype)
                        for k, a in one.items()}
    if cfg.is_encdec and enc_len > 0:
        shape = (cfg.n_layers, geom.batch, enc_len, cfg.n_kv_heads,
                 cfg.head_dim)
        specs["enc_k"] = specs["enc_v"] = (shape, cfg.dtype)
    if mesh is None:
        return specs
    return _with_specs(specs, geom, mesh)


def _ssm_spec(shape: tuple, geom: PagedGeom, mesh) -> tuple:
    """The reference's spec of a stacked SSM state [n, b, ...]: the slots
    over the batch axes, and 'model' on Mamba2's heads or Mamba1's (and
    the conv tails') larger trailing dimension where it divides."""
    nm = int(mesh.shape.get("model", 1))
    parts = [None, spec_entry(geom.batch_axes)] + [None] * (len(shape) - 2)
    if len(shape) == 5:   # Mamba2 h [n, b, nh, dh, st]
        if shape[2] % nm == 0:
            parts[2] = "model"
    else:   # Mamba1 h [n, b, di, st] / conv tails [n, b, cw - 1, di]
        big = -1 if shape[-1] >= shape[-2] else -2
        if shape[big] % nm == 0:
            parts[big] = "model"
    return tuple(parts)


def _enc_spec(geom: PagedGeom) -> tuple:
    """enc_k / enc_v [L, b, enc_len, kh, hd]: slots and kv heads as the
    arena's."""
    return (None, spec_entry(geom.batch_axes), None,
            spec_entry(geom.head_axes), None)


def _with_specs(specs: dict, geom: PagedGeom, mesh) -> dict:
    """The reference's specs beside each state leaf's shape and dtype
    (``serving/engine.py:serve_state_specs``)."""
    out = {}
    for name, spec in specs.items():
        if name == "ssm":
            out[name] = {k: (shape, dt, _ssm_spec(shape, geom, mesh))
                         for k, (shape, dt) in spec.items()}
        elif name in ("arena", "shared_arena"):
            out[name] = spec + (geom.arena_spec(),)
        elif name in ARENAS:   # the int8 scales: no head-dim axis
            out[name] = spec + (geom.arena_spec()[:5],)
        else:   # enc_k / enc_v [L, b, enc_len, kh, hd]
            out[name] = spec + (_enc_spec(geom),)
    return out


def has_attention(cfg: ModelConfig) -> bool:
    """Whether the stack attends (attention layers or a shared block),
    hence has arenas and page-table inputs."""
    return TF.n_attn_layers(cfg) > 0 or cfg.shared_attn_every > 0


def serve_input_specs(cfg: ModelConfig, geom: PagedGeom, mesh=None) -> dict:
    """{name: (shape, dtype)} of the serve step's inputs, the reference's
    ShapeDtypeStructs: ``pt`` and ``blk_start`` ``[b, stripe_total,
    nblk_local]``, ``write_rows`` ``[b, stripe_total]`` (without a mesh
    ``stripe_total`` 1 and ``nblk_local`` ``nblk``: the decode graph's
    static input buffers); an encoder-decoder's ``enc_valid``, the encoder
    positions each slot attends. With a ``mesh``, ``(shape, dtype,
    spec)``, the reference's spec of each (the port cuts them per
    coordinate on the home entry: ``serving/paged.localize``)."""
    TF.check_supported(cfg)
    check_mesh(mesh)
    b, st, nl = geom.batch, geom.stripe_total, geom.nblk_local
    specs = {name: ((b,), torch.int32, geom.vec_spec())
             for name in ("tokens", "lengths", "write_off")}
    if has_attention(cfg):
        specs["pt"] = ((b, st, nl), torch.int32, geom.pt_spec())
        specs["blk_start"] = ((b, st, nl), torch.int32, geom.pt_spec())
        specs["write_rows"] = ((b, st), torch.int32, geom.wrows_spec())
    if cfg.is_encdec:
        specs["enc_valid"] = ((b,), torch.int32, geom.vec_spec())
    if mesh is None:
        return {k: v[:2] for k, v in specs.items()}
    return specs


ARENAS = ("arena", "arena_scale", "shared_arena", "shared_arena_scale")


def init_serve_state(cfg: ModelConfig, geom: PagedGeom, rows: int,
                     device, mesh=None) -> dict:
    """Zeroed serve state with ``rows`` arena rows plus the scratch row of
    the dropped writes (and an encoder-decoder's ``enc_k`` / ``enc_v`` of
    ``frontend_len`` positions, as the reference's engine sizes them).
    Over a ``mesh`` (``rows`` must be ``geom.cap``) the state is placed
    (:func:`place_state`)."""
    if mesh is not None:
        if rows != geom.cap:
            raise ValueError(f"a placed state holds geom.cap = {geom.cap} "
                             f"rows, not {rows}")
        return place_state(init_serve_state(cfg, geom, rows, "meta"), geom,
                           mesh, zeros=True)
    state = {}
    specs = serve_state_specs(
        cfg, geom, enc_len=cfg.frontend_len if cfg.is_encdec else 0)
    for name, spec in specs.items():
        if name == "ssm":
            state[name] = {k: torch.zeros(shape, dtype=dtype, device=device)
                           for k, (shape, dtype) in spec.items()}
        else:
            shape, dtype = spec
            if name in ARENAS:
                shape = (shape[0], rows + 1) + shape[2:]
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def place_state(state: dict, geom: PagedGeom, mesh, *,
                zeros: bool = False) -> dict:
    """A mesh-free serve state (arenas ``[L, rows(+1), ...]``, their first
    ``geom.cap`` rows in the mesh's row layout: row ``shard * cap_local +
    r`` is row r of shard ``batch shard * stripe_total + stripe``) -> the
    mesh's: each arena split over the coordinates
    (``serving/paged.split_arena``), the SSM states and ``enc_k`` /
    ``enc_v`` placed by the reference's specs (``parallel/sharding.Placed``:
    each coordinate's slots and heads or ``d_inner`` slice on its device).
    The placed state shares
    no storage with ``state``. ``zeros``: build zeroed leaves of the same
    shapes (``state`` may then be on the ``meta`` device)."""

    def place(t, spec):
        if zeros:
            return SHD.zeros_by_spec(t.shape, t.dtype, spec, mesh)
        return SHD.split_by_spec(t, spec, mesh)

    out = {}
    for name, t in state.items():
        if name in ARENAS:
            t = t[:, :geom.cap]
            out[name] = (zero_shards(t.shape, t.dtype, geom, mesh) if zeros
                         else split_arena(t, geom, mesh))
        elif name == "ssm":
            out[name] = {k: place(v, _ssm_spec(tuple(v.shape), geom, mesh))
                         for k, v in t.items()}
        else:
            out[name] = place(t, _enc_spec(geom))
    return out


def join_state(state: dict, geom: PagedGeom, mesh) -> dict:
    """The inverse of :func:`place_state`: each arena joined back to
    ``[L, geom.cap, ...]`` on the home entry (no scratch row), every
    placed leaf whole on the home entry."""
    def join(t):
        if isinstance(t, SHD.Placed):
            return SHD.join_placed(t)
        if isinstance(t, Shards):
            return join_arena(t, geom, mesh)
        if isinstance(t, dict):
            return {k: join(v) for k, v in t.items()}
        return t
    return {name: join(t) for name, t in state.items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class ServeGraph:
    """The decode round over static buffers: on the card one captured CUDA
    graph, on the CPU the same body run eagerly.

    ``inputs`` are the step's static input buffers (``serve_input_specs``):
    ``tokens``, ``lengths`` and ``write_off`` are the rows of one ``[3, b]``
    buffer (``vec``) that a round fills with one staged copy; ``pt`` holds
    ``cap`` where a block is missing and is mapped to the kernel's ``-1``
    inside the round; ``write_rows`` is ``-1`` for a slot without a
    request; an encoder-decoder's ``enc_valid`` holds ``frontend_len``
    for every slot, as the reference's engine passes it. The caller
    updates ``pt``, ``write_rows`` and ``state`` in place: the graph reads
    fixed addresses.

    The graph is captured at the first call (or by :meth:`capture`) on
    the side stream of ``core/execache.py``, with that module's device
    lock held, as its statement graphs are: first a prime round against a
    zeroed copy of the state loads the kernels and sizes their scratch on
    that stream, then the capture records the round against the real
    state, inside ``execache.capture_guard`` (the graph, its outputs and
    pool live in an ``execache.GraphHold``, so no graph is destroyed while
    any thread captures). Replays take the same lock. A failed capture
    raises; nothing
    runs the round eagerly on the card. The round's outputs live in the
    graph's pool and the next replay overwrites them."""

    def __init__(self, cfg: ModelConfig, geom: PagedGeom, params: dict,
                 state: dict, cap: int, device):
        self.device = torch.device(device)
        self.params = params
        self.state = state
        self.cap = cap
        self._step_fn = make_serve_step(cfg, geom)
        specs = serve_input_specs(cfg, geom)
        b = geom.batch
        self.vec = torch.zeros((3, b), dtype=torch.int32, device=self.device)
        self.inputs = {"tokens": self.vec[0], "lengths": self.vec[1],
                       "write_off": self.vec[2]}
        if "pt" in specs:
            self.inputs["pt"] = torch.full(specs["pt"][0], cap,
                                           dtype=torch.int32,
                                           device=self.device)
            self.inputs["blk_start"] = T.to_device(build_blk_start(geom),
                                                   self.device)
            self.inputs["write_rows"] = torch.full(
                specs["write_rows"][0], -1, dtype=torch.int32,
                device=self.device)
        if "enc_valid" in specs:
            self.inputs["enc_valid"] = torch.full(
                specs["enc_valid"][0], cfg.frontend_len, dtype=torch.int32,
                device=self.device)
        self._hold = None   # EC.GraphHold: the graph, its outputs, pool
        self.pool = None
        self.launches: dict = {}
        self.capture_ms = None

    @property
    def graph(self):
        """The captured round (None before the capture)."""
        return None if self._hold is None else self._hold.graph

    @property
    def out(self):
        """The round's static outputs in the graph's pool."""
        return None if self._hold is None else self._hold.refs[0]

    def _body(self, state: dict):
        inputs = dict(self.inputs)
        if "pt" in inputs:
            pt = inputs["pt"]
            inputs["pt"] = torch.where(pt >= self.cap, -1, pt)
        nxt, _, logits = self._step_fn(self.params, state, inputs)
        return nxt, logits

    def capture(self) -> None:
        """Prime, then capture the round (a no-op once captured)."""
        if self.device.type != "cuda":
            raise RuntimeError("ServeGraph.capture needs a CUDA device")
        with EC.device_lock(self.device):
            if self.graph is not None:
                return
            t0 = time.perf_counter()
            serving = torch.cuda.current_stream(self.device)
            side = EC.side_stream(self.device)
            side.wait_stream(serving)
            graph = torch.cuda.CUDAGraph()
            pool = torch.cuda.graph_pool_handle()
            try:
                with torch.cuda.stream(side):
                    self._body(_tree_map(torch.zeros_like, self.state))
                    with _build.recording() as rec, EC.capture_guard():
                        graph.capture_begin(pool=pool,
                                            capture_error_mode="thread_local")
                        try:
                            out = self._body(self.state)
                        except BaseException:
                            try:
                                graph.capture_end()
                            except Exception:  # noqa: BLE001 — the body's error wins
                                pass
                            raise
                        graph.capture_end()
            finally:
                serving.wait_stream(side)
            self._hold = EC.GraphHold(graph, out, pool, rec["keep"])
            self.pool = pool
            self.launches = dict(rec["launches"])
            self.capture_ms = (time.perf_counter() - t0) * 1e3

    def __call__(self, host_vec: np.ndarray):
        """One round: ``host_vec`` ([3, b] int32: tokens, lengths, write
        offsets) staged into ``vec``, then the round. Returns (next tokens
        [b] int32, logits [b, padded_vocab] fp32)."""
        if self.device.type == "cuda" and self.graph is None:
            self.capture()
        with EC.device_lock(self.device):
            EC.stage_array(self.vec, host_vec)
            if self.device.type != "cuda":
                return self._body(self.state)
            self.graph.replay()
            _build.add_launches(self.launches)
            return self.out


class MeshServeStep:
    """The decode round over a device mesh (``lower_serve_step(mesh=)``):
    the weights placed by ``SERVE_PARAM_RULES`` (whole ones are placed
    here, as the reference's ``in_shardings`` place them), the placed
    state and the round's static inputs on the mesh's
    home entry (``serve_input_specs``: write ``pt``, ``blk_start`` and
    ``write_rows`` in place), run eagerly, one kernel launch a coordinate
    a layer (no CUDA graph: a mesh's coordinates may be other cards). Over
    a plan-only mesh (``make_production_mesh``) it holds the specs alone,
    and calling it raises."""

    def __init__(self, cfg: ModelConfig, geom: PagedGeom, params, mesh):
        self.mesh, self.geom = mesh, geom
        plan_only = mesh.is_plan and not is_walking()
        if params is not None and not plan_only and not SHD.is_placed(
                params):
            params = SHD.place_params(params, param_axes(cfg),
                                      SHD.SERVE_PARAM_RULES, mesh)
        self.params = params
        self.state_specs = serve_state_specs(
            cfg, geom, mesh, enc_len=cfg.frontend_len if cfg.is_encdec
            else 0)
        self.input_specs = serve_input_specs(cfg, geom, mesh)
        self.state = self.inputs = None
        if plan_only:
            return
        home = mesh.home
        self._step_fn = make_serve_step(cfg, geom, mesh)
        self.state = init_serve_state(cfg, geom, geom.cap, home, mesh=mesh)
        self.vec = torch.zeros((3, geom.batch), dtype=torch.int32,
                               device=home)
        self.inputs = {"tokens": self.vec[0], "lengths": self.vec[1],
                       "write_off": self.vec[2]}
        for name, (shape, _, _) in self.input_specs.items():
            if name in ("pt", "write_rows"):
                self.inputs[name] = torch.full(shape, -1, dtype=torch.int32,
                                               device=home)
            elif name == "blk_start":
                self.inputs[name] = T.to_device(build_blk_start(geom), home)
            elif name == "enc_valid":
                self.inputs[name] = torch.full(shape, cfg.frontend_len,
                                               dtype=torch.int32, device=home)

    def __call__(self, host_vec: np.ndarray):
        """One round: ``host_vec`` ([3, b] int32: tokens, lengths, write
        offsets) copied into ``vec``, then the step. Returns (next tokens
        [b] int32, logits [b, padded_vocab] fp32) on the home entry."""
        self.mesh.require_runnable("MeshServeStep")
        self.vec.copy_(torch.from_numpy(np.asarray(host_vec, np.int32)))
        nxt, _, logits = self._step_fn(self.params, self.state, self.inputs)
        return nxt, logits


def lower_serve_step(cfg: ModelConfig, shape, params: dict, mesh=None, *,
                     device=None):
    """The port's counterpart of the reference's ``lower_serve_step``: the
    decode step for ``shape.global_batch`` slots of ``shape.seq_len``
    tokens, on zeroed state and static inputs. Without a mesh it is
    captured as one CUDA graph on the card (on the CPU the step body, run
    eagerly when called); ``params`` must be on ``device`` (None: the
    card). Over a ``mesh`` it is a :class:`MeshServeStep` (``params``
    placed by ``SERVE_PARAM_RULES``, or whole, and then placed by it, as
    the reference's ``in_shardings`` place them; over the production
    mesh's ``meta`` plan, shapes and specs only, and ``params`` may be
    None). Returns
    ``(step, extra)``: the step (write its ``state`` and its ``pt`` /
    ``write_rows`` inputs in place, then call it with a round's tokens,
    lengths and write offsets) and the paged geometry the reference
    reports."""
    geom = plan_geometry(
        batch=shape.global_batch, seq_len=shape.seq_len,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, q_heads=cfg.n_heads,
        mesh=mesh)
    extra = {"paged_geom": {
        "block": geom.block, "nblk": geom.nblk, "cap": geom.cap,
        "batch_axes": geom.batch_axes, "head_axes": geom.head_axes,
        "stripe_axes": geom.stripe_axes}}
    if mesh is not None:
        return MeshServeStep(cfg, geom, params, mesh), extra
    dev = resolve_device(device)
    state = init_serve_state(cfg, geom, geom.cap, dev)
    step = ServeGraph(cfg, geom, params, state, geom.cap, dev)
    if dev.type == "cuda":
        step.capture()
    return step, extra


# ================================================================ host side
@dataclasses.dataclass
class Request:
    seq_id: int
    user_id: int
    slot: int
    tokens: list
    generated: list


class ServeEngine:
    """Continuous-batching engine on one device.

    The KV metadata lives in a real SQLCached table on the same device:
    allocation is INSERT, the page table is maintained from the row ids
    the INSERTs report (and rebuilt from the columns after a DELETE), and
    every fine-grained expiry path is SQL (the paper's Table 2
    operations). ``device=None`` means the CUDA card; pass ``"cpu"`` to
    run every kernel's plain version on the CPU."""

    def __init__(self, cfg: ModelConfig, params: dict, *, max_slots: int = 8,
                 max_seq: int = 256, block: int = 16, slack: float = 1.25,
                 device=None):
        TF.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.geom = plan_geometry(
            batch=max_slots, seq_len=max_seq, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, q_heads=cfg.n_heads, block=block)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.block = block
        cap = int(self.geom.cap * slack)
        self.daemon = SQLCached(device=self.device)
        self.daemon.execute(
            "CREATE TABLE kv (slot INT, seq_id INT, user_id INT, "
            "pos_block INT, prefix_hash INT) "
            f"CAPACITY {cap} MAX_SELECT 256")
        self.cap = cap
        self.state = init_serve_state(cfg, self.geom, cap, self.device)
        # the round over static buffers (captured at the first round on
        # the card); the page table (cap = missing) and each slot's tail
        # row are views of them, maintained in place from the row ids each
        # INSERT reports
        self._step = ServeGraph(cfg, self.geom, params, self.state, cap,
                                self.device)
        self.requests: dict[int, Request] = {}   # slot -> request
        self.lengths = np.zeros(max_slots, np.int32)
        self._sch = self.daemon.schema("kv")
        self.attends = has_attention(cfg)
        if self.attends:
            self._pt = self._step.inputs["pt"][:, 0]
            self.tail_row = self._step.inputs["write_rows"][:, 0]
        else:   # kept as the reference keeps them; no step reads them
            self._pt = torch.full((max_slots, self.geom.nblk), cap,
                                  dtype=torch.int32, device=self.device)
            self.tail_row = torch.full((max_slots,), -1, dtype=torch.int32,
                                       device=self.device)
        self._next_seq = 1
        self.decode_steps = 0
        # the last prefill's logits (a device tensor; reading it is the
        # caller's sync) and the last round's, in the round's output buffer
        self.prefill_logits: torch.Tensor | None = None
        self._round_logits: torch.Tensor | None = None
        self._logits: torch.Tensor | None = None

    @property
    def logits(self) -> torch.Tensor | None:
        """The last round's logits [max_slots, padded_vocab] (fp32), a
        tensor the caller may keep: copied out of the round's output buffer
        at the first read after the round (the next replay overwrites that
        buffer)."""
        if self._logits is None and self._round_logits is not None:
            self._logits = self._round_logits.clone()
        return self._logits

    # ------------------------------------------------------------ plumbing
    def _free_slot(self) -> int:
        for s in range(self.max_slots):
            if s not in self.requests:
                return s
        raise RuntimeError("no free slot")

    def _insert_blocks(self, slot, seq_id, user_id, pos_blocks,
                       hashes=None) -> torch.Tensor:
        """Sync-free block allocation: one micro-batched INSERT, device row
        ids out, incremental page-table maintenance."""
        params_list = []
        for i, pb in enumerate(pos_blocks):
            h = int(hashes[i]) if hashes is not None else 0
            params_list.append((slot, seq_id, user_id, int(pb), h))
        res = self.daemon.executemany(
            "INSERT INTO kv (slot, seq_id, user_id, pos_block, prefix_hash)"
            " VALUES (?, ?, ?, ?, ?)", params_list)
        rows = res.row_ids_device[: len(params_list)]
        self._pt.copy_(kvpool.page_table_insert(
            self._sch, self.daemon.table_state("kv"), self._pt, rows,
            res.value_device, max_slots=self.max_slots,
            max_blocks=self.geom.nblk))
        return rows

    def _blockify(self, k: torch.Tensor, v: torch.Tensor,
                  nblk: int) -> torch.Tensor:
        """k/v [L, 1, s, kh, hd] -> [L, nblk, 2, block, kh, hd]
        (zero-padded to whole blocks)."""
        L, _, s, kh, hd = k.shape
        kv = torch.zeros((L, nblk * self.block, 2, kh, hd), dtype=k.dtype,
                         device=k.device)
        kv[:, :s, 0] = k[:, 0]
        kv[:, :s, 1] = v[:, 0]
        return kv.reshape(L, nblk, self.block, 2, kh, hd).transpose(2, 3)

    # ------------------------------------------------------------- publics
    def add_request(self, prompt_tokens, *, user_id: int = 0,
                    extras: dict | None = None) -> int:
        """Prefill a prompt into a fresh slot. ``extras``: host arrays of
        one request (``frontend`` / ``enc_frames``, module docstring).
        Returns the slot id."""
        cfg = self.cfg
        slot = self._free_slot()
        seq_id = self._next_seq
        self._next_seq += 1
        toks = np.asarray(prompt_tokens, np.int32)
        n = len(toks)
        batch = {"tokens": T.to_device(toks[None], self.device)}
        for k, v in (extras or {}).items():
            batch[k] = T.to_device(np.asarray(v)[None], self.device)
        logits, cache = TF.prefill(self.params, cfg, batch)
        total = n + (cfg.frontend_len if cfg.frontend == "vision"
                     and extras and "frontend" in extras else 0)
        if self.attends:
            self._install_kv(slot, seq_id, user_id, toks, total, cache)
        for name, t in cache.get("ssm", {}).items():
            self.state["ssm"][name][:, slot] = t[:, 0]
        for name in ("enc_k", "enc_v"):
            if name in cache:   # into the static state the graph reads
                self.state[name][:, slot].copy_(cache[name][:, 0])
        self.lengths[slot] = total
        self.prefill_logits = logits[0]
        first = int(torch.argmax(logits[0]))
        self.requests[slot] = Request(seq_id, user_id, slot, list(toks),
                                      [first])
        return slot

    def _install_kv(self, slot, seq_id, user_id, toks, total, cache) -> None:
        """A prefill's blocks (``total`` positions: the frontend's and the
        prompt's): one INSERT, then its K/V into the arenas at the rows
        the INSERT reports. As in the reference, the prefix hashes are of
        the prompt's tokens alone, zero-padded to the blocks of
        ``total``, and only for a prompt of a block or more."""
        n = len(toks)
        nblk = -(-total // self.block)
        pad = nblk * self.block
        hashes = None
        if n >= self.block:  # on the host: the prompt is host data
            hashes = kvpool.rolling_prefix_hashes(
                torch.from_numpy(np.pad(toks, (0, pad - n))),
                self.block).numpy()
        rows = self._insert_blocks(slot, seq_id, user_id, list(range(nblk)),
                                   hashes)
        self.tail_row[slot] = rows[-1]
        for arena, k, v in (("arena", "k", "v"),
                            ("shared_arena", "shared_k", "shared_v")):
            if k in cache:
                kv = self._blockify(cache[k], cache[v], nblk)
                if self.cfg.kv_quant_int8:
                    # one quantizing pass on the device (the reference's
                    # install_q): per token, k/v and kv head
                    kv, sc = quantize_kv(kv)
                    self.state[arena + "_scale"][:, rows.long()] = sc
                self.state[arena][:, rows.long()] = kv

    def _build_inputs(self) -> np.ndarray:
        """The round's tokens, lengths and write offsets ([3, b] int32,
        staged into the graph's ``vec`` by the step); the write row of
        each slot at a block boundary is allocated here (where the stack
        attends), its device row id flowing straight into the page table
        and the tail rows."""
        vec = np.zeros((3, self.max_slots), np.int32)
        for s, r in self.requests.items():
            vec[0, s] = r.generated[-1]
            vec[1, s] = self.lengths[s]
        vec[2] = vec[1] % self.block
        for s, r in (self.requests.items() if self.attends else ()):
            if self.lengths[s] % self.block == 0:
                rows = self._insert_blocks(
                    s, r.seq_id, r.user_id,
                    [self.lengths[s] // self.block])
                self.tail_row[s] = rows[-1]
        return vec

    def decode_round(self) -> dict[int, int]:
        """One token for every active request. Returns {slot: token}."""
        if not self.requests:
            return {}
        nxt, self._round_logits = self._step(self._build_inputs())
        self._logits = None
        nxt = nxt.cpu().numpy()
        out = {}
        for s, r in self.requests.items():
            # the token decoded THIS round extends the sequence; the model
            # consumed r.generated[-1] at position lengths[s]
            self.lengths[s] += 1
            tok = int(nxt[s])
            r.generated.append(tok)
            out[s] = tok
        self.decode_steps += 1
        return out

    # ------------------------------------------- fine-grained expiry (SQL)
    def _apply_delete(self, res) -> None:
        """Page-table removal after a DELETE: incremental from the row ids
        when the statement reported all of them, else a rebuild from the
        columns (the ``kv`` table has no payload, so its DELETEs report a
        count only and take the rebuild, as in the reference)."""
        ts = self.daemon.table_state("kv")
        ids = res.row_ids_device
        if ids is not None and res.count <= int(ids.shape[0]):
            pt = kvpool.page_table_delete(
                self._sch, ts, self._pt, ids, res.present_device,
                max_slots=self.max_slots, max_blocks=self.geom.nblk)
        else:
            pt = kvpool.page_table(self._sch, ts, max_slots=self.max_slots,
                                   max_blocks=self.geom.nblk)
        self._pt.copy_(pt)

    def finish_request(self, slot: int) -> int:
        """Paper Table 2 'single page': expire one request's blocks."""
        r = self.requests.pop(slot)
        res = self.daemon.execute("DELETE FROM kv WHERE seq_id = ?",
                                  (r.seq_id,))
        self._apply_delete(res)
        self.lengths[slot] = 0
        self.tail_row[slot].fill_(-1)
        return res.count

    def evict_user(self, user_id: int) -> int:
        """Paper Table 2 'single user': end every session of one user."""
        res = self.daemon.execute("DELETE FROM kv WHERE user_id = ?",
                                  (user_id,))
        self._apply_delete(res)
        for s in [s for s, r in self.requests.items()
                  if r.user_id == user_id]:
            self.requests.pop(s)
            self.lengths[s] = 0
            self.tail_row[s].fill_(-1)
        return res.count

    def flush(self) -> int:
        """The memcached way: everything goes (and every active request
        must re-prefill: the paper's load-spike scenario)."""
        res = self.daemon.execute("FLUSH kv")
        self.requests.clear()
        self.lengths[:] = 0
        self.tail_row.fill_(-1)
        self._pt.fill_(self.cap)
        return res.count

    def live_blocks(self) -> int:
        return self.daemon.live_rows("kv")
