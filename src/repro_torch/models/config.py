"""Unified model configuration covering all five assigned families (port
of ``repro.models.config``; ``dtype`` is a ``torch.dtype``).

One frozen dataclass drives dense, MoE, SSM (Mamba1/2), hybrid and
encoder-decoder architectures. Per-layer heterogeneity (sliding-window vs
global attention, Mamba blocks, shared-block applications) is expressed as
a ``layer_pattern`` of layer kinds plus per-layer *data* (window size,
rope theta) so that structurally identical layers can be stacked and
scanned (scan-over-layers is what keeps 62-layer models compilable and
remat-friendly at 512 devices).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# layer kinds
GLOBAL = "global"      # full causal attention
LOCAL = "local"        # sliding-window attention
MAMBA1 = "mamba1"      # selective-scan SSM block
MAMBA2 = "mamba2"      # SSD block (headed, scalar decay)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- attention options
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0   # 0 -> same as rope_theta (gemma3 uses 1e6)
    window: int = 0                  # sliding-window size for LOCAL layers
    layer_pattern: tuple[str, ...] = ()  # len n_layers; () -> all GLOBAL
    attn_softcap: float = 0.0        # gemma2: 50.0
    logit_softcap: float = 0.0       # gemma2: 30.0
    qk_norm: bool = False            # gemma3
    attn_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    sandwich_norm: bool = False      # gemma2/3: post-attn & post-mlp norms
    # §Perf lever: shard attention over the SEQUENCE on 'model' (shard_map
    # island). For archs whose head counts do not divide the model axis
    # (36H/4kv etc.) GSPMD otherwise replicates the whole attention 16x.
    attn_seq_shard: bool = False
    # §Perf lever: int8 KV arena with per-token-slot scales (serving).
    # Halves pool bytes + decode gather traffic; scales cost ~2%.
    kv_quant_int8: bool = False

    # --- mlp
    mlp_gated: bool = True           # SwiGLU/GeGLU vs plain
    mlp_act: str = "silu"            # silu | gelu

    # --- moe
    n_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01

    # --- ssm
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64           # mamba2
    ssm_dt_rank: int = 0             # mamba1 (0 -> d_model // 16)

    # --- hybrid (zamba2): apply ONE shared attention block every k layers
    shared_attn_every: int = 0       # 0 = no shared block

    # --- scan-over-layers: repeating pattern-unit length (group scan).
    # gemma2: 2 (L,G); gemma3: 6 (5L+G); zamba2: shared_attn_every; else 1.
    scan_group: int = 1

    # --- encoder-decoder
    enc_layers: int = 0              # >0 -> enc-dec; n_layers = decoder layers

    # --- embeddings / frontend
    vocab_pad_to: int = 128          # pad embed table for even vocab sharding
    frontend: str = "none"           # none | vision | audio (stub embeddings)
    frontend_len: int = 256          # number of stub frontend positions
    tie_embeddings: bool = True
    scale_embeddings: bool = False   # gemma: embed * sqrt(d_model)

    # --- misc
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # attention chunking for the flash-style reference path
    q_block: int = 512
    kv_block: int = 1024
    # SSD chunk length
    ssm_chunk: int = 256
    # chunked-vocab loss block
    loss_block: int = 1024

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", (GLOBAL,) * self.n_layers)
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError("layer_pattern length != n_layers")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.family} config needs ssm_state > 0")
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", max(1, self.d_model // 16))

    # ----------------------------------------------------------- helpers
    @property
    def padded_vocab(self) -> int:
        p = max(self.vocab_pad_to, 1)
        return -(-self.vocab // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_layer_ids(self) -> tuple[int, ...]:
        return tuple(
            i for i, k in enumerate(self.layer_pattern) if k in (GLOBAL, LOCAL)
        )

    @property
    def ssm_layer_ids(self) -> tuple[int, ...]:
        return tuple(
            i for i, k in enumerate(self.layer_pattern) if k in (MAMBA1, MAMBA2)
        )

    @property
    def uniform_kind(self) -> str | None:
        kinds = set(self.layer_pattern)
        return next(iter(kinds)) if len(kinds) == 1 else None

    def layer_windows(self) -> tuple[int, ...]:
        """Per-layer window size (0 = global) — per-layer DATA for the scan."""
        return tuple(
            self.window if k == LOCAL else 0 for k in self.layer_pattern
        )

    def layer_thetas(self) -> tuple[float, ...]:
        tg = self.rope_theta_global or self.rope_theta
        return tuple(
            tg if k == GLOBAL else self.rope_theta for k in self.layer_pattern
        )

    def n_shared_applications(self) -> int:
        if self.shared_attn_every <= 0:
            return 0
        return len(
            [i for i in range(self.n_layers)
             if (i + 1) % self.shared_attn_every == 0]
        )

    def shared_app_index(self) -> tuple[int, ...]:
        """For each layer: index of the shared-attn application that follows
        it, or -1. (zamba2's single shared block, applied periodically.)"""
        out, k = [], 0
        for i in range(self.n_layers):
            if self.shared_attn_every > 0 and (i + 1) % self.shared_attn_every == 0:
                out.append(k)
                k += 1
            else:
                out.append(-1)
        return tuple(out)

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp_in = 2 * d * self.d_ff if self.mlp_gated else d * self.d_ff
        mlp = mlp_in + self.d_ff * d
        if self.is_moe:
            mlp = mlp * self.n_experts + d * self.n_experts
        di, st = self.d_inner, self.ssm_state
        if self.uniform_kind == MAMBA1 or MAMBA1 in self.layer_pattern:
            ssm = (d * 2 * di + di * self.ssm_conv
                   + di * (self.ssm_dt_rank + 2 * st)
                   + self.ssm_dt_rank * di + di * st + di + di * d)
        else:  # mamba2
            nh = self.ssm_heads
            conv_dim = di + 2 * st  # conv over x,B,C (grouped)
            ssm = (d * (2 * di + 2 * st + nh) + conv_dim * self.ssm_conv
                   + nh + nh + di * d + di)
        per_layer = {
            GLOBAL: attn + mlp, LOCAL: attn + mlp,
            # zamba2-style hybrids put the MLP in the *shared* block only
            MAMBA1: ssm, MAMBA2: ssm,
        }
        n += sum(per_layer[k] for k in self.layer_pattern)
        if self.shared_attn_every > 0:
            n += attn + mlp  # the single shared block
        if self.is_encdec:
            # encoder self-attn+mlp, decoder cross-attn already in n_layers?
            n += self.enc_layers * (attn + mlp)
            n += self.n_layers * attn  # cross-attention blocks
        n += 2 * d  # final norm etc. (negligible)
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        mlp_in = 2 * d * self.d_ff if self.mlp_gated else d * self.d_ff
        mlp = mlp_in + self.d_ff * d
        full = self.param_count()
        inactive = self.n_layers * mlp * (self.n_experts - self.top_k)
        return int(full - inactive)


def pattern_local_global(n_layers: int, locals_per_global: int) -> tuple[str, ...]:
    """gemma3-style: (L L L L L G) repeating; gemma2: alternating (1:1)."""
    out = []
    for i in range(n_layers):
        if (i + 1) % (locals_per_global + 1) == 0:
            out.append(GLOBAL)
        else:
            out.append(LOCAL)
    return tuple(out)


class NotPorted(ValueError):
    """A configuration, option or path that the reference supports and this
    port does not run yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not supported by this port yet")
