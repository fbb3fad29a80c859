"""Assigned input shapes and per-(arch x shape) input specs (port of
``repro.configs.shapes``).

The specs are ``device="meta"`` tensors: shapes and dtypes with no
storage, the counterpart of the reference's ``jax.ShapeDtypeStruct``.
LM shapes are seq_len x global_batch; decode_* / long_* describe one
token against a seq_len cache, not a training step.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM / hybrid archs (O(1)
# state decode) take it
_LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.family in _LONG_OK_FAMILIES
    return True


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if applicable(cfg, shape):
        return None
    return (f"{cfg.name} is pure full-attention ({cfg.family}); 500k-token "
            "decode requires sub-quadratic attention (DESIGN.md §4)")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_split(cfg: ModelConfig, seq_len: int) -> tuple[int, int]:
    """(frontend_len, text_len) for decoder inputs of total length seq."""
    if cfg.frontend == "vision":
        fl = min(cfg.frontend_len, seq_len // 2)
        return fl, seq_len - fl
    return 0, seq_len


def train_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    fl, st = token_split(cfg, s)
    specs = {
        "tokens": _spec((b, st), torch.int32),
        "labels": _spec((b, s), torch.int32),
        "loss_mask": _spec((b, s), torch.float32),
    }
    if fl:
        specs["frontend"] = _spec((b, fl, cfg.d_model), cfg.dtype)
    if cfg.is_encdec:
        specs["enc_frames"] = _spec((b, cfg.frontend_len, cfg.d_model),
                                    cfg.dtype)
        specs["tokens"] = _spec((b, s), torch.int32)  # decoder tokens, full s
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    specs = train_specs(cfg, shape)
    specs.pop("labels")
    specs.pop("loss_mask")
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """One new token against a cache of ``seq_len`` tokens."""
    b = shape.global_batch
    return {"tokens": _spec((b,), torch.int32),
            "lengths": _spec((b,), torch.int32)}
