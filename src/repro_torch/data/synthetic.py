"""Deterministic, shardable, resumable synthetic token pipeline (port of
``repro.data.synthetic``; numpy, so its batches are bit-equal to the
reference's for the same ``(seed, step, shard)``).

Every batch is a pure function of (seed, step, shard): a preempted job
resumes mid-epoch exactly. Tokens follow a Zipf-ish mixture so the loss
curve is non-trivial; labels are next-token shifted.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.shapes import token_split
from repro_torch.models.config import ModelConfig


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def _tokens(rng, shape, vocab: int) -> np.ndarray:
    """Zipf-mixture token stream (bounded to vocab)."""
    z = rng.zipf(1.3, size=shape).astype(np.int64)
    u = rng.integers(0, vocab, size=shape)
    pick = rng.random(shape) < 0.5
    t = np.where(pick, np.minimum(z, vocab - 1), u)
    return t.astype(np.int32)


def make_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
               step: int = 0, shard: int = 0) -> dict:
    """One training batch matching ``train_specs(cfg)``'s layouts (numpy)."""
    rng = _rng(seed, step, shard)
    fl, st = token_split(cfg, seq)
    if cfg.is_encdec:
        fl, st = 0, seq
    stream = _tokens(rng, (batch, st + 1), cfg.vocab)
    tokens = stream[:, :-1]
    text_labels = stream[:, 1:]
    labels = np.zeros((batch, seq), dtype=np.int32)
    mask = np.zeros((batch, seq), dtype=np.float32)
    labels[:, fl:] = text_labels
    mask[:, fl:] = 1.0
    out = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    if fl:
        out["frontend"] = rng.standard_normal(
            (batch, fl, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.is_encdec:
        el = cfg.frontend_len
        out["enc_frames"] = rng.standard_normal(
            (batch, el, cfg.d_model)).astype(np.float32) * 0.02
    return out


@dataclasses.dataclass
class SyntheticDataset:
    """Step-indexed dataset: ``batch_at(step)`` is stateless and resumes
    exactly. ``shard`` / ``num_shards`` split the global batch (each host
    makes only its rows)."""

    cfg: ModelConfig
    global_batch: int
    seq: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_shards} shards")

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def batch_at(self, step: int) -> dict:
        return make_batch(self.cfg, self.local_batch, self.seq,
                          seed=self.seed, step=step, shard=self.shard)
