"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2 backbone.
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821].
The vision frontend is a stub: a request carries precomputed patch
embeddings (``batch["frontend"]``, ``frontend_len`` of them)."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    vocab_pad_to=256,           # 151655 -> 151808 (16-way shardable)
    rope_theta=1e6,             # InternLM2 long-context base
    frontend="vision",
    frontend_len=256,           # ViT patch embeddings, precomputed
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=14,                 # keep the odd head count (divisibility bugs)
    n_kv_heads=2,
    head_dim=8,
    d_ff=96,
    vocab=503,
    vocab_pad_to=64,
    rope_theta=1e6,
    frontend="vision",
    frontend_len=8,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
