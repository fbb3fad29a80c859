"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA with SwiGLU [arXiv:2403.04652]."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    vocab_pad_to=256,           # already 250*256
    rope_theta=5e6,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=4,
    head_dim=8,
    d_ff=96,
    vocab=500,
    vocab_pad_to=64,
    rope_theta=5e6,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
