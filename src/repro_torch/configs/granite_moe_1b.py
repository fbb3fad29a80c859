"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    vocab_pad_to=256,           # -> 49408
    n_experts=32,
    top_k=8,
    rope_theta=1e4,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=16,
    n_kv_heads=8,
    head_dim=8,
    d_ff=32,
    vocab=499,
    vocab_pad_to=64,
    n_experts=4,
    top_k=2,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
