"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    vocab_pad_to=256,           # -> 32256
    n_experts=16,
    top_k=2,
    rope_theta=1e4,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=48,
    vocab=512,
    vocab_pad_to=64,
    n_experts=4,
    top_k=2,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
