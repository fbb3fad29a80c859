"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE, plain GELU FFN [arXiv:2402.19173]."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    vocab_pad_to=256,           # already 192*256
    mlp_gated=False,
    mlp_act="gelu",
    rope_theta=1e5,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=36,                 # keep the 36-head oddity
    n_kv_heads=4,
    head_dim=4,
    d_ff=128,
    vocab=512,
    vocab_pad_to=64,
    mlp_gated=False,
    mlp_act="gelu",
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
