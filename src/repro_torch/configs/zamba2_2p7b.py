"""zamba2-2.7b [hybrid] — 54L Mamba2 backbone, d_model=2560, one SHARED
attention+MLP block (32H GQA kv=32, d_ff=10240) applied every 6 layers,
vocab=32000, ssm_state=64 [arXiv:2411.15242]."""
import torch

from repro_torch.models.config import MAMBA2, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,                 # shared block MLP
    vocab=32000,
    vocab_pad_to=256,           # already 125*256
    layer_pattern=(MAMBA2,) * 54,
    shared_attn_every=6,        # 9 applications of the shared block
    scan_group=6,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,               # d_inner = 5120
    ssm_head_dim=64,            # 80 SSD heads
    ssm_chunk=256,
    rope_theta=1e4,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab=499,
    vocab_pad_to=64,
    layer_pattern=(MAMBA2,) * 4,
    shared_attn_every=2,
    scan_group=2,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
