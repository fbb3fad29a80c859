"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, Mamba1 architecture [arXiv:2410.05355]."""
import torch

from repro_torch.models.config import MAMBA1, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    vocab_pad_to=256,           # already 254*256
    layer_pattern=(MAMBA1,) * 64,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,               # d_inner = 8192
    ssm_dt_rank=256,            # 4096 // 16
    ssm_chunk=256,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=499,
    vocab_pad_to=64,
    layer_pattern=(MAMBA1,) * 2,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=8,
    dtype=torch.float32,
    loss_block=16,
)
