"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, alternating local/global attention, attn softcap 50,
logit softcap 30, head_dim=256 [arXiv:2408.00118]."""
import torch

from repro_torch.models.config import ModelConfig, pattern_local_global

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    vocab_pad_to=256,
    layer_pattern=pattern_local_global(26, 1),  # alternating (L, G) x 13
    scan_group=2,
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    scale_embeddings=True,
    rope_theta=1e4,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=499,
    vocab_pad_to=64,
    layer_pattern=pattern_local_global(4, 1),
    scan_group=2,
    window=8,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    scale_embeddings=True,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
