"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global attention, 128k context, QK-norm,
sandwich norms, head_dim=128 [hf:google/gemma-3]."""
import torch

from repro_torch.models.config import ModelConfig, pattern_local_global

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,               # decoupled from d_model/n_heads
    d_ff=21504,
    vocab=262144,
    vocab_pad_to=256,
    layer_pattern=pattern_local_global(62, 5),  # (5L + G) x 10, tail LL
    scan_group=6,
    window=1024,
    rope_theta=1e4,             # local layers
    rope_theta_global=1e6,      # global layers
    qk_norm=True,
    sandwich_norm=True,
    scale_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke",
    family="dense",
    n_layers=8,                 # one full (5L+G) unit + LL tail
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=499,
    vocab_pad_to=64,
    layer_pattern=pattern_local_global(8, 5),
    scan_group=6,
    window=8,
    rope_theta=1e4,
    rope_theta_global=1e6,
    qk_norm=True,
    sandwich_norm=True,
    scale_embeddings=True,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
