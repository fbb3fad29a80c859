"""seamless-m4t-large-v2 [audio] — enc-dec transformer backbone, 24 encoder
+ 24 decoder layers, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206
[arXiv:2308.11596]. The audio frontend is a stub: a request carries
precomputed frame embeddings (``batch["enc_frames"]``, ``frontend_len``
of them) for the encoder. Plain (non-gated) FFN, NLLB-style."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                # decoder layers
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    vocab_pad_to=256,           # -> 256256
    mlp_gated=False,
    mlp_act="relu",
    frontend="audio",
    frontend_len=1024,          # precomputed speech frames
    rope_theta=1e4,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke",
    family="encdec",
    n_layers=2,
    enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab=503,
    vocab_pad_to=64,
    mlp_gated=False,
    mlp_act="relu",
    frontend="audio",
    frontend_len=8,
    dtype=torch.float32,
    q_block=16,
    kv_block=16,
    loss_block=16,
)
