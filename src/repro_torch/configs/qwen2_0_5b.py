"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA with QKV bias [arXiv:2407.10671; hf].  A copy of
``repro/configs/qwen2_0_5b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    dtype="float32",
)
