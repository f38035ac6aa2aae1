"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias [arXiv:2407.10671; hf].

A copy of ``repro/configs/qwen2_7b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab=256,
    dtype="float32",
)
