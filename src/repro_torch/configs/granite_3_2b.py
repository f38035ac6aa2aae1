"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

A copy of ``repro/configs/granite_3_2b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    head_dim=64,
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
