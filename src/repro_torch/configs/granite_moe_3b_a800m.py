"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

A copy of ``repro/configs/granite_moe_3b_a800m.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=40,
    top_k=8,
    moe_every=1,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab=256,
    n_experts=4,
    top_k=2,
    dtype="float32",
)
