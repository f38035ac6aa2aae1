"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1, interleaved dense/MoE layers with a
shared expert [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

A copy of ``repro/configs/llama4_maverick_400b_a17b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    n_experts=128,
    top_k=1,
    moe_every=2,  # alternating dense / MoE
    shared_expert=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    n_experts=8,
    top_k=1,
    dtype="float32",
)
