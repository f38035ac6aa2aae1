"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32 => MHA) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + weight-SHARED attention block
every 6 core layers, fed concat(hidden, embedding) [arXiv:2411.15242;
unverified].

Hybrid family: decode state = SSM states + KV only at shared-attn
invocations => long_500k runs.

A copy of ``repro/configs/zamba2_7b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_kernel=4,
    attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=32,
    attn_every=2,
    dtype="float32",
)
