"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*d_model = 5120, headdim 64 => 80 SSD heads.  O(1) decode state,
so the long_500k cell runs natively (no KV cache).

A copy of ``repro/configs/mamba2_2_7b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_kernel=4,
    pos_type="none",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=32,
    vocab=256,
    dtype="float32",
)
