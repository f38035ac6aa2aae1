"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

The vision frontend is a stub: the batch carries precomputed patch
embeddings (anyres base 576 + 4 tiles = 2880 tokens, CLIP-L dim 1024); the
in-model part is the 2-layer MLP projector + the Mistral-7B backbone.  A
copy of ``repro/configs/llava_next_mistral_7b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    vision_tokens=2880,
    vision_dim=1024,
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
    vision_tokens=16,
    vision_dim=32,
    dtype="float32",
)
