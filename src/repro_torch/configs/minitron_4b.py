"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron [arXiv:2407.14679; hf].  The 256k vocabulary makes the
embedding/LM head the dominant tensor — vocab-sharded on the model axis.

A copy of ``repro/configs/minitron_4b.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    dtype="float32",
)
