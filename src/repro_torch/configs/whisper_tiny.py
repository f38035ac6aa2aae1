"""whisper-tiny [audio] — 4L d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865 —
encoder-decoder, conv frontend stub [arXiv:2212.04356; unverified].

The batch carries precomputed mel-frame embeddings (1500 frames after the
conv downsampling, d=384); 4 encoder + 4 decoder layers with
cross-attention.  Whisper uses sinusoidal absolute positions, not RoPE.  A
copy of ``repro/configs/whisper_tiny.py``.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    encoder_layers=4,
    encoder_seq=1500,
    pos_type="sinusoidal",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    encoder_layers=2,
    encoder_seq=32,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    dtype="float32",
)
