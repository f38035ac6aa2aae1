"""The pencil-decomposed distributed rFFT over ``torch.distributed``.

The reference's ``repro.sharding`` also holds the LM's partition rules
(``rules.py``, ``pipeline.py``); those belong to the mesh half of the trainer
(ROADMAP.md Queue 1, item 5d) and are not ported yet.
"""

from repro_torch.sharding.dist_fft import (
    DistSpec,
    ShardedField,
    classify_parity,
    default_mesh,
    pencil_irfftn,
    pencil_rfftn,
    validate_pencil_shape,
)

__all__ = [
    "DistSpec",
    "ShardedField",
    "classify_parity",
    "default_mesh",
    "pencil_rfftn",
    "pencil_irfftn",
    "validate_pencil_shape",
]
