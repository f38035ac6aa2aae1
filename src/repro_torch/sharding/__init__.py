"""Distribution over ``torch.distributed``: the pencil-decomposed rFFT
(``dist_fft``), the LM's partition rules (``rules``), tensor and expert
parallelism over a mesh's "model" axis (``tp``) and fully sharded data
parallelism with them (``fsdp``).

The reference's ``sharding/pipeline.py`` (GPipe) is not ported yet
(ROADMAP.md Queue 1); ``shardmap.py`` is a JAX-version shim.
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
