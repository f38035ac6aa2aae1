"""Distribution over ``torch.distributed``: the pencil-decomposed rFFT
(``dist_fft``), the LM's partition rules (``rules``), tensor and expert
parallelism over a mesh's "model" axis (``tp``), fully sharded data
parallelism with them (``fsdp``) and GPipe over a "pipe" axis
(``pipeline``).

The reference's ``shardmap.py`` is a JAX-version shim with no counterpart.
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
from repro_torch.sharding.pipeline import bubble_fraction, pipeline_apply

__all__ = [
    "DistSpec",
    "ShardedField",
    "classify_parity",
    "default_mesh",
    "pencil_rfftn",
    "pencil_irfftn",
    "validate_pencil_shape",
    "pipeline_apply",
    "bubble_fraction",
]
