"""Data layer: deterministic sharded token pipeline + synthetic science fields."""

from repro_torch.data.fields import make_field
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TokenPipeline", "make_field"]
