"""Checkpointing: atomic, optionally FFCz-compressed, in the reference's layout."""

from repro_torch.checkpoint.codec import CheckpointCodec
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "CheckpointCodec"]
