"""Optimizers + FFCz-compressed gradients."""

from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad_compress import compress_gradients, compress_sharded_gradients, compressed_psum

__all__ = ["AdamW", "compress_gradients", "compress_sharded_gradients", "compressed_psum"]
