from repro_torch.kernels.block_transform import ops, ref
from repro_torch.kernels.block_transform.ops import block_transform_quantize

__all__ = ["ops", "ref", "block_transform_quantize"]
