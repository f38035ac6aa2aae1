from repro_torch.kernels.quantize import ops, ref
from repro_torch.kernels.quantize.ops import quantize_edits

__all__ = ["ops", "ref", "quantize_edits"]
