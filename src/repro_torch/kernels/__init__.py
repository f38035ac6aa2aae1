"""The port's kernels: CUDA C++ for Hopper, each beside a plain twin.

Every ``<name>/ops.py`` holds one wrapper per kernel and the plain PyTorch
function it is held against (in ``ops.py`` or ``ref.py``).  A wrapper given
CPU tensors computes the plain version; given CUDA tensors it launches the
kernel (built from ``csrc/`` by :mod:`repro_torch.kernels.build`) or raises —
there is no fallback.  Each wrapper counts its kernel launches in a
module-level ``launches`` dict.

  scube, fcube, rfft  the POCS loop's fused projections (whole field, and
                      per pencil for the batched loop)
  quantize            QuantizeEdits: int32 codes and nonzero flags
  block_transform     the zfplike blockwise transform fused with its quantizer
  flash_attention     causal GQA flash attention (the LM's attention)
"""

from repro_torch.kernels.block_transform.ops import block_transform_quantize
from repro_torch.kernels.quantize.ops import quantize_edits

__all__ = ["block_transform_quantize", "quantize_edits"]
