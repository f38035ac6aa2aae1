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


def launch_counters():
    """Every kernel wrapper's ``launches`` dict."""
    from repro_torch.kernels.block_transform import ops as bt_ops
    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.quantize import ops as quantize_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    return (scube_ops.launches, fcube_ops.launches, rfft_ops.launches, flash_ops.launches,
            quantize_ops.launches, bt_ops.launches)
