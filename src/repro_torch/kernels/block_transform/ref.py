"""Plain PyTorch twin of the block-transform kernel (``csrc/block_transform.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.quantize.ref import saturating_int32


def block_transform_quantize_ref(blocks: torch.Tensor, matrix: torch.Tensor, q) -> torch.Tensor:
    """``rint((blocks @ matrix.T) / q)`` as int32, in the kernel's order.

    The product is summed over ``k = 0 .. B-1`` in order, one rounded
    multiply and one rounded add per step (no fused multiply-add, no TF32),
    then divided by ``q`` (a float32 tensor on the blocks' device: IEEE
    division, not a host scalar's reciprocal), rounded half to even and
    cast with saturation (:func:`saturating_int32`).
    """
    x = blocks.to(torch.float32)
    mat = torch.as_tensor(matrix, dtype=torch.float32, device=x.device)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k, None] * mat[None, :, k]
    qt = torch.tensor(float(q), dtype=torch.float32, device=x.device)
    return saturating_int32(torch.round(acc / qt))
