"""Blockwise decorrelating transform + quantize: CUDA kernel wrapper + twin.

Replaces ``repro/kernels/block_transform`` (the ``_bt_kernel`` Pallas kernel
and its ``block_transform_quantize`` wrapper).  The kernel is
``csrc/block_transform.cu``; its twin is
:func:`ref.block_transform_quantize_ref`.  The reference's ``block_rows`` and
``interpret`` arguments tile and emulate the TPU kernel; they are accepted
for signature compatibility and ignored (the kernel masks its ragged last
tile itself, so nothing is padded).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_transform.ref import block_transform_quantize_ref

#: kernel launches by wrapper (reset it to 0 to count a run's launches)
launches = {"block_transform": 0}

#: block sizes B the kernel is instantiated for (4^2, 2 x 4^2, 4^3, 2 x 4^3)
BLOCK_SIZES = (16, 32, 64, 128)


def block_transform_quantize(
    blocks: torch.Tensor,
    matrix: torch.Tensor,
    q: float,
    block_rows: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """``(nb, B)`` blocks -> int32 codes ``rint((blocks @ matrix.T) / q)``.

    CPU tensors take :func:`block_transform_quantize_ref`; CUDA tensors
    launch the kernel (float32 after a cast, B in :data:`BLOCK_SIZES`) or
    raise.  The kernel fills its tiles with bulk copies, which need a
    16-byte aligned source: a view whose first element is not aligned (an
    odd storage offset) goes to the kernel as an aligned contiguous copy.
    ``block_rows`` and ``interpret`` are ignored (module docstring).
    """
    del block_rows, interpret
    if blocks.ndim != 2 or tuple(matrix.shape) != (blocks.shape[1],) * 2:
        raise ValueError(f"need (nb, B) blocks and a (B, B) matrix, got {tuple(blocks.shape)} "
                         f"and {tuple(matrix.shape)}")
    if blocks.device.type == "cpu":
        return block_transform_quantize_ref(blocks, matrix, q)
    x = build.aligned(blocks.to(torch.float32).contiguous())
    mat = torch.as_tensor(matrix, device=x.device).to(torch.float32).contiguous()
    build.check_cuda(x, "blocks", torch.float32)
    build.check_cuda(mat, "matrix", torch.float32)
    nb, B = x.shape
    if B not in BLOCK_SIZES:
        raise ValueError(f"the CUDA block transform takes B in {BLOCK_SIZES}, got {B}")
    codes = torch.empty((nb, B), dtype=torch.int32, device=x.device)
    if nb == 0:
        return codes
    err = build.library("block_transform").block_transform_launch(
        x.data_ptr(), mat.data_ptr(), float(np.float32(q)), B, nb, codes.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "block_transform")
    launches["block_transform"] += 1
    return codes
