"""QuantizeEdits: CUDA kernel wrapper + plain twin.

Replaces ``repro/kernels/quantize`` (the ``_quantize_kernel`` Pallas kernel
and its ``quantize_edits`` wrapper).  The kernel is ``csrc/quantize.cu``; its
twin is :func:`ref.quantize_edits_ref`.  The reference's ``block_rows`` and
``interpret`` arguments tile and emulate the TPU kernel; they are accepted
for signature compatibility and ignored (the kernel masks its own tail).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.quantize.ref import quantize_edits_ref

#: kernel launches by wrapper (reset it to 0 to count a run's launches)
launches = {"quantize": 0}


def quantize_edits(
    values: torch.Tensor,
    bound,
    m: int = 16,
    block_rows: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize an edit tensor on the 2^m cube grid; returns int32
    ``(codes, flags)`` of ``values``' shape.

    ``bound`` is a scalar or an array broadcastable to ``values``.  CPU
    tensors take :func:`quantize_edits_ref`; CUDA tensors launch the kernel
    (values cast to float32, as the reference wrapper casts them) or raise.
    ``block_rows`` and ``interpret`` are ignored (see the module docstring).
    """
    del block_rows, interpret
    if not 0 <= m <= 127:
        raise ValueError(f"m must be in [0, 127] (2^m a normal float32), got {m}")
    if values.device.type == "cpu":
        return quantize_edits_ref(values, bound, m)
    v = values.to(torch.float32).contiguous()
    build.check_cuda(v, "values", torch.float32)
    grid, scalar, pointwise = build.bound_operand(bound, v.shape, v.device)
    codes = torch.empty(v.shape, dtype=torch.int32, device=v.device)
    flags = torch.empty_like(codes)
    err = build.library("quantize").quantize_launch(
        v.data_ptr(), grid.data_ptr() if pointwise else None, scalar, pointwise,
        float(np.float32(2.0**m)), codes.data_ptr(), flags.data_ptr(), v.numel(),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    build.check(err, "quantize")
    launches["quantize"] += 1
    return codes, flags
