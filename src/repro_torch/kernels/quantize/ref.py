"""Plain PyTorch twin of the QuantizeEdits kernel (``csrc/quantize.cu``)."""

from __future__ import annotations

from typing import Tuple

import torch

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def saturating_int32(r: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as CUDA's ``__float2int_rn`` does it on integral
    values: out-of-range values saturate to INT32_MIN/INT32_MAX, NaN maps to
    0.  (A plain ``.to(torch.int32)`` leaves those cases undefined.)"""
    hi, lo = r >= 2.0**31, r < -(2.0**31)
    inside = torch.where(hi | lo | torch.isnan(r), torch.zeros_like(r), r).to(torch.int32)
    inside = torch.where(hi, torch.full_like(inside, _I32_MAX), inside)
    return torch.where(lo, torch.full_like(inside, _I32_MIN), inside)


def quantize_edits_ref(values: torch.Tensor, bound, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``codes = rint(v / (2b / 2^m))`` as int32 (0 where the step is 0) and
    ``flags = codes != 0`` as int32, in float32 like the reference oracle.

    The bound becomes a float32 tensor on ``values``' device, so the division
    is IEEE division on the card too (PyTorch divides by a host scalar as a
    multiplication by its reciprocal).  Out-of-range codes saturate
    (:func:`saturating_int32`), as the kernel's cast does.
    """
    v = values.to(torch.float32)
    b = torch.as_tensor(bound, dtype=torch.float32, device=v.device)
    step = 2.0 * b / (2.0**m)
    zero = step == 0.0
    safe = torch.where(zero, torch.ones_like(step), step)
    r = torch.where(zero, torch.zeros_like(v), torch.round(v / safe))
    codes = saturating_int32(r)
    return codes, (codes != 0).to(torch.int32)
