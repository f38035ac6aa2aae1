"""Fused f-cube projection + CheckConvergence: CUDA kernel + plain twin.

Replaces ``repro/kernels/fcube`` (the ``_fcube_kernel`` Pallas kernel and its
``project_fcube_fused`` wrapper).  The kernel is ``csrc/fcube.cu``: one pass
that clips Re/Im to ``+-Delta``, writes the clipped spectrum and the edit
displacement, and counts the components with ``|Re|`` or ``|Im|`` above
``t = Delta * (1 + check_tol) + check_slack``.

Counting weights: the reference takes an int32 weight array; here
``n_last=None`` counts each component once, and ``n_last=N`` applies the
conjugate-pair weights of a real field whose last axis has ``N`` points
(``core.cubes.rfft_pair_weights``; the array's last axis must be
``N // 2 + 1``) — the kernel derives them from the column index.

Per-pencil mode (``per_row=True``, the batched pencil loop's vmap of the
reference kernel): every leading index is an independent row, ``Delta`` is a
scalar or one value per row (shape ``delta.shape[:-1] + (1,)``), and the
count is one int32 per row (shape ``delta.shape[:-1]``).  CUDA tensors launch
the kernel's per-row entry point, counted under ``fcube_rows``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cubes import rfft_pair_weights
from repro_torch.kernels import build

#: kernel launches by wrapper (reset it to 0 to count a run's launches)
launches = {"fcube": 0, "fcube_rows": 0}


def threshold_scalars(check_tol: float, check_slack) -> Tuple[float, float]:
    """``(tol1, slack)`` as the float32 values the reference kernel uses:
    ``float32(1 + check_tol)`` and ``float32(check_slack)``."""
    return float(np.float32(1.0 + check_tol)), float(np.float32(float(check_slack)))


def _check_n_last(shape, n_last: Optional[int]) -> None:
    if n_last is not None and n_last // 2 + 1 != shape[-1]:
        raise ValueError(f"n_last={n_last} needs a last axis of {n_last // 2 + 1}, got {shape[-1]}")


def project_fcube_plain(
    delta: torch.Tensor, Delta, n_last: Optional[int] = None, check_tol: float = 0.0, check_slack=0.0,
    per_row: bool = False,
):
    """Plain twin: ``(clipped, displacement, violations)``, clipped in float32.

    ``violations`` is an int32 tensor on ``delta``'s device: 0-d, or one
    count per row with ``per_row``.
    """
    re = delta.real.to(torch.float32)
    im = delta.imag.to(torch.float32)
    d = torch.as_tensor(Delta, dtype=torch.float32, device=delta.device)
    cr = torch.clamp(re, -d, d)
    ci = torch.clamp(im, -d, d)
    tol1, slack = threshold_scalars(check_tol, check_slack)
    dt = d * torch.tensor(tol1, device=d.device) + torch.tensor(slack, device=d.device)
    vb = ((torch.abs(re) > dt) | (torch.abs(im) > dt)).to(torch.int32)
    _check_n_last(delta.shape, n_last)
    if n_last is not None:
        vb = vb * rfft_pair_weights((n_last,), device=delta.device).reshape(-1)
    viol = (torch.sum(vb, dim=-1) if per_row else torch.sum(vb)).to(torch.int32)
    clipped = torch.complex(cr, ci).to(delta.dtype)
    edits = torch.complex(cr - re, ci - im).to(delta.dtype)
    return clipped, edits, viol


def project_fcube_fused(
    delta: torch.Tensor, Delta, n_last: Optional[int] = None, check_tol: float = 0.0, check_slack=0.0,
    per_row: bool = False,
):
    """Drop-in for ``core.cubes.project_fcube`` + ``fcube_violations``.

    Returns ``(clipped, displacement, violations)``: complex tensors of
    ``delta``'s dtype and an int32 count on ``delta``'s device (0-d, or one
    per row with ``per_row``; see the module docstring).  CPU tensors take
    :func:`project_fcube_plain`; CUDA tensors launch the kernel (complex128
    is cast to complex64 and back, as the reference wrapper does).
    ``check_slack`` is a host scalar.
    """
    if delta.device.type == "cpu":
        return project_fcube_plain(delta, Delta, n_last, check_tol, check_slack, per_row)
    x = delta.to(torch.complex64)
    build.check_cuda(x, "delta", torch.complex64)
    _check_n_last(x.shape, n_last)
    operand, scalar, mode = build.bound_operand(Delta, x.shape, x.device, rows=per_row)
    tol1, slack = threshold_scalars(check_tol, check_slack)
    clipped = torch.empty_like(x)
    edits = torch.empty_like(x)
    weighted, nyquist = int(n_last is not None), int(n_last is not None and n_last % 2 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library("fcube")
    if per_row:
        viol = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
        err = lib.fcube_rows_launch(
            x.data_ptr(), operand.data_ptr() if mode else None, scalar, int(mode == 2),
            tol1, slack, viol.numel(), x.shape[-1], weighted, nyquist,
            clipped.data_ptr(), edits.data_ptr(), viol.data_ptr(), stream,
        )
    else:
        viol = torch.zeros((), dtype=torch.int32, device=x.device)
        err = lib.fcube_launch(
            x.data_ptr(), operand.data_ptr() if mode else None, scalar, mode,
            tol1, slack, x.shape[-1], weighted, nyquist,
            clipped.data_ptr(), edits.data_ptr(), viol.data_ptr(), x.numel(), stream,
        )
    build.check(err, "fcube")
    launches["fcube_rows" if per_row else "fcube"] += 1
    return clipped.to(delta.dtype), edits.to(delta.dtype), viol
