"""Fused s-cube projection (paper §IV-D ProjectOntoSCube): CUDA kernel + twin.

Replaces ``repro/kernels/scube`` (the ``_scube_kernel`` Pallas kernel and its
``project_scube_fused`` wrapper).  The kernel is ``csrc/scube.cu``.  A bound of
shape ``eps.shape[:-1] + (1,)`` — one ``E`` per row, the batched pencil
loop's layout — launches the kernel's per-pencil mode, which reads a vector
of row bounds instead of a field-sized grid, and counts under ``scube_rows``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

#: kernel launches by wrapper (reset it to 0 to count a run's launches)
launches = {"scube": 0, "scube_rows": 0}


def project_scube_plain(eps: torch.Tensor, E) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: ``c = clip(eps, -E, E)`` in float32, ``(c, c - eps)``.

    Like the reference wrapper, a float64 input is clipped in float32 and
    cast back.
    """
    x = eps.to(torch.float32)
    b = torch.as_tensor(E, dtype=torch.float32, device=x.device)
    c = torch.clamp(x, -b, b)
    return c.to(eps.dtype), (c - x).to(eps.dtype)


def scube_launch(x: torch.Tensor, E) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``scube_launch`` on a contiguous float32 CUDA tensor; no count.

    A per-row ``E`` (:func:`repro_torch.kernels.build.is_row_bound`) runs the
    per-pencil mode.  The counting wrappers (:func:`project_scube_fused` and
    the pack-trick inverse epilogue) call this and add to their own counters.
    """
    build.check_cuda(x, "eps", torch.float32)
    rows = build.is_row_bound(E, x.shape)
    operand, scalar, mode = build.bound_operand(E, x.shape, x.device, rows=rows)
    out = torch.empty_like(x)
    edit = torch.empty_like(x)
    err = build.library("scube").scube_launch(
        x.data_ptr(), operand.data_ptr() if mode else None, scalar, mode,
        x.shape[-1] if rows else 1, out.data_ptr(), edit.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "scube")
    return out, edit


def project_scube_fused(eps: torch.Tensor, E) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``core.cubes.project_scube``: ``(clipped, displacement)``.

    CPU tensors take :func:`project_scube_plain`; CUDA tensors launch the
    kernel (a float64 input is cast to float32 and back, as the reference
    wrapper does).
    """
    if eps.device.type == "cpu":
        return project_scube_plain(eps, E)
    x = eps.to(torch.float32)
    out, edit = scube_launch(x, E)
    launches["scube_rows" if build.is_row_bound(E, x.shape) else "scube"] += 1
    return out.to(eps.dtype), edit.to(eps.dtype)
