"""Fused s-cube projection (paper §IV-D ProjectOntoSCube): CUDA kernel + twin.

Replaces ``repro/kernels/scube`` (the ``_scube_kernel`` Pallas kernel and its
``project_scube_fused`` wrapper).  The kernel is ``csrc/scube.cu``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

#: kernel launches by wrapper (reset it to 0 to count a run's launches)
launches = {"scube": 0}


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

    The counting wrappers (:func:`project_scube_fused` and the pack-trick
    inverse epilogue) call this and add to their own counters.
    """
    build.check_cuda(x, "eps", torch.float32)
    grid, scalar, pointwise = build.bound_operand(E, x.shape, x.device)
    out = torch.empty_like(x)
    edit = torch.empty_like(x)
    err = build.library("scube").scube_launch(
        x.data_ptr(), grid.data_ptr() if pointwise else None, scalar, pointwise,
        out.data_ptr(), edit.data_ptr(), x.numel(),
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
    out, edit = scube_launch(eps.to(torch.float32), E)
    launches["scube"] += 1
    return out.to(eps.dtype), edit.to(eps.dtype)
