"""s-cube / f-cube projections (paper §IV-A/B, Fig. 3), on torch tensors.

The spatial error vector ``eps`` lives in R^N.  The s-cube is the axis-aligned
box ``|eps_n| <= E``; projecting onto it clips each coordinate.  The f-cube is
axis-aligned in the *frequency basis*, so the exact Euclidean projection onto
it is ``FFT -> clip Re/Im to [-Delta, Delta] -> IFFT``.

Clipping Re and Im with the same (Hermitian-symmetric) bound preserves the
Hermitian symmetry of the spectrum of a real error vector, so the half-spectrum
kept by ``rfftn`` (last axis ``0..N//2``) holds every independent component;
:func:`rfft_pair_weights` supplies the conjugate-pair multiplicities so
violation *counts* still match full-spectrum semantics.

Bounds are converted to tensors of the data's (real) dtype before any clip or
comparison, so a Python-float bound rounds exactly once, as in the reference
package.  These are the plain oracles; :mod:`repro_torch.kernels.fcube` /
``scube`` hold the fused CUDA kernels with identical semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rfft_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Shape of ``rfftn`` output for a real field of ``shape``."""
    return tuple(shape[:-1]) + (shape[-1] // 2 + 1,)


def rfft_pair_weights(shape: Tuple[int, ...], dtype=torch.int32, device=None) -> torch.Tensor:
    """Conjugate-pair multiplicity of each half-spectrum component.

    For a real field of full ``shape``, a component at last-axis index
    ``0 < k < N/2`` stands for itself *and* its conjugate at ``N-k`` — weight
    2.  The ``k = 0`` plane and (even ``N``) the ``k = N/2`` plane count once.

    Returns a ``(1, ..., 1, N//2 + 1)`` tensor broadcastable against the
    half-spectrum; ``sum(weights * ones) == prod(shape)``.
    """
    n = shape[-1]
    h = n // 2 + 1
    w = np.full(h, 2, dtype=np.int64)
    w[0] = 1
    if n % 2 == 0:
        w[-1] = 1
    return torch.as_tensor(w, dtype=dtype, device=device).reshape((1,) * (len(shape) - 1) + (h,))


def as_bound(b, like: torch.Tensor) -> torch.Tensor:
    """A scalar or array bound as a tensor of ``like``'s real dtype and device."""
    real = like.real if like.is_complex() else like
    return torch.as_tensor(b, dtype=real.dtype, device=like.device)


def clip(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``clip(x, -b, b)`` for a tensor bound ``b`` broadcastable to ``x``."""
    return torch.clamp(x, -b, b)


def project_scube(eps: torch.Tensor, E) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip spatial errors to the s-cube.  Returns (clipped, displacement)."""
    clipped = clip(eps, as_bound(E, eps))
    return clipped, clipped - eps


def project_fcube(delta: torch.Tensor, Delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip complex frequency errors to the f-cube (independent Re/Im clip).

    Returns (clipped, displacement) — both complex, same shape as ``delta``.
    Works identically on full and half spectra.
    """
    D = as_bound(Delta, delta)
    clipped = torch.complex(clip(delta.real, D), clip(delta.imag, D))
    return clipped, clipped - delta


def project_box_relaxed(x: torch.Tensor, bound, relax: float) -> torch.Tensor:
    """Closed-form ``P(x + relax*(P(x) - x))`` for the box ``|x| <= bound``:
    ``sign(x) * clip(|x| - r*max(|x|-bound, 0), -bound, bound)``."""
    b = as_bound(bound, x)
    a = torch.abs(x)
    m = a - relax * torch.clamp_min(a - b, 0.0)
    return torch.sign(x) * clip(m, b)


def project_fcube_relaxed(delta: torch.Tensor, Delta, relax: float) -> torch.Tensor:
    """Relaxed f-cube projection, one clip per Re/Im channel (see above)."""
    return torch.complex(
        project_box_relaxed(delta.real, Delta, relax),
        project_box_relaxed(delta.imag, Delta, relax),
    )


def fcube_violations(delta: torch.Tensor, Delta, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count of frequency components outside the f-cube (CheckConvergence).

    ``weight`` (broadcastable int tensor) scales each component's
    contribution; the rfft fast path passes :func:`rfft_pair_weights` so the
    count over the half-spectrum equals the count over the full spectrum.
    """
    D = as_bound(Delta, delta)
    viol = (torch.abs(delta.real) > D) | (torch.abs(delta.imag) > D)
    if weight is None:
        return torch.sum(viol)
    return torch.sum(viol.to(weight.dtype) * weight.to(viol.device))


def scube_violations(eps: torch.Tensor, E) -> torch.Tensor:
    """Count of spatial components outside the s-cube."""
    return torch.sum(torch.abs(eps) > as_bound(E, eps))
