"""Dual-domain error-bound specification (paper §IV-A, Eq. (2)), on torch tensors.

Spatial bound ``E`` applies pointwise to reconstruction errors
``eps_n = x_hat_n - x_n``; frequency bound ``Delta`` applies to the real and
imaginary parts of ``delta_k = FFT(eps)_k`` independently.  Both may be
scalars (global bounds, Eq. (2)) or arrays broadcastable to the data shape
(pointwise bounds ``E_n`` / ``Delta_k`` — footnote 1 and Observation 4).

Arithmetic on device tensors runs in the data's float32, with every Python
constant first made a float32 tensor on the same device: one rounding per
operation, and the same values on the CPU and the card (a division by a bare
Python scalar may become a reciprocal multiply on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core.errors import InfeasibleBound

ArrayLike = Union[float, np.ndarray, torch.Tensor]


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """Python constant -> 0-d float32 tensor on ``like``'s device."""
    return torch.tensor(np.float32(v), device=like.device)


@dataclasses.dataclass(frozen=True)
class DualBounds:
    """Resolved absolute bounds for one tensor.

    Attributes:
      E:     spatial L-inf bound (scalar or per-point array).
      Delta: frequency bound on |Re(delta_k)| and |Im(delta_k)| (scalar or
             per-component array over the *unnormalized* DFT of the error).
    """

    E: ArrayLike
    Delta: ArrayLike

    def shrink(self, factor_E: float, factor_D: float) -> "DualBounds":
        return DualBounds(E=self.E * factor_E, Delta=self.Delta * factor_D)


def resolve_bounds(
    x: torch.Tensor,
    *,
    E_abs: ArrayLike | None = None,
    E_rel: float | None = None,
    Delta_abs: ArrayLike | None = None,
    Delta_rel: float | None = None,
    X: torch.Tensor | None = None,
) -> DualBounds:
    """Resolve user bounds (absolute or relative) to absolute ``DualBounds``.

    Relative spatial bound follows the SZ convention: ``E = E_rel * range(x)``.
    Relative frequency bound follows the paper's evaluation scheme:
    ``Delta = Delta_rel * max_k |X_k|`` where ``X = FFT(x)``.

    A constant field has ``range(x) == 0``, so ``E_rel`` resolves to an
    empty spatial cube — a structured :class:`InfeasibleBound` names that
    cause here instead of letting a cryptic representability error surface
    later in the plan stage.
    """
    if (E_abs is None) == (E_rel is None):
        raise ValueError("exactly one of E_abs / E_rel required")
    if (Delta_abs is None) == (Delta_rel is None):
        raise ValueError("exactly one of Delta_abs / Delta_rel required")
    if E_abs is None:
        rng = torch.max(x) - torch.min(x)
        if float(rng) == 0.0:
            raise InfeasibleBound(
                f"E_rel={float(E_rel):g} on a constant field: range(x) == 0 "
                "resolves the spatial bound to E = 0 (an empty s-cube); pass "
                "E_abs for constant fields",
                stage="plan",
            )
        E_abs = _f32(E_rel, rng) * rng
    if Delta_abs is None:
        if X is None:
            # the rfft half-spectrum suffices: |X_{-k}| = |X_k| for real x
            X = torch.fft.rfftn(x)
        amax = torch.max(torch.abs(X))
        Delta_abs = _f32(Delta_rel, amax) * amax
    return DualBounds(E=E_abs, Delta=Delta_abs)


def power_spectrum_delta(X: torch.Tensor, rel: float, floor: float = 0.0, has_dc: bool = True) -> torch.Tensor:
    """Per-component ``Delta_k`` guaranteeing a relative power-spectrum bound.

    The paper (Observation 4) preserves the power spectrum by assigning
    pointwise relative error bounds to individual frequency components, on
    mean-normalized fluctuations, with the budget split in two:

    1. component term: ``Delta_k = t |X_k| / sqrt(2)`` with
       ``t = sqrt(1 + rel/2) - 1`` bounds each component's power ratio by
       ``1 + rel/2``;
    2. normalization term: the DC component is ``N * mean``, so bounding its
       error by ``Delta_0 = (rel/8) |X_0|`` keeps the mean-normalization
       factor within ``1 + rel/2``.

    Total: ``|P_hat - P| / P <= (1+rel/2)^2 - 1 <= rel`` for rel <= 1.
    ``floor`` (absolute) keeps near-zero components from forcing
    ``Delta_k = 0``.  ``has_dc=False`` is for a block of a sharded spectrum
    whose flat index 0 is not the DC component (only the first rank's is).
    """
    t = float(np.sqrt(1.0 + rel / 2.0) - 1.0)
    mag = torch.abs(X)
    delta = torch.maximum(_f32(t, mag) * mag / _f32(np.sqrt(2.0), mag), _f32(floor, mag))
    if not has_dc:
        return delta
    flat = delta.reshape(-1)
    dc_bound = _f32(rel / 8.0, mag) * mag.reshape(-1)[0]
    flat[0] = torch.minimum(flat[0], dc_bound)
    return flat.reshape(X.shape)


def power_spectrum_delta_rfft(X_half: torch.Tensor, rel: float, floor: float = 0.0,
                              has_dc: bool = True) -> torch.Tensor:
    """:func:`power_spectrum_delta` on the rfft half-spectrum.

    ``X_half = rfftn(x)`` keeps every independent component of a real
    field's Hermitian-symmetric spectrum and the DC component stays at flat
    index 0, so the grid computed here *is* the half-plane restriction of the
    full-spectrum grid.  This is the grid the rFFT POCS loop consumes.
    """
    return power_spectrum_delta(X_half, rel, floor=floor, has_dc=has_dc)


def resolve_roi_bound_grid(E_roi, E_global: float, shape, scale: float = 0.1) -> np.ndarray:
    """Resolve a spatially varying ROI bound into a per-point ``E_n`` grid.

    ``E_roi`` is either

    * a **boolean mask** — ``True`` marks region-of-interest points, which
      get the tighter bound ``E_global * scale``; ``False`` is background
      (the global ``E``), or
    * a **float grid** of per-point absolute bounds — entries ``> 0`` are
      used directly (clamped to ``min(value, E_global)``: ROI bounds only
      ever *tighten*), entries ``<= 0`` mean background.

    The returned grid is float32 (the exact per-point values the blob
    stores and the s-cube clip consumes), shaped like the field.  Because
    every entry is ``<= E_global``, the scalar header ``E`` remains a valid
    global upper bound for readers that ignore the grid.
    """
    grid = np.asarray(E_roi)
    if grid.shape != tuple(shape):
        raise ValueError(
            f"E_roi shape {grid.shape} must match the field shape {tuple(shape)}"
        )
    if not 0.0 < scale <= 1.0:
        raise ValueError(f"E_roi_scale must be in (0, 1], got {scale}")
    if grid.dtype == np.bool_:
        out = np.where(grid, E_global * scale, E_global)
    else:
        vals = grid.astype(np.float64)
        out = np.where(vals > 0, np.minimum(vals, E_global), E_global)
    return np.asarray(out, dtype=np.float32)
