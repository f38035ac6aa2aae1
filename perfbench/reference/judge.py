"""The numbers that decide ``correct``, over pencils the program corrected.

For each pencil: the gap between the program's corrected error and the
float64 reference's (:mod:`.pocs`, from the reference's own quantization
error), over ``E``; the largest corrected error over ``E`` (the spatial
bound); and, where the reference converged, the largest ``|Re|`` or ``|Im|``
of the corrected error's spectrum over ``Delta`` (the spectral bound), less
the float32 FFT's rounding (``tau``, Higham, Accuracy and Stability of
Numerical Algorithms, Thm 24.2, as ``chip_smoke.recheck_pencils`` takes it).
Where the program's correction is read back from a float32 output
(``out - g``), ``slack`` is that output's rounding, half an ulp a value: it
is taken off each value's gap and bound and added to ``tau``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import pocs

# float64 values a block of rows holds (1 GiB), so the check fits beside
# whatever the program left allocated
_BLOCK_VALUES = 1 << 27


@dataclasses.dataclass
class Tally:
    """The worst readings over every pencil judged."""

    gap_over_E: float = 0.0
    spatial_over_E: float = 0.0
    spectrum_over_Delta: float = 0.0
    misplaced: int = 0
    pencils: int = 0
    unconverged: int = 0

    def numbers(self) -> dict:
        return {"gap_over_E": self.gap_over_E, "spatial_over_E": self.spatial_over_E,
                "spectrum_over_Delta": self.spectrum_over_Delta, "misplaced": self.misplaced}


def half_ulp(x: torch.Tensor) -> torch.Tensor:
    """Half the spacing of ``x``'s dtype at each value: the most that rounding
    into that dtype moved it (float64)."""
    a = x.abs()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).to(torch.float64) / 2


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.where(num > 0, math.inf, 0.0))


def judge(tally: Tally, err: torch.Tensor, corrected: torch.Tensor, E: torch.Tensor, Delta: torch.Tensor,
          max_iters: int, valid: int, slack: Optional[torch.Tensor] = None) -> None:
    """Add pencils ``(P, n)`` to ``tally``: ``err`` the reference's
    quantization error, ``corrected`` the program's corrected error, ``E``
    and ``Delta`` ``(P,)``; the first ``valid`` values (row-major) are
    data and the rest the last pencil's zero pad, whose corrections the
    program drops: they are left out of the gap and the spatial bound, and
    a padded pencil out of the spectral bound.  ``slack`` as in the
    module's docstring."""
    P, n = err.shape
    step = max(1, _BLOCK_VALUES // n)
    for a in range(0, P, step):
        b = min(P, a + step)
        e, d = E[a:b].to(torch.float64), Delta[a:b].to(torch.float64)
        ref, _, conv = pocs.project(err[a:b].to(torch.float64), e, d, max_iters)
        data = (torch.arange(a * n, b * n, device=err.device) < valid).reshape(b - a, n)
        c = torch.where(data, corrected[a:b].to(torch.float64), 0.0)
        ref = torch.where(data, ref, 0.0)
        full = data.all(dim=-1)
        s = torch.zeros_like(c) if slack is None else slack[a:b]
        gap = torch.clamp_min((c - ref).abs() - s, 0.0).amax(dim=-1)
        del ref
        tally.gap_over_E = max(tally.gap_over_E, float(_ratio(gap, e).max()))
        spatial = torch.clamp_min(c.abs() - s, 0.0).amax(dim=-1)
        tally.spatial_over_E = max(tally.spatial_over_E, float(_ratio(spatial, e).max()))
        spec = torch.fft.rfft(c, dim=-1)
        mag = torch.maximum(spec.real.abs(), spec.imag.abs()).amax(dim=-1)
        del spec
        tau = 5 * 2.0**-24 * math.log2(max(n, 2)) * math.sqrt(n) * torch.linalg.vector_norm(c, dim=-1) + s.sum(-1)
        over = _ratio(torch.clamp_min(mag - tau, 0.0), d)[conv & full]
        if over.numel():
            tally.spectrum_over_Delta = max(tally.spectrum_over_Delta, float(over.max()))
        tally.pencils += b - a
        tally.unconverged += int((~conv & full).sum())
