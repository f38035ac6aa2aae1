"""Uniform quantization of edit values (paper §IV-B).

The paper quantizes each compact edit by dividing each axis of the s-cube or
f-cube into ``2^m`` intervals (m = 16 bits by default).  The cube axis for the
s-cube spans ``[-E, E]`` so the quantization step is ``2*E / 2^m``; likewise
``2*Delta / 2^m`` for the f-cube.  Round-to-nearest gives a reconstruction
error of at most ``bound * 2^-m`` per edit, which is exactly the slack
reclaimed by shrinking the initial error bounds to ``bound * (1 - 2^-m)``.

Edits can (rarely) exceed the cube span because they are *accumulated*
displacements, so codes are stored as int32 rather than uint16; the entropy
coder absorbs the near-zero-centred distribution either way.
"""

from __future__ import annotations

import numpy as np

DEFAULT_QUANT_BITS = 16


def quant_step(bound, m: int = DEFAULT_QUANT_BITS):
    """Quantization step: cube diameter 2*bound split into 2^m intervals.

    ``bound`` may be a scalar (global bound) or an array of per-component
    bounds (pointwise ``Delta_k`` mode, Observation 4) — the grid is then
    per-component so quantization error stays within each component's margin.
    """
    return 2.0 * np.asarray(bound, dtype=np.float64) / float(2**m)


def quantize_uniform(values: np.ndarray, bound, m: int = DEFAULT_QUANT_BITS) -> np.ndarray:
    """Round-to-nearest uniform quantization; returns int64 codes.

    int64 because FFCz widens ``m`` adaptively (up to ~48 bits) to keep
    cross-domain quantization leakage inside the shrink margin — see
    ``repro_torch.core.ffcz`` — so codes may exceed int32 range.
    """
    step = quant_step(bound, m)
    safe = np.where(step == 0.0, 1.0, step)
    codes = np.rint(np.asarray(values, dtype=np.float64) / safe)
    return np.where(step == 0.0, 0.0, codes).astype(np.int64)


def dequantize_uniform(codes: np.ndarray, bound, m: int = DEFAULT_QUANT_BITS) -> np.ndarray:
    """Inverse of :func:`quantize_uniform` (centroid reconstruction)."""
    step = quant_step(bound, m)
    return np.asarray(codes, dtype=np.float64) * step


def bound_shrink(bound: float, m: int = DEFAULT_QUANT_BITS, roundoff_slack: float = 0.0) -> float:
    """Shrunk error bound fed to the projection so quantized edits still land
    inside the user's cube: ``bound * (1 - 2^-m - roundoff_slack)``.

    ``roundoff_slack`` additionally absorbs float32 FFT round-off when the
    correction runs in single precision (the paper runs FP32 on A100; we keep
    the same discipline and verify the final bounds post-hoc in FFCz.encode).
    """
    return float(bound) * (1.0 - 2.0 ** (-m) - roundoff_slack)
