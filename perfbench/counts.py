"""The yardstick's work counts and the card's published peaks.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), which assume the
card's full 700 W: a card set to a lower power limit runs below them, so every
reading is printed beside the limit that ``nvidia-smi`` reports.

The per-pencil byte and operation counts are copied from ``chip_smoke.py``
(``phase_pencil_kernels``, the ``rfft_fwd_epilogue_rows`` and
``unpack_sclip_rows`` cases, and ``bound_case``), not imported: the
benchmark keeps its own yardstick.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12


def least_seconds(n_bytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take (``chip_smoke.bound_case``): each
    input byte read once and each output byte written once over the HBM
    bandwidth, or the float32 operations over the float32 peak, whichever is
    longer, and which of the two it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rfft_flops(n: int) -> float:
    """A real FFT of length ``n``: half of a complex one's 5 n log2 n."""
    return 2.5 * n * math.log2(n) if n > 1 else 0.0


def fclip_flops(n: int) -> float:
    """The f-clip and check of one pencil's half spectrum: ``12 h + 20 (h -
    1)`` for ``h = n // 2 + 1`` bins (``chip_smoke.py``, case
    ``rfft_fwd_epilogue_rows``: ``12 * n + 20 * nz`` over ``rows`` pencils)."""
    h = n // 2 + 1
    return 12.0 * h + 20.0 * (h - 1)


def sclip_flops(n: int) -> float:
    """The s-clip of one pencil: 3 operations a value (``chip_smoke.py``,
    cases ``scube_rows`` and ``unpack_sclip_rows``: ``3 * n``)."""
    return 3.0 * n


def pencil_pass_flops(n: int) -> float:
    """One full pass of the loop on one pencil of ``n`` values: the forward
    real FFT and the f-clip with its check, then the inverse real FFT and
    the s-clip."""
    return pencil_check_flops(n) + rfft_flops(n) + sclip_flops(n)


def pencil_check_flops(n: int) -> float:
    """The iteration that finds a pencil inside the f-cube and stops it:
    the forward real FFT and the f-clip's check, no inverse and no
    s-clip."""
    return rfft_flops(n) + fclip_flops(n)


def correction_work(calls: Iterable[Tuple[int, int, int, int]]) -> Tuple[float, float]:
    """``(bytes, flops)`` of the corrections in ``calls``, each ``(block,
    pencils, iterations summed over its pencils, pencils that converged)``:
    a converged pencil's last iteration is a check only, every other
    iteration (all of an unconverged pencil's) a full pass; each pencil's
    float32 values are read once and written once."""
    n_bytes = flops = 0.0
    for block, pencils, iterations, converged in calls:
        n_bytes += 8.0 * block * pencils
        flops += pencil_pass_flops(block) * (iterations - converged) + pencil_check_flops(block) * converged
    return n_bytes, flops
