"""SZ3-style error-bounded compressor: multi-level interpolation prediction.

Implements the algorithmic core of SZ3's interpolation mode [13], [2]:
coarse-to-fine grid refinement where each new point is predicted by linear
interpolation of already-*reconstructed* neighbors along one axis, and the
residual is quantized with a uniform quantizer of step ``2E`` (error <= E,
codes entropy-coded).  Prediction from reconstructed values keeps the bound
non-compounding, exactly as in SZ.

The paper's characterization (§V-B, Obs. 1) — prediction-based, local
neighbors, weak at preserving global frequency content — applies verbatim to
this implementation, which is what makes it the interesting base for FFCz.

Vectorized per (level, axis) pass; encode and decode share the same
deterministic pass schedule, so the code stream needs no per-point metadata.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.coding.lossless import lossless_compress, lossless_decompress


def _pass_schedule(shape: Tuple[int, ...]) -> Iterator[Tuple[int, int]]:
    """Yield (stride, axis) passes from coarsest to finest level."""
    n_max = max(shape)
    s = 1
    while s * 2 < n_max:
        s *= 2
    while s >= 1:
        for axis in range(len(shape)):
            yield s, axis
        s //= 2


def _coarse_stride(shape: Tuple[int, ...]) -> int:
    n_max = max(shape)
    s = 1
    while s * 2 < n_max:
        s *= 2
    return 2 * s  # the grid known *before* the first (s, axis=0) pass


def _pass_indices(shape, stride: int, axis: int):
    """Index grids (np.ix_) for one interpolation pass.

    Targets: coordinates ``stride (mod 2*stride)`` along ``axis``; axes before
    ``axis`` already refined to ``stride``; axes after still at ``2*stride``.
    Returns (target ix_ tuple, left ix_ tuple, right ix_ tuple) or None if
    the pass is empty.
    """
    n_a = shape[axis]
    tgt = np.arange(stride, n_a, 2 * stride)
    if tgt.size == 0:
        return None
    left = tgt - stride
    right = np.where(tgt + stride < n_a, tgt + stride, tgt - stride)
    others: List[np.ndarray] = []
    for a, n in enumerate(shape):
        if a < axis:
            others.append(np.arange(0, n, stride))
        elif a > axis:
            others.append(np.arange(0, n, 2 * stride))
    def with_axis(ax_idx):
        full = list(others[:axis]) + [ax_idx] + list(others[axis:])
        return np.ix_(*full)
    return with_axis(tgt), with_axis(left), with_axis(right)


class SZLikeCompressor:
    """Interpolation-predictor error-bounded compressor (SZ3-like)."""

    name = "szlike"

    def __init__(self, codec: str = "zlib"):
        self.codec = codec

    def compress(self, x: np.ndarray, E: float) -> bytes:
        x = np.asarray(x, dtype=np.float32)
        E = float(E)
        if E <= 0:
            raise ValueError("E must be positive")
        shape = x.shape
        step = 2.0 * E
        r = np.zeros(shape, dtype=np.float64)
        s0 = _coarse_stride(shape)
        coarse_ix = np.ix_(*[np.arange(0, n, s0) for n in shape])
        coarse_vals = x[coarse_ix].astype(np.float32)
        r[coarse_ix] = coarse_vals  # coarsest anchors stored losslessly

        codes_all: List[np.ndarray] = []
        for stride, axis in _pass_schedule(shape):
            idx = _pass_indices(shape, stride, axis)
            if idx is None:
                continue
            tgt, left, right = idx
            pred = 0.5 * (r[left] + r[right])
            codes = np.rint((x[tgt].astype(np.float64) - pred) / step)
            r[tgt] = pred + codes * step
            codes_all.append(codes.astype(np.int64).ravel())

        codes_flat = np.concatenate(codes_all) if codes_all else np.zeros(0, dtype=np.int64)
        payload = lossless_compress(codes_flat, codec=self.codec)
        header = struct.pack("<dB", E, x.ndim) + struct.pack(f"<{x.ndim}Q", *shape)
        header += struct.pack("<I", coarse_vals.size) + coarse_vals.tobytes()
        return header + payload

    def decompress(self, blob: bytes) -> np.ndarray:
        E, ndim = struct.unpack_from("<dB", blob, 0)
        off = struct.calcsize("<dB")
        shape = struct.unpack_from(f"<{ndim}Q", blob, off)
        off += 8 * ndim
        (n_coarse,) = struct.unpack_from("<I", blob, off)
        off += 4
        coarse_vals = np.frombuffer(blob, dtype=np.float32, count=n_coarse, offset=off)
        off += 4 * n_coarse
        codes_flat = lossless_decompress(blob[off:])

        step = 2.0 * E
        r = np.zeros(shape, dtype=np.float64)
        s0 = _coarse_stride(shape)
        coarse_ix = np.ix_(*[np.arange(0, n, s0) for n in shape])
        r[coarse_ix] = coarse_vals.reshape(r[coarse_ix].shape)

        pos = 0
        for stride, axis in _pass_schedule(shape):
            idx = _pass_indices(shape, stride, axis)
            if idx is None:
                continue
            tgt, left, right = idx
            pred = 0.5 * (r[left] + r[right])
            n = pred.size
            codes = codes_flat[pos : pos + n].reshape(pred.shape)
            pos += n
            r[tgt] = pred + codes * step
        return r.astype(np.float32)
