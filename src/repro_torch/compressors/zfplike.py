"""ZFP/SPERR-style error-bounded compressors: blockwise orthogonal transform.

ZFP [14], [16] decorrelates fixed 4^d blocks with a (near-)orthogonal
transform and codes the coefficients; SPERR [15] applies a deeper multi-level
wavelet.  We implement the shared algorithmic core — blockwise orthonormal
transform + uniform coefficient quantization + entropy coding — with:

  * ``ZFPLikeCompressor``:  4^d blocks, 4-point orthonormal DCT-II
  * ``SperrLikeCompressor``: 8^d blocks, 3-level orthonormal Haar (deeper,
    wavelet-like multi-resolution decorrelation)

The pointwise L-inf bound is enforced through the worst-case inverse-transform
gain: if every coefficient error is <= q/2 then every value error is
<= (q/2) * g^d with g = max_n sum_k |Binv[n, k]| (L-inf operator norm of the
inverse, exact for separable transforms).  We set q = 2E / g^d.

This matches the paper's taxonomy: transform-based bases exploit correlation
over a wider support, so they natively retain more frequency structure than
the prediction-based SZ path (§V-B Obs. 1) — visible in our benches too.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from repro_torch.coding.lossless import lossless_compress, lossless_decompress


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows = basis functions)."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    mat = np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    mat[0] *= np.sqrt(1.0 / n)
    mat[1:] *= np.sqrt(2.0 / n)
    return mat


def _haar_matrix(n: int, levels: int) -> np.ndarray:
    """Orthonormal multi-level Haar analysis matrix for length ``n`` (pow 2)."""
    mat = np.eye(n)
    size = n
    for _ in range(levels):
        if size < 2:
            break
        h = np.zeros((size, size))
        half = size // 2
        for i in range(half):
            h[i, 2 * i] = h[i, 2 * i + 1] = 1.0 / np.sqrt(2.0)
            h[half + i, 2 * i] = 1.0 / np.sqrt(2.0)
            h[half + i, 2 * i + 1] = -1.0 / np.sqrt(2.0)
        step = np.eye(n)
        step[:size, :size] = h
        mat = step @ mat
        size = half
    return mat


class _BlockTransformCompressor:
    """Common machinery: pad -> blockify -> separable transform -> quantize."""

    name = "blocktransform"
    block: int = 4

    def __init__(self, codec: str = "zlib"):
        self.codec = codec
        self._fwd = self._matrix()
        self._inv = self._fwd.T  # orthonormal
        # worst-case L-inf gain of the separable inverse transform, per axis
        self._gain1 = float(np.max(np.abs(self._inv).sum(axis=1)))

    def _matrix(self) -> np.ndarray:
        raise NotImplementedError

    # -- blocking helpers --------------------------------------------------

    def _pad(self, x: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
        b = self.block
        pads = [(0, (-n) % b) for n in x.shape]
        return np.pad(x, pads, mode="edge"), x.shape

    def _blockify(self, x: np.ndarray) -> np.ndarray:
        """(n1,...,nd) -> (nblocks, b, b, ..., b)."""
        b = self.block
        d = x.ndim
        new_shape = []
        for n in x.shape:
            new_shape += [n // b, b]
        y = x.reshape(new_shape)
        # interleave: (n1/b, b, n2/b, b, ...) -> (n1/b, n2/b, ..., b, b, ...)
        perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
        y = y.transpose(perm)
        return y.reshape((-1,) + (b,) * d)

    def _unblockify(self, blocks: np.ndarray, padded_shape: Tuple[int, ...]) -> np.ndarray:
        b = self.block
        d = len(padded_shape)
        grid = tuple(n // b for n in padded_shape)
        y = blocks.reshape(grid + (b,) * d)
        perm = []
        for i in range(d):
            perm += [i, d + i]
        y = y.transpose(perm)
        return y.reshape(padded_shape)

    def _transform(self, blocks: np.ndarray, mat: np.ndarray) -> np.ndarray:
        d = blocks.ndim - 1
        out = blocks
        for axis in range(1, d + 1):
            out = np.moveaxis(np.tensordot(mat, out, axes=([1], [axis])), 0, axis)
        return out

    # -- public API ---------------------------------------------------------

    def compress(self, x: np.ndarray, E: float) -> bytes:
        x = np.asarray(x, dtype=np.float32)
        E = float(E)
        if E <= 0:
            raise ValueError("E must be positive")
        padded, orig_shape = self._pad(x)
        d = x.ndim
        q = 2.0 * E / (self._gain1**d)
        blocks = self._blockify(padded.astype(np.float64))
        coeffs = self._transform(blocks, self._fwd)
        codes = np.rint(coeffs / q).astype(np.int64)
        payload = lossless_compress(codes.ravel(), codec=self.codec)
        header = struct.pack("<dB", E, d) + struct.pack(f"<{d}Q", *orig_shape)
        return header + payload

    def decompress(self, blob: bytes) -> np.ndarray:
        E, d = struct.unpack_from("<dB", blob, 0)
        off = struct.calcsize("<dB")
        orig_shape = struct.unpack_from(f"<{d}Q", blob, off)
        off += 8 * d
        codes = lossless_decompress(blob[off:])
        b = self.block
        padded_shape = tuple(n + ((-n) % b) for n in orig_shape)
        q = 2.0 * E / (self._gain1**d)
        coeffs = codes.reshape((-1,) + (b,) * d).astype(np.float64) * q
        blocks = self._transform(coeffs, self._inv)
        padded = self._unblockify(blocks, padded_shape)
        out = padded[tuple(slice(0, n) for n in orig_shape)]
        return out.astype(np.float32)


class ZFPLikeCompressor(_BlockTransformCompressor):
    """4^d-block DCT transform compressor (ZFP-like, fixed-accuracy mode)."""

    name = "zfplike"
    block = 4

    def _matrix(self) -> np.ndarray:
        return _dct_matrix(4)


class SperrLikeCompressor(_BlockTransformCompressor):
    """8^d-block 3-level Haar wavelet compressor (SPERR-like)."""

    name = "sperrlike"
    block = 8

    def _matrix(self) -> np.ndarray:
        return _haar_matrix(8, levels=3)
