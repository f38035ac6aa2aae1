"""Zero-error base compressor (stores float32 verbatim + zlib).

Useful as (a) a degenerate baseline, (b) the base stage when FFCz is used
purely as a spectral editor, and (c) a correctness anchor in tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


class IdentityCompressor:
    name = "identity"

    def compress(self, x: np.ndarray, E: float) -> bytes:
        x = np.asarray(x, dtype=np.float32)
        header = struct.pack("<B", x.ndim) + struct.pack(f"<{x.ndim}Q", *x.shape)
        return header + zlib.compress(x.tobytes(), 1)

    def decompress(self, blob: bytes) -> np.ndarray:
        (ndim,) = struct.unpack_from("<B", blob, 0)
        shape = struct.unpack_from(f"<{ndim}Q", blob, 1)
        data = zlib.decompress(blob[1 + 8 * ndim :])
        return np.frombuffer(data, dtype=np.float32).reshape(shape).copy()
