"""Bit packing for binary flag vectors (paper §IV-B: flags packed into 8-bit ints)."""

from __future__ import annotations

import numpy as np


def pack_bits(flags: np.ndarray) -> bytes:
    """Pack a boolean/0-1 vector into bytes (8 flags per byte, MSB first)."""
    flags = np.asarray(flags).astype(bool).ravel()
    return np.packbits(flags).tobytes()


def unpack_bits(data: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns a boolean vector of length ``n``."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8), count=n)
    return bits.astype(bool)
