"""Lossless back-end: Huffman followed by a byte-stream coder (paper: ZSTD [38]).

ZSTD is unavailable in this offline container; ``zlib`` (DEFLATE) is the
stand-in with an identical bytes->bytes interface — documented in
DESIGN.md §6.  ``codec="zlib"`` skips the explicit Huffman stage (DEFLATE
already entropy-codes) and is the fast path used by the throughput benches;
``codec="huffman+zlib"`` is the paper-faithful chain.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from repro_torch.coding.huffman import huffman_decode, huffman_encode

_MAGIC_HUFF = b"FH"
_MAGIC_RAW = b"FR"


def lossless_compress(symbols: np.ndarray, codec: str = "huffman+zlib", level: int = 6) -> bytes:
    """Compress an integer symbol stream to bytes."""
    symbols = np.asarray(symbols).astype(np.int64).ravel()
    if codec == "huffman+zlib":
        body = huffman_encode(symbols)
        return _MAGIC_HUFF + zlib.compress(body, level)
    if codec == "zlib":
        # int64 is wasteful on the wire; narrow to the smallest dtype that fits.
        dtype = _narrowest_dtype(symbols)
        body = struct.pack("<cQ", dtype.char.encode(), symbols.size) + symbols.astype(dtype).tobytes()
        return _MAGIC_RAW + zlib.compress(body, level)
    raise ValueError(f"unknown codec {codec!r}")


def lossless_decompress(data: bytes) -> np.ndarray:
    """Inverse of :func:`lossless_compress`."""
    magic, body = data[:2], zlib.decompress(data[2:])
    if magic == _MAGIC_HUFF:
        return huffman_decode(body)
    if magic == _MAGIC_RAW:
        char, n = struct.unpack_from("<cQ", body, 0)
        dtype = np.dtype(char.decode())
        return np.frombuffer(body, dtype=dtype, count=n, offset=9).astype(np.int64)
    raise ValueError("bad magic in lossless stream")


def _narrowest_dtype(symbols: np.ndarray) -> np.dtype:
    if symbols.size == 0:
        return np.dtype(np.int8)
    lo, hi = int(symbols.min()), int(symbols.max())
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return np.dtype(dt)
    return np.dtype(np.int64)
