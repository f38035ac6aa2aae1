"""Compaction, quantization, and lossless coding of edits (paper §IV-B, Alg. 1 l.15-20).

Edit streams are sparse (Fig. 5: hundreds-to-thousands of active entries in a
512^3 field), so each stream is stored as

  flags:        N bits, bit-packed (1 = nonzero edit at this component)
  compact vals: the nonzero entries, quantized to the 2^m grid of the
                corresponding cube axis, Huffman + byte-coder compressed.

Spatial and frequency edits are stored separately (a frequency edit densifies
under IFFT — paper §IV-B), with the frequency stream holding interleaved
Re/Im code pairs per active component.

The GPU pipeline's exclusive prefix sum (CompactEdits) is ``np.flatnonzero``
here (host-side, as serialization is an I/O-adjacent stage).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from repro_torch.coding.bitpack import pack_bits, unpack_bits
from repro_torch.coding.lossless import lossless_compress, lossless_decompress
from repro_torch.coding.quantize import DEFAULT_QUANT_BITS, dequantize_uniform, quantize_uniform
from repro_torch.core.errors import BlobCorruptError


@dataclasses.dataclass(frozen=True)
class EncodedEdits:
    """One serialized edit stream (spatial or frequency).

    ``half_spectrum`` marks a frequency stream stored in rfft layout (last
    axis ``N//2 + 1`` of the field; ``shape`` is then the *half-spectrum*
    shape) — the decoder must reconstruct via ``irfftn``.  The flag rides in
    bit 7 of the packed header byte; pre-rfft blobs have that bit clear, so
    legacy full-spectrum streams decode unchanged.
    """

    shape: tuple
    is_complex: bool
    flags: bytes  # bit-packed nonzero mask
    payload: bytes  # lossless-compressed quantized values
    n_active: int
    quant_bits: int
    half_spectrum: bool = False

    def nbytes(self) -> int:
        # Exact serialized size: fixed header + one Q per shape dim + streams
        # (must match to_bytes(); a flat estimate here skews reported ratios).
        return len(self.flags) + len(self.payload) + struct.calcsize("<BBIQQ") + 8 * len(self.shape)

    def to_bytes(self) -> bytes:
        # packed byte: bit 0 complex, bits 1-6 quant_bits (< 64), bit 7 rfft layout
        if not 0 <= self.quant_bits < 64:
            raise ValueError(f"quant_bits={self.quant_bits} must fit in 6 header bits")
        header = struct.pack(
            "<BBIQQ",
            len(self.shape),
            (1 if self.is_complex else 0)
            | (self.quant_bits << 1)
            | (0x80 if self.half_spectrum else 0),
            self.n_active,
            len(self.flags),
            len(self.payload),
        )
        header += struct.pack(f"<{len(self.shape)}Q", *self.shape)
        return header + self.flags + self.payload

    @staticmethod
    def from_bytes(data: bytes) -> "EncodedEdits":
        try:
            ndim, packed, n_active, n_flags, n_payload = struct.unpack_from("<BBIQQ", data, 0)
            off = struct.calcsize("<BBIQQ")
            if ndim > 16:
                raise BlobCorruptError(f"corrupt edit stream: implausible rank {ndim}")
            shape = struct.unpack_from(f"<{ndim}Q", data, off)
        except struct.error as e:
            raise BlobCorruptError(f"truncated edit stream header: {e}", cause=e) from e
        off += 8 * ndim
        end = off + n_flags + n_payload
        if len(data) < end:
            raise BlobCorruptError(
                f"truncated edit stream: {len(data)} bytes, sections want {end}"
            )
        if len(data) > end:
            # every caller passes an exactly-sized slice (the container's
            # section table delimits the stream), so surplus bytes mean the
            # table and the stream disagree — corruption, not padding
            raise BlobCorruptError(
                f"corrupt edit stream: {len(data) - end} trailing byte(s) past "
                "the declared sections"
            )
        flags = data[off : off + n_flags]
        payload = data[off + n_flags : off + n_flags + n_payload]
        return EncodedEdits(
            shape=tuple(shape),
            is_complex=bool(packed & 1),
            flags=flags,
            payload=payload,
            n_active=n_active,
            quant_bits=(packed >> 1) & 0x3F,
            half_spectrum=bool(packed & 0x80),
        )


def encode_edits(
    edits: np.ndarray,
    bound,
    m: int = DEFAULT_QUANT_BITS,
    codec: str = "huffman+zlib",
    half_spectrum: bool = False,
) -> EncodedEdits:
    """Compact + quantize + losslessly compress one edit stream.

    ``bound`` may be scalar or a per-component array of the same shape as
    ``edits`` (pointwise Delta_k grids).  ``half_spectrum`` tags a frequency
    stream already living on the rfft half-spectrum (the shrunken edit
    stream of the rFFT fast path) so the decoder reconstructs via
    ``irfftn``.
    """
    edits = np.asarray(edits)
    is_complex = np.iscomplexobj(edits)
    flat = edits.ravel()
    bound = np.asarray(bound, dtype=np.float64)
    bound = bound.ravel() if bound.ndim else bound
    if is_complex:
        codes_full = np.stack(
            [quantize_uniform(flat.real, bound, m), quantize_uniform(flat.imag, bound, m)],
            axis=-1,
        )
        active = np.flatnonzero(codes_full.any(axis=-1))
        compact = codes_full[active].ravel()  # interleaved Re/Im codes
    else:
        codes_full = quantize_uniform(flat, bound, m)
        active = np.flatnonzero(codes_full)
        compact = codes_full[active]
    flags = np.zeros(flat.size, dtype=bool)
    flags[active] = True
    # Flag bitmaps are overwhelmingly sparse (Fig. 5) — deflating them takes
    # the fixed N/8-byte floor down to O(n_active) bytes (beyond-paper: the
    # paper stores the packed bitmap raw, which dominates edit storage when
    # few edits are active).
    import zlib

    return EncodedEdits(
        shape=tuple(edits.shape),
        is_complex=is_complex,
        flags=zlib.compress(pack_bits(flags), 6),
        payload=lossless_compress(compact, codec=codec),
        n_active=int(active.size),
        quant_bits=m,
        half_spectrum=half_spectrum,
    )


def decode_edits(enc: EncodedEdits, bound) -> np.ndarray:
    """Inverse of :func:`encode_edits`; returns the dense dequantized stream."""
    import zlib

    n = int(np.prod(enc.shape)) if enc.shape else 1
    try:
        flags = unpack_bits(zlib.decompress(enc.flags), n)
        active = np.flatnonzero(flags)
        codes = lossless_decompress(enc.payload)
    except BlobCorruptError:
        raise
    except Exception as e:
        # zlib.error / bad-magic ValueError / huffman garbage: the streams
        # are untrusted bytes, so every failure mode maps to one structured
        # corruption error instead of leaking codec internals
        raise BlobCorruptError(f"corrupt edit stream: {type(e).__name__}: {e}", cause=e) from e
    # Corruption that survives the entropy coder surfaces as a code count
    # that disagrees with the flag bitmap — catch it here with a structured
    # error instead of a downstream shape/broadcast crash.
    expected = 2 * active.size if enc.is_complex else active.size
    if codes.size != expected:
        raise BlobCorruptError(
            f"corrupt edit stream: {codes.size} codes for {active.size} active flags"
        )
    bound = np.asarray(bound, dtype=np.float64)
    b_active = bound.ravel()[active] if bound.ndim else bound
    if enc.is_complex:
        codes = codes.reshape(-1, 2)
        vals = dequantize_uniform(codes[:, 0], b_active, enc.quant_bits) + 1j * dequantize_uniform(
            codes[:, 1], b_active, enc.quant_bits
        )
        out = np.zeros(n, dtype=np.complex128)
    else:
        vals = dequantize_uniform(codes, b_active, enc.quant_bits)
        out = np.zeros(n, dtype=np.float64)
    out[active] = vals
    return out.reshape(enc.shape)
