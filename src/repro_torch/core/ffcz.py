"""FFCz public codec: a thin plan/execute/encode client of the CorrectionEngine.

This is the end-to-end pipeline of the paper (Fig. 4 / Alg. 1), expressed as
the three engine stages of :class:`repro_torch.core.engine.CorrectionEngine`:

  compress(x):
    1. PLAN     engine.plan_field(x, cfg)   -> bounds resolved on device,
                float32/quantization discipline applied, pointwise Delta_k
                grids built from a device rfft (and only when a bound
                actually consumes the spectrum — Delta_abs skips the
                forward FFT entirely)
    2.          base.compress(x, E_proj)    -> base blob (spatially bounded)
    3. EXECUTE  engine.execute_field(x_hat - x, plan)
                -> the device POCS loop (Hermitian rfft half-spectrum; cuFFT
                plus the fused CUDA kernels) + exact float64 host polish
    4. ENCODE   engine.encode_field(result, plan)
                -> pair-weighted adaptive bit-widths, flags + quantized +
                Huffman/zlib edit streams
    5.          byte assembly (FFCzBlob)

  decompress(blob):
    x_hat_base + spat_edits + IRFFT(freq_edits)
    (the "complete spatial edits" of §IV-B)

The class owns only what is irreducibly codec-shaped: base-compressor I/O,
post-hoc verification, and the wire format.  All bound discipline,
projection, pair-weight and bit-width math lives in the engine.  Decoding is
host numpy float64 end to end.

Wire format: blobs carry a ``FFCZ`` magic + version byte (version 1) and
length-validated section table; version-0 (magic-less) blobs from older
writers are sniffed and still decode, including legacy full-spectrum
frequency streams (``EncodedEdits.half_spectrum`` clear) via the ``ifftn``
branch of :meth:`FFCz.decompress`.  The wire format is the reference
package's, byte for byte: blobs written by either package decode under the
other.

Sharded whole fields: :meth:`FFCz.compress` of a
:class:`repro_torch.sharding.dist_fft.ShardedField` is a collective call
that every rank of the field's mesh axis makes, and every rank returns the
same blob: the field is gathered to each host (the base compressor and the
edit encoder are host codecs), PLAN and the EXECUTE loop run sharded, and a
blob of an uneven decomposition carries the optional ``FFCP`` section
(:class:`PadMeta`).  :meth:`FFCz.decompress_sharded` decodes on the host and
scatters the field to its slabs.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Any, Optional

import numpy as np

from repro_torch.coding.quantize import DEFAULT_QUANT_BITS
from repro_torch.core.cubes import rfft_shape
from repro_torch.core.edits import EncodedEdits, decode_edits
from repro_torch.core.errors import BlobCorruptError, FFCzError
from repro_torch.core.engine import (
    CorrectionEngine,
    adaptive_quant_bits,
    default_engine,
    float32_bound_discipline,
    polish_pocs_float64,
)
from repro_torch.sharding.dist_fft import ShardedField

__all__ = [
    "BlobCorruptError",
    "FFCz",
    "FFCzBlob",
    "FFCzConfig",
    "FFCzStats",
    "PadMeta",
    "ShardedField",
    "adaptive_quant_bits",
    "float32_bound_discipline",
    "polish_pocs_float64",
]


@dataclasses.dataclass(frozen=True)
class FFCzConfig:
    """User-facing dual-domain bound configuration.

    Exactly one of (E_abs, E_rel) and one of (Delta_abs, Delta_rel,
    pspec_rel) must be set.  ``pspec_rel`` activates the per-component
    power-spectrum-preserving bounds of Observation 4.
    """

    E_abs: Optional[float] = None
    E_rel: Optional[float] = 1e-3
    Delta_abs: Optional[float] = None
    Delta_rel: Optional[float] = 1e-3
    pspec_rel: Optional[float] = None
    # ROI bounds (region-aware spatial guarantees): a boolean mask (True =
    # region of interest, bound tightened to E * E_roi_scale) or a float
    # grid of per-point absolute bounds (entries <= 0 mean background E),
    # field-shaped.  See repro_torch.core.bounds.resolve_roi_bound_grid.  The
    # resolved float32 E_n grid rides the blob in an optional FFCR tail
    # section; None (default) keeps uniform-E blobs byte-identical to
    # earlier writers.
    E_roi: Optional[Any] = None
    E_roi_scale: float = 0.1
    # Floor for pointwise Delta_k, relative to max_k Delta_k.  Near-dead
    # frequency components contribute nothing to P(k); flooring their bound
    # keeps the f-cube from becoming needle-thin along dead axes, which is
    # the slow nearly-tangential POCS regime (paper §III).
    pspec_floor_rel: float = 1e-4
    quant_bits: int = DEFAULT_QUANT_BITS
    max_iters: int = 1000
    codec: str = "huffman+zlib"
    use_kernels: bool = False
    verify: bool = True
    # Over-relaxation factor for the POCS loop (1.0 = paper-faithful plain
    # alternating projection; ~1.3 converges orders of magnitude faster in
    # the nearly-tangential regime).
    relax: float = 1.0
    # POCS loop transform selector, with the reference package's names:
    # "xla" (default; plain torch.fft transforms), "packed" (pack-trick C2R
    # inverse), or "pallas" (packed + the fused CUDA clip/count epilogue
    # kernels).  See repro_torch.core.pocs / repro_torch.kernels.rfft.
    fft_impl: str = "xla"
    # Run the POCS convergence-check reduction every K-th iteration (the
    # final iteration always checks).  Extra iterations are always safe, so
    # K > 1 trades up-to-K-1 late convergence for one reduction and one
    # device-to-host read per skipped iteration.
    check_every: int = 1
    # Temporal warm start: when True, execute_field seeds the POCS loop's
    # freq_edits state from a caller-supplied previous-frame spectrum.
    # False (default) ignores any warm state — the bitwise-identical cold
    # start, so non-stream callers produce byte-identical blobs.
    warm_start: bool = False
    # Append a per-section CRC32 tail (``FFCC`` marker) to written blobs so
    # bit flips that structural validation cannot see are caught at decode.
    # Off by default: the tail changes the blob bytes, and the default path
    # stays byte-identical to earlier writers.  Decoding verifies the tail
    # whenever one is present, regardless of this flag.
    crc: bool = False
    # Derived-quantity verify-after-polish (pspec mode only): recheck in
    # float64 that every live shell's power-spectrum ratio satisfies
    # |P_hat(k)/P(k) - 1| <= pspec_rel on the decoded field, surfaced as
    # FFCzStats.pspec_shell_err / pspec_shell_ok.  Opt-in: it costs two
    # full-field float64 FFTs on the host.
    verify_pspec: bool = False

    def __post_init__(self):
        if (self.E_abs is None) == (self.E_rel is None):
            raise ValueError("exactly one of E_abs / E_rel required")
        n_freq = sum(x is not None for x in (self.Delta_abs, self.Delta_rel, self.pspec_rel))
        if n_freq != 1:
            raise ValueError("exactly one of Delta_abs / Delta_rel / pspec_rel required")
        if self.fft_impl not in ("xla", "packed", "pallas"):
            raise ValueError(
                f"fft_impl must be 'xla', 'packed' or 'pallas', got {self.fft_impl!r}"
            )
        if self.check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {self.check_every}")
        if not 0.0 < self.E_roi_scale <= 1.0:
            raise ValueError(f"E_roi_scale must be in (0, 1], got {self.E_roi_scale}")


@dataclasses.dataclass(frozen=True)
class FFCzStats:
    iterations: int
    converged: bool
    n_active_spatial: int
    n_active_frequency: int
    base_bytes: int
    edit_bytes: int
    spatial_margin: float  # min(E - |eps|) over points, >= 0 means bound held
    frequency_margin: float  # min(Delta - max(|Re d|,|Im d|)), >= 0 means held
    # Pair-weighted count of frequency components still outside the shrunk
    # f-cube after the float64 polish; 0 whenever ``converged``.  Non-zero
    # means the POCS budget ran out: the spatial bound still holds, the
    # frequency bound is violated at exactly this many components.
    final_violations: int = 0
    # Derived-quantity shell recheck (cfg.verify_pspec, pspec mode only):
    # max over live shells of |P_hat(k)/P(k) - 1| measured in float64 on the
    # decoded field, and whether it sits within the claimed pspec_rel.
    # None when the recheck did not run.
    pspec_shell_err: Optional[float] = None
    pspec_shell_ok: Optional[bool] = None
    # Host wall seconds of compress's stages: "plan", "base", "loop" (the
    # device POCS loop, which waits for the device at each convergence
    # check), "polish" (fence, device-to-host copy, float64 polish),
    # "encode" and "verify"; "execute" is loop + polish.  Port-only field;
    # None when the stats were built elsewhere.
    stage_seconds: Optional[dict] = None

    @property
    def total_bytes(self) -> int:
        return self.base_bytes + self.edit_bytes


_MAGIC = b"FFCZ"
_WIRE_VERSION = 1
_V0_HEADER = "<ddBQQQQ"  # E, Delta_scalar, ndim, len(base), len(se), len(fe), len(pw)
_PAD_MAGIC = b"FFCP"
_PAD_HEADER = "<IB"  # n_dev (u32), ndim (u8); then ndim * u64 padded shape
# Optional ROI spatial-bound section (sniffed like FFCP): u64 byte count,
# then the float32 per-point E_n grid in field shape/order.
_ROI_MAGIC = b"FFCR"
# Optional integrity tail (sniffed like FFCP): u8 count, then count * u32
# CRC32s — whole-blob-so-far, base, spat_edits, freq_edits, pointwise.
_CRC_MAGIC = b"FFCC"
_CRC_SECTIONS = ("header", "base", "spat_edits", "freq_edits", "pointwise")


@dataclasses.dataclass(frozen=True)
class PadMeta:
    """Slab-decomposition provenance of a blob written from an uneven
    :class:`~repro_torch.sharding.dist_fft.ShardedField` (mesh axis size and
    padded shape): the optional ``FFCP`` tail section, byte for byte the
    reference's.

    Purely informational: the edit streams are always encoded at the true
    field extents, so decoding never needs this.  Its absence keeps evenly
    decomposed and single-device blobs byte-identical to pre-pad writers.
    """

    n_dev: int
    padded_shape: tuple

    def to_bytes(self) -> bytes:
        return (
            _PAD_MAGIC
            + struct.pack(_PAD_HEADER, self.n_dev, len(self.padded_shape))
            + struct.pack(f"<{len(self.padded_shape)}Q", *self.padded_shape)
        )

    @staticmethod
    def from_bytes(data: bytes) -> "PadMeta":
        meta, end = PadMeta._parse_at(data, 0)
        if end != len(data):
            raise BlobCorruptError("corrupt FFCz blob: malformed pad-metadata section")
        return meta

    @staticmethod
    def _parse_at(data: bytes, pos: int) -> tuple:
        """Parse one FFCP section starting at ``pos``; returns (meta, end)."""
        head = pos + len(_PAD_MAGIC) + struct.calcsize(_PAD_HEADER)
        if len(data) < head or data[pos : pos + len(_PAD_MAGIC)] != _PAD_MAGIC:
            raise BlobCorruptError(
                "corrupt FFCz blob: trailing bytes are not a pad-metadata section"
            )
        n_dev, ndim = struct.unpack_from(_PAD_HEADER, data, pos + len(_PAD_MAGIC))
        if ndim > 16 or len(data) < head + 8 * ndim:
            raise BlobCorruptError("corrupt FFCz blob: malformed pad-metadata section")
        shape = struct.unpack_from(f"<{ndim}Q", data, head)
        return PadMeta(n_dev=n_dev, padded_shape=tuple(shape)), head + 8 * ndim


@dataclasses.dataclass(frozen=True)
class FFCzBlob:
    """Serialized FFCz compression result.

    Version-1 wire layout (what :meth:`to_bytes` writes)::

        b"FFCZ" | u8 version | <ddBQQQQ> E, Delta, ndim, nb, ns, nf, npw
        | ndim * u64 shape | base | spat_edits | freq_edits | pointwise
        [| b"FFCP" pad-metadata section] [| b"FFCR" ROI bound section]
        [| b"FFCC" CRC section]

    :meth:`from_bytes` length-validates every section against the payload
    and raises ``ValueError`` on truncated or foreign bytes.  Blobs written
    before the magic was introduced (version 0) start directly with the
    ``<ddBQQQQ>`` header; they are sniffed by the absent magic and decode
    unchanged.  The optional trailing :class:`PadMeta` section (uneven
    sharded writers only) is sniffed the same way — by its ``FFCP`` marker
    at the end of the core sections — so pad-free v1 blobs parse unchanged
    in both directions.
    """

    base_blob: bytes
    spat_edits: EncodedEdits
    # Frequency edit stream.  New blobs store the rfft half-spectrum (its
    # ``half_spectrum`` format flag set); legacy blobs store the full
    # spectrum and decode through the ifftn branch of ``FFCz.decompress``.
    freq_edits: EncodedEdits
    E: float
    Delta_scalar: float  # scalar Delta, or nan when pointwise (stored in blob)
    # float32 Delta_k grid bytes, or None; half-spectrum layout iff
    # ``freq_edits.half_spectrum`` (legacy blobs stored the full grid)
    pointwise_delta: Optional[bytes]
    shape: tuple
    stats: Optional[FFCzStats] = None
    # Optional slab-decomposition provenance (uneven sharded writers only);
    # informational — see PadMeta.
    pad_meta: Optional[PadMeta] = None
    # Optional float32 per-point spatial bound grid (ROI mode, FFCR tail
    # section; field shape/order).  SEMANTIC — unlike pad_meta/crc it is the
    # spatial bound the edits were encoded against, so decode must consume
    # it and payload_bytes() keeps it.  None for uniform-E writers (their
    # blobs stay byte-identical to pre-ROI writers).
    roi_bound: Optional[bytes] = None
    # Write (and re-write) the optional FFCC per-section CRC32 tail.  Set by
    # the parser when the section is present, so decode -> re-encode stays
    # byte-stable in both directions; blobs without the tail (every pre-CRC
    # writer) stay byte-identical.
    crc: bool = False

    def to_bytes(self) -> bytes:
        se = self.spat_edits.to_bytes()
        fe = self.freq_edits.to_bytes()
        pw = self.pointwise_delta or b""
        header = _MAGIC + struct.pack("<B", _WIRE_VERSION)
        header += struct.pack(
            _V0_HEADER,
            self.E,
            self.Delta_scalar,
            len(self.shape),
            len(self.base_blob),
            len(se),
            len(fe),
            len(pw),
        )
        header += struct.pack(f"<{len(self.shape)}Q", *self.shape)
        tail = self.pad_meta.to_bytes() if self.pad_meta is not None else b""
        if self.roi_bound is not None:
            tail += _ROI_MAGIC + struct.pack("<Q", len(self.roi_bound)) + self.roi_bound
        out = header + self.base_blob + se + fe + pw + tail
        if self.crc:
            import zlib

            crcs = [zlib.crc32(out)] + [zlib.crc32(s) for s in (self.base_blob, se, fe, pw)]
            out += _CRC_MAGIC + struct.pack("<B", len(crcs)) + struct.pack(f"<{len(crcs)}I", *crcs)
        return out

    def payload_bytes(self) -> bytes:
        """Blob bytes with the informational pad-metadata and CRC tails
        stripped — the unit of cross-backend byte parity for ``"bitwise"``
        shapes."""
        if self.pad_meta is None and not self.crc:
            return self.to_bytes()
        return dataclasses.replace(self, pad_meta=None, crc=False).to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "FFCzBlob":
        try:
            if data[:4] == _MAGIC:
                if len(data) < 5:
                    raise BlobCorruptError("truncated FFCz blob: magic without version byte")
                version = data[4]
                if version != _WIRE_VERSION:
                    raise BlobCorruptError(f"unsupported FFCz blob version {version}")
                return FFCzBlob._parse(data, offset=5)
            # version-0 sniff: magic-less blobs start directly with the header
            return FFCzBlob._parse(data, offset=0)
        except FFCzError:
            raise
        except Exception as e:
            # untrusted bytes: struct/slice/decode failures all classify as
            # corruption, never an unstructured crash
            raise BlobCorruptError(f"corrupt FFCz blob: {type(e).__name__}: {e}", cause=e) from e

    @staticmethod
    def _parse(data: bytes, offset: int) -> "FFCzBlob":
        head = struct.calcsize(_V0_HEADER)
        if len(data) < offset + head:
            raise BlobCorruptError(
                f"truncated FFCz blob: {len(data)} bytes < {offset + head}-byte header"
            )
        E, Delta, ndim, nb, ns, nf, npw = struct.unpack_from(_V0_HEADER, data, offset)
        off = offset + head
        if ndim > 16:
            raise BlobCorruptError(f"not an FFCz blob: implausible rank {ndim}")
        if len(data) < off + 8 * ndim:
            raise BlobCorruptError("truncated FFCz blob: shape table cut off")
        shape = struct.unpack_from(f"<{ndim}Q", data, off)
        off += 8 * ndim
        expected = off + nb + ns + nf + npw
        if len(data) < expected:
            raise BlobCorruptError(
                f"corrupt FFCz blob: {len(data)} bytes, section table wants {expected}"
            )
        base = data[off : off + nb]
        se_raw = data[off + nb : off + nb + ns]
        fe_raw = data[off + nb + ns : off + nb + ns + nf]
        pw = data[off + nb + ns + nf : expected] if npw else None
        # optional tail sections, each sniffed by its marker: FFCP pad
        # metadata, then the FFCR ROI bound grid, then the FFCC integrity
        # section (always last, since its leading CRC covers every byte
        # before it); any other tail bytes are corruption.  v0 and tail-free
        # v1 blobs take none of these branches.
        pad_meta, roi_bound, has_crc, pos = None, None, False, expected
        if data[pos : pos + 4] == _PAD_MAGIC:
            pad_meta, pos = PadMeta._parse_at(data, pos)
        if data[pos : pos + 4] == _ROI_MAGIC:
            if len(data) < pos + 12:
                raise BlobCorruptError("corrupt FFCz blob: truncated ROI bound section")
            (n_roi,) = struct.unpack_from("<Q", data, pos + 4)
            n_expect = 4 * (int(np.prod(shape)) if shape else 1)
            if n_roi != n_expect:
                raise BlobCorruptError(
                    f"corrupt FFCz blob: ROI bound section is {n_roi} bytes, a "
                    f"float32 grid over shape {tuple(shape)} needs {n_expect}"
                )
            if len(data) < pos + 12 + n_roi:
                raise BlobCorruptError("corrupt FFCz blob: truncated ROI bound section")
            roi_bound = data[pos + 12 : pos + 12 + n_roi]
            pos += 12 + n_roi
        if data[pos : pos + 4] == _CRC_MAGIC:
            FFCzBlob._verify_crc(data, pos, (base, se_raw, fe_raw, pw or b""))
            # fixed-size tail: magic + count byte + 5 verified u32 CRCs
            has_crc, pos = True, pos + 4 + 1 + 4 * len(_CRC_SECTIONS)
        if pos != len(data):
            raise BlobCorruptError(
                "corrupt FFCz blob: trailing bytes are not a pad-metadata, "
                "ROI-bound, or CRC section"
            )
        se = EncodedEdits.from_bytes(se_raw)
        fe = EncodedEdits.from_bytes(fe_raw)
        return FFCzBlob(
            base_blob=base,
            spat_edits=se,
            freq_edits=fe,
            E=E,
            Delta_scalar=Delta,
            pointwise_delta=pw,
            shape=tuple(shape),
            pad_meta=pad_meta,
            roi_bound=roi_bound,
            crc=has_crc,
        )

    @staticmethod
    def _verify_crc(data: bytes, pos: int, sections: tuple) -> None:
        """Validate the FFCC tail at ``pos`` against the parsed sections.

        The leading CRC covers every byte before the tail (header included);
        the per-section CRCs localize a mismatch to the corrupt section for
        the error message.
        """
        import zlib

        tail_head = pos + 4 + 1
        if len(data) < tail_head:
            raise BlobCorruptError("corrupt FFCz blob: truncated CRC section")
        n = data[pos + 4]
        if n != len(_CRC_SECTIONS) or len(data) < tail_head + 4 * n:
            raise BlobCorruptError("corrupt FFCz blob: malformed CRC section")
        stored = struct.unpack_from(f"<{n}I", data, tail_head)
        actual = (zlib.crc32(data[:pos]),) + tuple(zlib.crc32(b) for b in sections)
        if stored == actual:
            return
        # All five must match: a mismatch confined to a stored per-section CRC
        # (leading CRC fine) still means the tail bytes were flipped.
        for name, s, a in zip(_CRC_SECTIONS[1:], stored[1:], actual[1:]):
            if s != a:
                raise BlobCorruptError(f"corrupt FFCz blob: CRC mismatch in {name} section")
        raise BlobCorruptError("corrupt FFCz blob: CRC mismatch in header section")

    def nbytes(self) -> int:
        return len(self.to_bytes())


def _irfftn(a: np.ndarray, shape) -> np.ndarray:
    """numpy irfftn with explicit axes (required for odd last-axis sizes)."""
    return np.fft.irfftn(a, s=shape, axes=tuple(range(len(shape))))


class FFCz:
    """Spectrum-preserving codec wrapping an arbitrary base compressor.

    ``base`` must expose ``compress(x, E) -> bytes`` and
    ``decompress(blob) -> np.ndarray`` with a pointwise L-inf guarantee.
    ``engine`` defaults to the shared :func:`default_engine` of ``device``;
    ``device=None`` means ``"cuda"`` and raises when there is no card (pass
    ``device="cpu"`` to run the kernels' plain twins on the CPU).
    """

    def __init__(
        self,
        base: Any,
        config: FFCzConfig = FFCzConfig(),
        engine: Optional[CorrectionEngine] = None,
        device=None,
    ):
        self.base = base
        self.config = config
        if engine is not None and device is not None:
            raise ValueError("pass either an engine or a device: the engine owns its device")
        self.engine = engine if engine is not None else default_engine(device)

    # -- compression ------------------------------------------------------

    def compress(self, x) -> FFCzBlob:
        cfg = self.config
        sharded = isinstance(x, ShardedField)
        clock = [time.perf_counter()]
        x32 = x.to_host() if sharded else np.asarray(x, dtype=np.float32)

        plan = self.engine.plan_field(x if sharded else x32, cfg)
        clock.append(time.perf_counter())
        base_blob = self.base.compress(x32, plan.E_proj)
        x_hat = np.asarray(self.base.decompress(base_blob), dtype=np.float32)
        clock.append(time.perf_counter())

        eps0 = x_hat - x32
        if sharded:
            eps0 = ShardedField(eps0, x.mesh, x.axis_name, overlap_chunks=x.overlap_chunks)
        handle = self.engine.execute_field_async(eps0, plan)
        clock.append(time.perf_counter())
        result = handle.result()
        clock.append(time.perf_counter())
        se, fe = self.engine.encode_field(result, plan)
        clock.append(time.perf_counter())

        # provenance of an uneven slab decomposition (ignored by decompress)
        pad_meta = None
        if sharded and x.padded_shape != x.shape:
            pad_meta = PadMeta(n_dev=x.n_dev, padded_shape=x.padded_shape)

        blob = FFCzBlob(
            base_blob=base_blob,
            spat_edits=se,
            freq_edits=fe,
            E=plan.E,
            Delta_scalar=plan.delta_scalar,
            pointwise_delta=plan.pointwise_bytes(),
            shape=plan.shape,
            pad_meta=pad_meta,
            roi_bound=plan.roi_bytes(),
            crc=cfg.crc,
        )

        stats = None
        if cfg.verify:
            stats = self.verify_stats(blob, x32, result, plan=plan)
            clock.append(time.perf_counter())
            stages = ("plan", "base", "loop", "polish", "encode", "verify")
            seconds = {k: b - a for k, a, b in zip(stages, clock, clock[1:])}
            seconds["execute"] = seconds["loop"] + seconds["polish"]
            stats = dataclasses.replace(stats, stage_seconds=seconds)
        return dataclasses.replace(blob, stats=stats)

    def verify_stats(self, blob: FFCzBlob, x32: np.ndarray, result, plan=None) -> FFCzStats:
        """Decode ``blob`` back and measure both bound margins against ``x32``.

        Factored out of :meth:`compress` so the serving layer can verify a
        blob it assembled through the staged engine path (plan / execute /
        encode) without re-running compression; ``plan`` is recomputed when
        the caller no longer holds it (planning is deterministic).
        """
        if plan is None:
            plan = self.engine.plan_field(x32, self.config)
        x_final = self.decompress(blob)
        eps = x_final.astype(np.float64) - x32.astype(np.float64)
        # half-spectrum check is exhaustive: every full-spectrum component
        # shares |Re|/|Im| (and its Delta_k) with its conjugate image here
        d = np.fft.rfftn(eps)
        if blob.roi_bound is not None:
            # ROI mode: the margin is against the STORED per-point grid, so
            # a held bound means every region's own E_n held, not just the
            # global envelope
            grid64 = np.frombuffer(blob.roi_bound, dtype=np.float32).reshape(
                blob.shape
            ).astype(np.float64)
            spatial_margin = float(np.min(grid64 - np.abs(eps)))
        else:
            spatial_margin = float(plan.E - np.max(np.abs(eps)))
        freq_excess = np.maximum(np.abs(d.real), np.abs(d.imag)) - np.asarray(plan.Delta)
        frequency_margin = float(-np.max(freq_excess))
        pspec_shell_err = pspec_shell_ok = None
        cfg = self.config
        if cfg.verify_pspec and cfg.pspec_rel is not None:
            from repro_torch.core.spectrum import shell_ratio_error

            pspec_shell_err = float(shell_ratio_error(x_final, x32))
            pspec_shell_ok = bool(pspec_shell_err <= cfg.pspec_rel)
        return FFCzStats(
            iterations=result.iterations,
            converged=result.converged,
            n_active_spatial=blob.spat_edits.n_active,
            n_active_frequency=blob.freq_edits.n_active,
            base_bytes=len(blob.base_blob),
            edit_bytes=blob.spat_edits.nbytes() + blob.freq_edits.nbytes(),
            spatial_margin=spatial_margin,
            frequency_margin=frequency_margin,
            final_violations=result.final_violations,
            pspec_shell_err=pspec_shell_err,
            pspec_shell_ok=pspec_shell_ok,
        )

    # -- decompression ----------------------------------------------------

    def decompress(self, blob: FFCzBlob) -> np.ndarray:
        try:
            return self._decompress(blob)
        except FFCzError:
            raise
        except Exception as e:
            # decode consumes untrusted bytes end to end: any failure past
            # structural validation (codec garbage that entropy-decodes to the
            # wrong element count, off-shape buffers) is still corruption
            raise BlobCorruptError(f"corrupt FFCz blob: {type(e).__name__}: {e}", cause=e) from e

    def _decompress(self, blob: FFCzBlob) -> np.ndarray:
        x_hat = np.asarray(self.base.decompress(blob.base_blob), dtype=np.float32)
        if x_hat.shape != tuple(blob.shape):
            raise BlobCorruptError(
                f"corrupt FFCz blob: base section decodes to shape {x_hat.shape}, "
                f"header says {tuple(blob.shape)}"
            )
        half = blob.freq_edits.half_spectrum
        if blob.pointwise_delta is not None:
            # pointwise Delta_k grid, stored in the blob (Observation 4 mode);
            # half-spectrum layout in rfft-era blobs, full grid in legacy ones
            dshape = rfft_shape(blob.shape) if half else blob.shape
            Delta = np.frombuffer(blob.pointwise_delta, dtype=np.float32).reshape(dshape)
        else:
            Delta = blob.Delta_scalar
        if blob.roi_bound is not None:
            # per-point E_n grid (ROI mode): the spatial stream was quantized
            # against the stored grid, so decode must use the same values
            E_dec = np.frombuffer(blob.roi_bound, dtype=np.float32).reshape(blob.shape)
        else:
            E_dec = blob.E
        spat = decode_edits(blob.spat_edits, E_dec)
        freq = decode_edits(blob.freq_edits, Delta)
        if half:
            freq_spatial = _irfftn(freq, blob.shape)
        else:
            # legacy full-spectrum blob (pre-rfft format flag)
            freq_spatial = np.fft.ifftn(freq).real
        complete = spat + freq_spatial  # complete spatial edits (§IV-B)
        return (x_hat.astype(np.float64) + complete).astype(np.float32)

    def decompress_sharded(
        self,
        blob: FFCzBlob,
        mesh=None,
        axis_name: str = "data",
        parity="auto",
    ) -> ShardedField:
        """Decode a blob to a field slab-sharded over ``mesh[axis_name]``.

        Decoding is host float64 (the stored bounds verify exactly only
        there); the field is then scattered to its slabs, so ``to_host()``
        is bitwise :meth:`decompress`.  Every rank of the axis decodes.
        ``mesh=None`` takes a 1-D mesh over the default process group.  A
        blob's :class:`PadMeta` is not consulted: the target decomposition
        comes from ``mesh``, which need not match the writer's.  ``parity``
        selects nothing (see :class:`ShardedField`).
        """
        x = self.decompress(blob)
        return ShardedField.shard(x, mesh, axis_name=axis_name, parity=parity)

    def roundtrip(self, x):
        blob = self.compress(x)
        return self.decompress(blob), blob
