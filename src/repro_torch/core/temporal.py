"""Temporal stream codec: predictor residuals + POCS warm start (docs/streaming.md).

Every target domain produces *sequences* — cosmology snapshots, combustion
timesteps, EEG channels x time — yet one :class:`~repro_torch.core.ffcz.FFCz` call
compresses a single frame from scratch.  :class:`TemporalCodec` is the engine
client that exploits the time axis, three ways:

  residuals     frame *t* is compressed as ``r_t = x_t - predict(decoded
                history)`` — the predictor (``identity`` hold or ``linear``
                extrapolation) is evaluated on the DECODED previous frames,
                never the originals, so quantization error cannot accumulate
                along the chain (the stream is self-correcting: encoder and
                decoder walk bitwise-identical histories).
  warm start    the POCS while_loop of frame *t* seeds its ``freq_edits``
                accumulator from frame *t-1*'s converged edit spectrum
                (``FFCzConfig.warm_start`` -> ``FieldPlan`` ->
                :func:`repro_torch.core.pocs.alternating_projection`, both
                backends).  Consecutive frames' base-compressor errors are
                correlated, so the warm loop re-converges in a fraction of
                the cold iteration count (``chip_smoke.py``'s ``stream_field``
                phase prints both).  Encoder-side only: it changes iteration counts, never
                decodability or the bound guarantee, and ``warm_start=False``
                is bitwise-neutral (cold frames byte-identical to FFCz).
  pencil mode   EEG-style channels-x-time data routes through the engine's
                pencil ``correct_batch`` path (one pencil per channel by
                default), with per-block warm spectra threaded the same way.

Bound semantics: the stream claims ONE dual bound (E, Delta), resolved on
frame 0 and recorded in the container header; every frame — keyframe or
residual — reconstructs within it.  Residual frames compress against
slack-shrunk absolute bounds (``E - O(u32 * amax)``, ``Delta - O(u32 * l2)``,
the same 4-sigma float32 discipline as :func:`float32_bound_discipline`)
because reconstruction adds two more float32 roundings: the residual cast
``r32 = f32(x - pred)`` and the frame cast ``x_hat = f32(pred + r_hat)``.
``|x_hat - x| = |(pred + r_hat) - (pred + r)|`` by linearity, so the
residual-domain guarantee transfers to the frame.  Pointwise ``pspec`` bounds
are frame-dependent grids and are rejected for streams.

Wire format (``FFCS``, the :class:`~repro_torch.core.ffcz.FFCzBlob` sibling
container)::

    b"FFCS" | u8 version
    | <BBIIddB> mode, predictor, keyframe_interval, n_frames, E, Delta, ndim
    | ndim * u64 frame shape | u32 block (0 in field mode)
    | n_frames * <QQB> frame (offset, length, flags: bit0 = keyframe)
    | u32 CRC32 of every preceding byte
    | concatenated frame payloads

The per-frame offset index makes the stream seekable: decode any frame by
walking forward from the latest keyframe at or before it
(:meth:`TemporalCodec.decode_frame`), without touching earlier bytes.
Keyframes recur every ``keyframe_interval`` frames and are resync points:
the predictor history (and the decode chain) restarts there, so a seek
decode is bitwise identical to the full sequential decode — gated by
tests/test_temporal.py.  Frame payloads are self-describing: whole-field
frames are ordinary ``FFCZ`` blobs, pencil frames the ``FFSB`` envelope
(defined here, shared with :class:`~repro_torch.serving.ffcz_service.FFCzService`
pencil responses).

Streaming submission goes through ``FFCzService.submit_stream`` — one stream
is one unit of work, so per-stream frame order is trivially preserved across
the FRONT/BACK pipeline while other units still overlap.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.edits import EncodedEdits, decode_edits
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.core.errors import (
    BlobCorruptError,
    FFCzError,
    InfeasibleBound,
    StreamStateError,
)
from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig

__all__ = [
    "StreamEncoder",
    "TemporalCodec",
    "TemporalConfig",
    "TemporalStream",
    "decode_pencil_blob",
]

# -- pencil frame envelope (FFSB) -------------------------------------------
#
# One pencil-planned tensor: magic, version, <ddIB> E/Delta/block/ndim,
# ndim * u64 shape, <QQQ> section lengths, sections, trailing u32 CRC32 of
# every preceding byte.  A new wire format (no legacy writers), so the CRC
# is unconditional.  Shared with the serving layer's pencil responses
# (repro_torch.serving.ffcz_service re-exports the decoder).

_PENCIL_MAGIC = b"FFSB"
_PENCIL_VERSION = 1
_PENCIL_HEADER = "<ddIB"


def _pencil_blob(shape, base_blob: bytes, se, fe, plan, block: int) -> bytes:
    se_b, fe_b = se.to_bytes(), fe.to_bytes()
    out = _PENCIL_MAGIC + struct.pack("<B", _PENCIL_VERSION)
    out += struct.pack(_PENCIL_HEADER, plan.E, plan.Delta, block, len(shape))
    out += struct.pack(f"<{len(shape)}Q", *shape)
    out += struct.pack("<QQQ", len(base_blob), len(se_b), len(fe_b))
    out += base_blob + se_b + fe_b
    return out + struct.pack("<I", zlib.crc32(out))


def decode_pencil_blob(data: bytes, base: Any) -> np.ndarray:
    """Hardened decode of the pencil envelope (``FFSB``).

    Every malformation — bad magic/version, truncation, section overrun,
    CRC mismatch, codec garbage — raises :class:`BlobCorruptError`.
    """
    try:
        if data[:4] != _PENCIL_MAGIC:
            raise BlobCorruptError("not an FFCz service pencil blob: bad magic")
        if len(data) < 9 or data[4] != _PENCIL_VERSION:
            raise BlobCorruptError(
                f"unsupported service pencil blob version {data[4] if len(data) > 4 else '?'}"
            )
        if len(data) < 4 + 1 + 4:
            raise BlobCorruptError("truncated service pencil blob")
        body, (crc,) = data[:-4], struct.unpack_from("<I", data, len(data) - 4)
        if zlib.crc32(body) != crc:
            raise BlobCorruptError("corrupt service pencil blob: CRC mismatch")
        off = 5
        E, Delta, block, ndim = struct.unpack_from(_PENCIL_HEADER, body, off)
        off += struct.calcsize(_PENCIL_HEADER)
        if ndim > 16:
            raise BlobCorruptError(f"corrupt service pencil blob: implausible rank {ndim}")
        shape = struct.unpack_from(f"<{ndim}Q", body, off)
        off += 8 * ndim
        nb, ns, nf = struct.unpack_from("<QQQ", body, off)
        off += struct.calcsize("<QQQ")
        if len(body) != off + nb + ns + nf:
            raise BlobCorruptError(
                f"corrupt service pencil blob: {len(body)} bytes, sections want {off + nb + ns + nf}"
            )
        base_blob = body[off : off + nb]
        se = EncodedEdits.from_bytes(body[off + nb : off + nb + ns])
        fe = EncodedEdits.from_bytes(body[off + nb + ns : off + nb + ns + nf])
        x_hat = np.asarray(base.decompress(base_blob), dtype=np.float32)
        spat = decode_edits(se, E)
        freq = decode_edits(fe, Delta)
        complete = spat + np.fft.irfft(freq, n=block, axis=-1)
        size = int(np.prod(shape)) if shape else 1
        x = x_hat.astype(np.float64).reshape(-1) + complete.reshape(-1)[:size]
        return x.reshape(shape).astype(np.float32)
    except FFCzError:
        raise
    except Exception as e:  # noqa: BLE001 - untrusted bytes
        raise BlobCorruptError(
            f"corrupt service pencil blob: {type(e).__name__}: {e}", cause=e
        ) from e


# -- stream container (FFCS) ------------------------------------------------

_STREAM_MAGIC = b"FFCS"
_STREAM_VERSION = 1
# mode, predictor, keyframe_interval, n_frames, E, Delta, ndim
_STREAM_HEADER = "<BBIIddB"
_FRAME_ENTRY = "<QQB"  # payload offset (frames-relative), length, flags
_FLAG_KEYFRAME = 0x01

_MODES = ("field", "pencils")
_PREDICTORS = ("identity", "linear")


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    """Stream-shaped knobs of one :class:`TemporalCodec` (bound knobs stay in
    :class:`~repro_torch.core.ffcz.FFCzConfig`, including ``warm_start``).

    ``predictor``: ``"identity"`` (zero-order hold) or ``"linear"``
    (two-point extrapolation ``2*x[t-1] - x[t-2]``, falling back to identity
    when only one frame of history exists — i.e. right after a keyframe).
    ``keyframe_interval``: every K-th frame is a self-contained keyframe and
    resync point (1 = every frame, degenerating to per-frame FFCz).
    ``mode``: ``"field"`` (whole-field frames) or ``"pencils"`` (the
    blockwise path; EEG-style channels x time).  ``block``: pencil length in
    pencils mode; 0 picks the frame's last-axis extent (one pencil per
    channel row).
    """

    predictor: str = "linear"
    keyframe_interval: int = 8
    mode: str = "field"
    block: int = 0

    def __post_init__(self):
        if self.predictor not in _PREDICTORS:
            raise ValueError(f"predictor must be one of {_PREDICTORS}, got {self.predictor!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.keyframe_interval < 1:
            raise ValueError(f"keyframe_interval must be >= 1, got {self.keyframe_interval}")
        if self.block < 0:
            raise ValueError(f"block must be >= 0, got {self.block}")


@dataclasses.dataclass(frozen=True)
class TemporalStream:
    """Parsed ``FFCS`` container: header + seek index + frame payload bytes.

    ``E``/``Delta`` are the stream-level claimed bounds (resolved on frame 0
    at encode time); ``entries[i]`` is ``(offset, length, keyframe)`` with
    offsets relative to the frames section.  Purely structural — decoding a
    frame still validates its payload through the frame format's own parser.
    """

    mode: str
    predictor: str
    keyframe_interval: int
    E: float
    Delta: float
    shape: Tuple[int, ...]
    block: int
    entries: Tuple[Tuple[int, int, bool], ...]
    data: bytes = dataclasses.field(repr=False)
    frames_base: int = 0

    @property
    def n_frames(self) -> int:
        return len(self.entries)

    def is_keyframe(self, t: int) -> bool:
        return self.entries[t][2]

    def latest_keyframe(self, t: int) -> int:
        """Index of the closest keyframe at or before frame ``t`` — the seek
        entry point for decoding frame ``t`` without earlier bytes."""
        for i in range(t, -1, -1):
            if self.entries[i][2]:
                return i
        raise BlobCorruptError("corrupt FFCS stream: no keyframe precedes the target frame")

    def frame_payload(self, t: int) -> bytes:
        off, length, _ = self.entries[t]
        start = self.frames_base + off
        return self.data[start : start + length]

    @staticmethod
    def from_bytes(data: bytes) -> "TemporalStream":
        try:
            if data[:4] != _STREAM_MAGIC:
                raise BlobCorruptError("not an FFCS stream: bad magic")
            if len(data) < 5 or data[4] != _STREAM_VERSION:
                raise BlobCorruptError(
                    f"unsupported FFCS stream version {data[4] if len(data) > 4 else '?'}"
                )
            off = 5
            head = struct.calcsize(_STREAM_HEADER)
            if len(data) < off + head:
                raise BlobCorruptError("truncated FFCS stream: header cut off")
            mode_id, pred_id, interval, n_frames, E, Delta, ndim = struct.unpack_from(
                _STREAM_HEADER, data, off
            )
            off += head
            if mode_id >= len(_MODES):
                raise BlobCorruptError(f"corrupt FFCS stream: unknown mode id {mode_id}")
            if pred_id >= len(_PREDICTORS):
                raise BlobCorruptError(f"corrupt FFCS stream: unknown predictor id {pred_id}")
            if interval < 1:
                raise BlobCorruptError("corrupt FFCS stream: keyframe interval 0")
            if ndim > 16:
                raise BlobCorruptError(f"not an FFCS stream: implausible rank {ndim}")
            if len(data) < off + 8 * ndim + 4:
                raise BlobCorruptError("truncated FFCS stream: shape table cut off")
            shape = struct.unpack_from(f"<{ndim}Q", data, off)
            off += 8 * ndim
            (block,) = struct.unpack_from("<I", data, off)
            off += 4
            entry = struct.calcsize(_FRAME_ENTRY)
            index_end = off + n_frames * entry
            if len(data) < index_end + 4:
                raise BlobCorruptError("truncated FFCS stream: seek index cut off")
            (crc,) = struct.unpack_from("<I", data, index_end)
            if zlib.crc32(data[:index_end]) != crc:
                raise BlobCorruptError("corrupt FFCS stream: header/index CRC mismatch")
            frames_base = index_end + 4
            entries = []
            for i in range(n_frames):
                foff, flen, flags = struct.unpack_from(_FRAME_ENTRY, data, off + i * entry)
                if frames_base + foff + flen > len(data):
                    raise BlobCorruptError(
                        f"corrupt FFCS stream: frame {i} overruns the payload section"
                    )
                entries.append((foff, flen, bool(flags & _FLAG_KEYFRAME)))
            if entries and not entries[0][2]:
                raise BlobCorruptError("corrupt FFCS stream: first frame is not a keyframe")
            return TemporalStream(
                mode=_MODES[mode_id],
                predictor=_PREDICTORS[pred_id],
                keyframe_interval=interval,
                E=E,
                Delta=Delta,
                shape=tuple(int(s) for s in shape),
                block=block,
                entries=tuple(entries),
                data=bytes(data),
                frames_base=frames_base,
            )
        except FFCzError:
            raise
        except Exception as e:  # noqa: BLE001 - untrusted bytes
            raise BlobCorruptError(
                f"corrupt FFCS stream: {type(e).__name__}: {e}", cause=e
            ) from e


def _predict(history: Sequence[np.ndarray], predictor: str) -> np.ndarray:
    """Evaluate the frame predictor on the decoded history, in float64.

    float64 on float32 inputs makes ``2*a - b`` effectively exact, so the
    encoder and decoder (walking identical histories) compute bitwise-equal
    predictions.  Falls back to identity with a single frame of history —
    deterministically, so both sides fall back together.
    """
    if predictor == "identity" or len(history) < 2:
        return history[-1].astype(np.float64)
    return 2.0 * history[-1].astype(np.float64) - history[-2].astype(np.float64)


# -- the codec ---------------------------------------------------------------


class StreamEncoder:
    """Incremental encoder state for one stream (create via
    :meth:`TemporalCodec.open_stream`).

    :meth:`add_frame` compresses one frame and returns its payload bytes;
    :meth:`finish` assembles the ``FFCS`` container.  Encoder state (decoded
    history, warm spectrum, frame list) mutates only after a frame fully
    succeeds, so a failed ``add_frame`` can be retried — the serving layer's
    per-frame retry ladder relies on this.  ``finish()`` is terminal:
    ``add_frame`` after it (or a second ``finish()``) raises
    :class:`~repro_torch.core.errors.StreamStateError` instead of silently
    mutating/re-emitting against committed state — the session layer's
    finalize-vs-append serialization depends on this invariant.

    ``frame_stats`` records, per frame, ``{"keyframe", "iterations",
    "converged"}`` — ``chip_smoke.py`` reads the iteration counts.
    :meth:`export_state` snapshots the committed state as plain data; the
    matching import hook is :meth:`TemporalCodec.restore_stream` (session
    crash recovery / spill-resume).
    """

    def __init__(self, codec: "TemporalCodec"):
        self._codec = codec
        self._frames: List[Tuple[bytes, bool]] = []
        self._history: List[np.ndarray] = []
        self._warm: Optional[Any] = None
        self._shape: Optional[Tuple[int, ...]] = None
        self._block = 0
        self._E0: Optional[float] = None
        self._Delta0: Optional[float] = None
        self._finished = False
        self.frame_stats: List[dict] = []

    @property
    def n_frames(self) -> int:
        return len(self._frames)

    @property
    def finished(self) -> bool:
        return self._finished

    @property
    def history_nbytes(self) -> int:
        """Resident decoded-history footprint — what session spill eviction
        reclaims (payload bytes stay journaled, not resident)."""
        return int(sum(h.nbytes for h in self._history))

    def export_state(self) -> dict:
        """The committed stream state as plain data: frame payloads + the
        scalars :meth:`TemporalCodec.restore_stream` needs to rebuild a live
        encoder.  Decoded history and the warm spectrum are derived state and
        deliberately excluded — history re-decodes bitwise from the payloads,
        and the first post-restore frame runs cold (bound-conformant either
        way; bitwise-identical under the default ``warm_start=False``)."""
        return {
            "frames": list(self._frames),
            "shape": self._shape,
            "block": self._block,
            "E0": self._E0,
            "Delta0": self._Delta0,
        }

    def add_frame(self, x: np.ndarray) -> bytes:
        if self._finished:
            raise StreamStateError(
                "add_frame on a finished stream: finish() already assembled "
                "the container",
                stage="encode",
            )
        codec = self._codec
        x32 = np.asarray(x, dtype=np.float32)
        if x32.size == 0:
            raise ValueError("cannot compress an empty frame")
        if self._shape is None:
            self._shape = x32.shape
            self._block = codec._resolve_block(x32.shape)
        elif x32.shape != self._shape:
            raise ValueError(
                f"stream frames must share one shape: got {x32.shape}, stream is {self._shape}"
            )
        t = len(self._frames)
        is_key = t % codec.stream.keyframe_interval == 0
        warm = self._warm if codec.config.warm_start else None
        if is_key:
            payload, decoded, warm_next, iters, conv = codec._compress_key(
                self, x32, first=(t == 0), warm=None  # keyframes restart cold
            )
            history = [decoded]  # resync: the predictor chain restarts here
        else:
            pred = _predict(self._history, codec.stream.predictor)
            r32 = (x32.astype(np.float64) - pred).astype(np.float32)
            E_res, D_res = codec._residual_bounds(x32, pred, self._E0, self._Delta0, self._block)
            payload, r_hat, warm_next, iters, conv = codec._compress_frame(
                r32, E_res, D_res, self._block, warm
            )
            decoded = (pred + r_hat.astype(np.float64)).astype(np.float32)
            history = (self._history + [decoded])[-2:]
        # commit point: nothing above mutated encoder state
        self._frames.append((payload, is_key))
        self._history = history
        self._warm = warm_next
        self.frame_stats.append({"keyframe": is_key, "iterations": iters, "converged": conv})
        return payload

    def finish(self) -> bytes:
        if self._finished:
            raise StreamStateError(
                "finish() called twice on one stream: the container was "
                "already assembled",
                stage="encode",
            )
        if not self._frames:
            raise ValueError("cannot finish an empty stream")
        codec = self._codec
        header = _STREAM_MAGIC + struct.pack("<B", _STREAM_VERSION)
        header += struct.pack(
            _STREAM_HEADER,
            _MODES.index(codec.stream.mode),
            _PREDICTORS.index(codec.stream.predictor),
            codec.stream.keyframe_interval,
            len(self._frames),
            float(self._E0),
            float(self._Delta0),
            len(self._shape),
        )
        header += struct.pack(f"<{len(self._shape)}Q", *self._shape)
        header += struct.pack("<I", self._block if codec.stream.mode == "pencils" else 0)
        off = 0
        index = b""
        for payload, is_key in self._frames:
            flags = _FLAG_KEYFRAME if is_key else 0
            index += struct.pack(_FRAME_ENTRY, off, len(payload), flags)
            off += len(payload)
        head = header + index
        head += struct.pack("<I", zlib.crc32(head))
        self._finished = True
        return head + b"".join(p for p, _ in self._frames)


class TemporalCodec:
    """Predictor-residual stream codec over the shared CorrectionEngine.

    ``base``/``config``/``engine`` as in :class:`~repro_torch.core.ffcz.FFCz`
    (``config.warm_start`` enables the POCS warm start); ``stream`` holds the
    stream-shaped knobs (:class:`TemporalConfig`).  ``pspec_rel`` bounds are
    rejected: a pointwise grid resolved per frame would change the claimed
    bound mid-stream.

    Encoding: :meth:`compress_stream` (whole sequence) or
    :meth:`open_stream` + ``add_frame`` (incremental, what the service stream
    kind drives).  Decoding: :meth:`decompress_stream` (all frames) or
    :meth:`decode_frame` (seek: walks forward from the latest keyframe at or
    before the target).  Decoding is driven entirely by the container header
    — a codec constructed with any stream config decodes any stream.

    Device work goes through the engine (``engine``, or the shared
    :func:`default_engine` of ``device``; ``None`` means ``"cuda"`` and raises
    without a card).  The warm spectrum stays a tensor on the engine's device
    between frames: in pencil mode it is the device loop's own edit spectrum
    (as the reference's), which never leaves the card; in field mode it is
    the float64 polish's spectrum (the reference's ``result.freq``, made on
    the host), cast to complex64 and copied to the device once, when its
    frame commits.
    """

    def __init__(
        self,
        base: Any,
        config: FFCzConfig = FFCzConfig(),
        stream: TemporalConfig = TemporalConfig(),
        engine: Optional[CorrectionEngine] = None,
        device=None,
    ):
        if config.pspec_rel is not None:
            raise ValueError(
                "pspec bounds are per-frame pointwise grids and cannot back a "
                "stream-level bound claim; use Delta_abs or Delta_rel"
            )
        if engine is not None and device is not None:
            raise ValueError("pass either an engine or a device: the engine owns its device")
        self.base = base
        self.config = config
        self.stream = stream
        self.engine = engine if engine is not None else default_engine(device)
        self._ffcz = FFCz(base, config, engine=self.engine)

    # -- encode ------------------------------------------------------------

    def open_stream(self) -> StreamEncoder:
        return StreamEncoder(self)

    def restore_stream(
        self,
        frames: Sequence[Tuple[bytes, bool]],
        *,
        shape: Sequence[int],
        block: int = 0,
        E0: float,
        Delta0: float,
    ) -> StreamEncoder:
        """Rebuild a live :class:`StreamEncoder` from committed frame
        payloads — the state-import hook behind session crash recovery and
        spill-resume (the matching export is
        :meth:`StreamEncoder.export_state`).

        ``frames`` is the committed ``(payload, is_keyframe)`` list; ``shape``
        / ``block`` / ``E0`` / ``Delta0`` are the stream scalars resolved on
        frame 0.  The predictor history is re-decoded from the latest
        keyframe forward (the only frames a continuation depends on) — the
        same chain the decoder walks, so appends to the restored encoder are
        bitwise-identical to appends to the uninterrupted one.  The warm
        spectrum is not restorable state: the first post-restore frame runs
        cold (identical bytes under the default ``warm_start=False``).

        Raises :class:`BlobCorruptError` when a payload in the replayed chain
        does not decode, and when the keyframe flags disagree with this
        codec's ``keyframe_interval`` (a journal from a different stream
        config must not be silently continued).
        """
        frames = [(bytes(p), bool(k)) for p, k in frames]
        if not frames:
            raise ValueError("cannot restore an empty stream; open a fresh one")
        interval = self.stream.keyframe_interval
        for t, (_payload, is_key) in enumerate(frames):
            if is_key != (t % interval == 0):
                raise BlobCorruptError(
                    f"restored frame {t} keyframe flag disagrees with "
                    f"keyframe_interval={interval}: the journal belongs to a "
                    "different stream config"
                )
        shape = tuple(int(s) for s in shape)
        block = int(block) if self.stream.mode == "pencils" else 0
        if self.stream.mode == "pencils" and block == 0:
            block = self._resolve_block(shape)
        k = max(t for t, (_p, key) in enumerate(frames) if key)
        history: List[np.ndarray] = []
        for t in range(k, len(frames)):
            payload, is_key = frames[t]
            decoded = self._decode_payload_raw(payload, self.stream.mode, shape)
            if is_key:
                history = [decoded]
            else:
                pred = _predict(history, self.stream.predictor)
                x = (pred + decoded.astype(np.float64)).astype(np.float32)
                history = (history + [x])[-2:]
        enc = self.open_stream()
        enc._frames = frames
        enc._history = history
        enc._warm = None
        enc._shape = shape
        enc._block = block
        enc._E0 = float(E0)
        enc._Delta0 = float(Delta0)
        enc.frame_stats = [
            {"keyframe": key, "iterations": 0, "converged": None, "restored": True}
            for _p, key in frames
        ]
        return enc

    def compress_stream(self, frames: Sequence[np.ndarray]) -> bytes:
        """Compress a whole sequence into one ``FFCS`` container."""
        enc = self.open_stream()
        for x in frames:
            enc.add_frame(x)
        return enc.finish()

    def _resolve_block(self, shape: Tuple[int, ...]) -> int:
        if self.stream.mode != "pencils":
            return 0
        return self.stream.block or int(shape[-1])

    def _residual_bounds(self, x32, pred, E0: float, Delta0: float, block: int):
        """Slack-shrunk absolute bounds for one residual frame.

        Reconstruction adds two float32 roundings beyond the codec's own
        guarantee (``r32 = f32(x - pred)`` and ``x_hat = f32(pred +
        r_hat)``): each perturbs points by O(u32 * amax) and — after the
        FFT — frequency components by O(u32 * l2) (4-sigma statistical
        budget, mirroring :func:`float32_bound_discipline`).  Shrinking the
        residual-domain bounds by that slack keeps the frame within the
        stream's claimed (E0, Delta0).
        """
        u32 = float(np.finfo(np.float32).eps)
        amax = float(max(np.max(np.abs(x32)), np.max(np.abs(pred))))
        slack_s = 4.0 * u32 * (amax + E0)
        if self.stream.mode == "pencils":
            flat = np.asarray(x32, dtype=np.float64).reshape(-1)
            tiles = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
            l2ref = float(np.sqrt((tiles * tiles).sum(axis=-1).max()))
        else:
            x64 = np.asarray(x32, dtype=np.float64)
            l2ref = float(np.sqrt(np.sum(x64 * x64)))
        slack_f = 8.0 * u32 * l2ref
        E_res, D_res = E0 - slack_s, Delta0 - slack_f
        if E_res <= 0 or D_res <= 0:
            raise InfeasibleBound(
                f"stream bounds (E={E0:g}, Delta={Delta0:g}) leave no room for the "
                f"residual-frame float32 cast slack at this frame's magnitude",
                stage="plan",
            )
        return E_res, D_res

    def _compress_key(self, enc: StreamEncoder, x32, first: bool, warm):
        """Keyframe: compress the frame itself; frame 0 also resolves the
        stream-level bounds (later keyframes pin them absolutely so the
        claim cannot drift with per-frame ranges)."""
        cfg = self.config
        if self.stream.mode == "pencils":
            if first:
                plan = self.engine.plan_pencils(
                    x32,
                    E_rel=cfg.E_rel,
                    Delta_rel=cfg.Delta_rel,
                    E_abs=cfg.E_abs,
                    Delta_abs=cfg.Delta_abs,
                    block=enc._block,
                    quant_bits=cfg.quant_bits,
                )
                if plan is None:
                    raise InfeasibleBound(
                        "stream spatial bound underflows float32 for frame 0", stage="plan"
                    )
                enc._E0, enc._Delta0 = plan.E, plan.Delta
            payload, decoded, warm_next, iters, conv = self._compress_frame(
                x32, enc._E0, enc._Delta0, enc._block, warm
            )
            return payload, decoded, warm_next, iters, conv
        if first:
            run_cfg = cfg
        else:
            run_cfg = dataclasses.replace(
                cfg, E_abs=enc._E0, E_rel=None, Delta_abs=enc._Delta0, Delta_rel=None,
                pspec_rel=None,
            )
        plan = self.engine.plan_field(x32, run_cfg)
        if first:
            enc._E0, enc._Delta0 = plan.E, float(plan.Delta)
        return self._compress_field(x32, plan, warm)

    def _compress_field(self, data32, plan, warm):
        """Base codec, EXECUTE (warm-started when ``warm`` is given and the
        plan allows it), ENCODE and the ``FFCZ`` blob of one field frame;
        returns ``(payload, decoded, warm_next, iterations, converged)``."""
        base_blob = self.base.compress(data32, plan.E_proj)
        x_hat = np.asarray(self.base.decompress(base_blob), dtype=np.float32)
        result = self.engine.execute_field(x_hat - data32, plan, warm_freq=warm)
        se, fe = self.engine.encode_field(result, plan)
        blob = FFCzBlob(
            base_blob=base_blob,
            spat_edits=se,
            freq_edits=fe,
            E=plan.E,
            Delta_scalar=plan.delta_scalar,
            pointwise_delta=plan.pointwise_bytes(),
            shape=plan.shape,
            crc=self.config.crc,
        )
        decoded = self._ffcz.decompress(blob)
        warm_next = None
        if self.config.warm_start:
            # the polish's spectrum, made on the host: one copy to the device
            warm_next = torch.from_numpy(np.asarray(result.freq, dtype=np.complex64)).to(self.engine.device)
        return blob.to_bytes(), decoded, warm_next, int(result.iterations), bool(result.converged)

    def _compress_frame(self, data32, E_abs: float, Delta_abs: float, block: int, warm):
        """Compress one frame payload (a keyframe's field or a residual)
        against pinned absolute bounds; returns ``(payload, decoded,
        warm_next, iterations, converged)``."""
        cfg = self.config
        if self.stream.mode == "pencils":
            plan = self.engine.plan_pencils(
                data32, E_abs=E_abs, Delta_abs=Delta_abs, block=block,
                quant_bits=cfg.quant_bits,
            )
            if plan is None:
                raise InfeasibleBound(
                    "stream spatial bound underflows float32 for this frame", stage="plan"
                )
            base_blob = self.base.compress(data32, plan.E_proj)
            x_hat = np.asarray(self.base.decompress(base_blob), dtype=np.float32)
            eps0 = x_hat - data32
            tiles0 = self.engine.tile_f64(eps0, block)
            _corr, edits, stats = self.engine.correct(
                [eps0],
                [plan.E_proj],
                [plan.Delta_proj],
                block=block,
                max_iters=cfg.max_iters,
                return_edits=True,
                return_corrected=False,
                fft_impl=cfg.fft_impl,
                warm_freq=None if warm is None else [warm],
            )
            spat_t, freq_t = edits[0]
            se, fe = self.engine.encode_pencils(spat_t, freq_t, tiles0, plan, codec="zlib")
            payload = _pencil_blob(data32.shape, base_blob, se, fe, plan, block)
            decoded = decode_pencil_blob(payload, self.base)
            iterations = stats.iterations.cpu().numpy()
            iters = int(np.max(iterations)) if iterations.size else 0
            conv = bool(np.all(stats.converged.cpu().numpy()))
            # the loop's own edit spectrum, still on the device
            return payload, decoded, freq_t.to(torch.complex64), iters, conv
        run_cfg = dataclasses.replace(
            cfg, E_abs=float(E_abs), E_rel=None, Delta_abs=float(Delta_abs),
            Delta_rel=None, pspec_rel=None,
        )
        return self._compress_field(data32, self.engine.plan_field(data32, run_cfg), warm)

    # -- decode ------------------------------------------------------------

    def decompress_stream(self, data: bytes) -> List[np.ndarray]:
        """Decode every frame of an ``FFCS`` container, in order."""
        s = TemporalStream.from_bytes(data)
        out: List[np.ndarray] = []
        history: List[np.ndarray] = []
        for i in range(s.n_frames):
            out.append(self._decode_one(s, i, history))
        return out

    def decode_frame(self, data: bytes, t: int) -> np.ndarray:
        """Seek-decode frame ``t``: walk forward from the latest keyframe at
        or before it.  Bitwise identical to ``decompress_stream(data)[t]``
        (keyframes are resync points — the predictor history restarts
        there), touching only the frames in that chain."""
        s = TemporalStream.from_bytes(data)
        if not 0 <= t < s.n_frames:
            raise IndexError(f"frame {t} out of range for a {s.n_frames}-frame stream")
        k = s.latest_keyframe(t)
        history: List[np.ndarray] = []
        x: Optional[np.ndarray] = None
        for i in range(k, t + 1):
            x = self._decode_one(s, i, history)
        return x

    def _decode_one(self, s: TemporalStream, i: int, history: List[np.ndarray]) -> np.ndarray:
        payload = s.frame_payload(i)
        if s.is_keyframe(i):
            x = self._decode_payload(s, payload)
            history.clear()
            history.append(x)
            return x
        if not history:
            raise BlobCorruptError(
                f"corrupt FFCS stream: residual frame {i} has no decoded predecessor"
            )
        r_hat = self._decode_payload(s, payload)
        pred = _predict(history, s.predictor)
        x = (pred + r_hat.astype(np.float64)).astype(np.float32)
        history.append(x)
        del history[:-2]
        return x

    def _decode_payload(self, s: TemporalStream, payload: bytes) -> np.ndarray:
        return self._decode_payload_raw(payload, s.mode, s.shape)

    def _decode_payload_raw(
        self, payload: bytes, mode: str, shape: Tuple[int, ...]
    ) -> np.ndarray:
        if mode == "pencils":
            out = decode_pencil_blob(payload, self.base)
        else:
            out = self._ffcz.decompress(FFCzBlob.from_bytes(payload))
        if out.shape != tuple(shape):
            raise BlobCorruptError(
                f"corrupt FFCS stream: frame decodes to shape {out.shape}, "
                f"header says {tuple(shape)}"
            )
        return out
