"""Durable live stream sessions: WAL journaling, idempotent appends, leases.

``FFCzService.submit_stream`` compresses a *whole* sequence as one unit; a
streaming producer (EEG channels, per-timestep simulation dumps) instead
appends frames to a live stream one at a time, across network retries and
service restarts.  :class:`StreamSessionManager` hosts that lifecycle over
:class:`~repro_torch.core.temporal.StreamEncoder`:

    open_session -> append_frame* -> [flush] -> finalize        (happy path)
                 \\-> abort                                      (client gives up)
                 \\-> lease expiry -> finalize to a partial FFCS (server-side)
    recover(journal) -> append_frame* -> finalize               (crash recovery)

Robustness is the contract, five ways:

  idempotent append   every frame carries a client-assigned, monotonically
                      increasing sequence number.  A duplicate seq with the
                      same frame content returns the ORIGINAL receipt (blob
                      digest + stats, ``duplicate=True``) — retries after an
                      ambiguous failure are always safe.  Gaps, negative
                      seqs, and a duplicate seq re-sent with *different*
                      content reject with
                      :class:`~repro_torch.core.errors.SessionSequenceError`.
  write-ahead journal every committed frame is appended to a per-session
                      journal (CRC'd records, pluggable sink: in-memory for
                      tests, file-backed for ``launch/serve_ffcz.py``)
                      BEFORE its receipt is minted.  If the journal write
                      fails after the frame encoded, the frame is kept
                      *pending* (encoded-but-unjournaled, never acked) and
                      the retry re-journals without re-encoding.
  crash recovery      :meth:`StreamSessionManager.recover` rebuilds a live
                      encoder from the journal tail.  Truncated or
                      bit-flipped tails are detected by the per-record CRC
                      and dropped; if the surviving frame chain still fails
                      to replay, recovery degrades by whole keyframe groups
                      (keyframe resync: degrade, never fail) until a
                      durable prefix restores.  An intact journal restores
                      bitwise: finalize after recovery equals the
                      uninterrupted container byte-for-byte (under the
                      default ``warm_start=False``).
  leases + admission  sessions carry a deadline-style lease refreshed on
                      append; an expired lease finalizes the session to a
                      valid partial ``FFCS`` container (never a dangling
                      encoder).  ``max_sessions`` bounds live sessions and
                      rejects at admission with
                      :class:`~repro_torch.core.errors.ResourceExhausted`; memory
                      pressure on decoded-history buffers
                      (``max_history_bytes``) spills idle sessions to their
                      journals, transparently restored on the next append.
  chaos sites         ``session_append`` fires before a frame encodes,
                      ``session_journal`` before a journal write — both with
                      the caller-supplied uid, so the per-(site, uid)
                      substream discipline keeps fault sequences
                      scheduling-invariant at both pipeline depths.

Journal wire format (``FFJR`` records, docs/streaming.md for the prose)::

    record  := b"FFJR" | u8 type | u32 body_len | body
               | u32 CRC32 of every preceding record byte
    OPEN    := type 1, body = JSON {v, session_id, cfg, stream}
    FRAME   := type 2, body = <IB32sddB> seq, flags (bit0 keyframe),
               sha256(frame bytes), E0, Delta0, ndim | ndim * u64 shape
               | u32 block | frame payload bytes
    CLOSE   := type 3, body = u8 reason (1 finalized, 2 aborted, 3 lease)

Parsing stops at the first damaged record (bad magic/CRC/truncation): the
journal is an append-only log, so everything before the damage is durable
and everything after it is by definition un-acked.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.core.errors import (
    BlobCorruptError,
    FFCzError,
    ResourceExhausted,
    SessionError,
    SessionNotFound,
    SessionSequenceError,
)
from repro_torch.core.ffcz import FFCzConfig
from repro_torch.core.temporal import StreamEncoder, TemporalCodec, TemporalConfig

__all__ = [
    "FileJournal",
    "FrameReceipt",
    "MemoryJournal",
    "SessionStats",
    "StreamSessionManager",
    "parse_journal",
]

# -- journal wire format (FFJR) ----------------------------------------------

_J_MAGIC = b"FFJR"
_J_HEAD = "<BI"  # record type, body length
_J_OPEN, _J_FRAME, _J_CLOSE = 1, 2, 3
# seq, flags (bit0 keyframe), sha256(frame bytes), E0, Delta0, ndim
_J_FRAME_HEAD = "<IB32sddB"
_CLOSE_REASONS = {1: "finalized", 2: "aborted", 3: "lease_expired"}
_CLOSE_CODES = {v: k for k, v in _CLOSE_REASONS.items()}


def _record(rtype: int, body: bytes) -> bytes:
    rec = _J_MAGIC + struct.pack(_J_HEAD, rtype, len(body)) + body
    return rec + struct.pack("<I", zlib.crc32(rec))


def _frame_record(
    seq: int,
    keyframe: bool,
    frame_digest: bytes,
    E0: float,
    Delta0: float,
    shape: Tuple[int, ...],
    block: int,
    payload: bytes,
) -> bytes:
    body = struct.pack(
        _J_FRAME_HEAD, seq, 1 if keyframe else 0, frame_digest, E0, Delta0, len(shape)
    )
    body += struct.pack(f"<{len(shape)}Q", *shape)
    body += struct.pack("<I", block)
    return _record(_J_FRAME, body + payload)


@dataclasses.dataclass(frozen=True)
class _JournalFrame:
    """One durable FRAME record, parsed."""

    seq: int
    keyframe: bool
    frame_digest: bytes
    E0: float
    Delta0: float
    shape: Tuple[int, ...]
    block: int
    payload: bytes = dataclasses.field(repr=False)


@dataclasses.dataclass(frozen=True)
class ParsedJournal:
    """Everything durable in a journal byte string (see :func:`parse_journal`)."""

    open_info: Optional[dict]
    frames: Tuple[_JournalFrame, ...]
    closed: Optional[str]  # a _CLOSE_REASONS value when a CLOSE record survived
    damaged: bool  # True when parsing stopped at a corrupt/truncated record
    n_records: int


def parse_journal(data: bytes) -> ParsedJournal:
    """Walk ``FFJR`` records, stopping at the first damaged one.

    Never raises on malformed bytes — damage marks where durability ends,
    and the caller (recovery) resumes from the intact prefix.  Structural
    nonsense *within* an intact-CRC record (impossible rank, body shorter
    than its own header) also stops the walk: a CRC collision must not
    fabricate a frame.
    """
    open_info: Optional[dict] = None
    frames: List[_JournalFrame] = []
    closed: Optional[str] = None
    damaged = False
    n = 0
    off = 0
    head = struct.calcsize(_J_HEAD)
    while off < len(data):
        if data[off : off + 4] != _J_MAGIC or off + 4 + head + 4 > len(data):
            damaged = True
            break
        rtype, blen = struct.unpack_from(_J_HEAD, data, off + 4)
        end = off + 4 + head + blen
        if end + 4 > len(data):
            damaged = True
            break
        (crc,) = struct.unpack_from("<I", data, end)
        if zlib.crc32(data[off:end]) != crc:
            damaged = True
            break
        body = data[off + 4 + head : end]
        try:
            if rtype == _J_OPEN:
                open_info = json.loads(body.decode("utf-8"))
            elif rtype == _J_FRAME:
                fh = struct.calcsize(_J_FRAME_HEAD)
                seq, flags, digest, E0, Delta0, ndim = struct.unpack_from(
                    _J_FRAME_HEAD, body, 0
                )
                if ndim > 16 or len(body) < fh + 8 * ndim + 4:
                    raise ValueError("frame record body inconsistent")
                shape = struct.unpack_from(f"<{ndim}Q", body, fh)
                (block,) = struct.unpack_from("<I", body, fh + 8 * ndim)
                frames.append(
                    _JournalFrame(
                        seq=int(seq),
                        keyframe=bool(flags & 1),
                        frame_digest=digest,
                        E0=float(E0),
                        Delta0=float(Delta0),
                        shape=tuple(int(s) for s in shape),
                        block=int(block),
                        payload=body[fh + 8 * ndim + 4 :],
                    )
                )
            elif rtype == _J_CLOSE:
                closed = _CLOSE_REASONS.get(body[0] if body else 0, "finalized")
                n += 1
                off = end + 4
                break  # a close record ends the log
            else:
                raise ValueError(f"unknown record type {rtype}")
        except Exception:  # noqa: BLE001 - untrusted bytes end the walk
            damaged = True
            break
        n += 1
        off = end + 4
    return ParsedJournal(
        open_info=open_info,
        frames=tuple(frames),
        closed=closed,
        damaged=damaged,
        n_records=n,
    )


# -- journal sinks -----------------------------------------------------------


class MemoryJournal:
    """In-memory journal sink (tests, and the service default)."""

    def __init__(self, initial: bytes = b""):
        self._buf = bytearray(initial)

    def append(self, record: bytes) -> None:
        self._buf += record

    def read(self) -> bytes:
        return bytes(self._buf)

    def size(self) -> int:
        return len(self._buf)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class FileJournal:
    """File-backed journal sink: append + flush(+fsync) per record, so a
    record is durable before the frame it carries is acked."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self._fsync = fsync
        self._f = open(path, "ab")

    def append(self, record: bytes) -> None:
        self._f.write(record)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def read(self) -> bytes:
        self._f.flush()
        with open(self.path, "rb") as f:
            return f.read()

    def size(self) -> int:
        self._f.flush()
        return os.path.getsize(self.path)

    def flush(self) -> None:
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


# -- receipts and stats ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrameReceipt:
    """Per-frame durable ack: what the client can verify and safely retry on.

    ``digest`` hashes the committed payload bytes, ``frame_digest`` the raw
    float32 frame the client sent (the idempotency check for duplicate
    seqs).  ``duplicate=True`` marks a cached receipt returned for a
    retried seq; ``restored=True`` marks receipts rebuilt from a journal
    (their ``iterations``/``converged`` are not recomputed)."""

    seq: int
    keyframe: bool
    digest: str
    frame_digest: str
    n_bytes: int
    iterations: int = 0
    converged: Optional[bool] = None
    duplicate: bool = False
    restored: bool = False


@dataclasses.dataclass(frozen=True)
class SessionStats:
    """Point-in-time accounting for one session (RequestStats' sibling)."""

    session_id: str
    state: str  # "open" | "spilled" | "finalized" | "aborted" | "lease_expired"
    n_frames: int
    duplicates: int
    sequence_rejects: int
    pending_replays: int
    restores: int
    journal_bytes: int
    lease_remaining_s: float


class _Session:
    def __init__(
        self,
        sid: str,
        cfg: FFCzConfig,
        stream_cfg: TemporalConfig,
        codec: TemporalCodec,
        journal: Any,
        lease_s: float,
        now: float,
    ):
        self.sid = sid
        self.cfg = cfg
        self.stream_cfg = stream_cfg
        self.codec = codec
        self.journal = journal
        self.enc: Optional[StreamEncoder] = codec.open_stream()
        self.receipts: List[FrameReceipt] = []
        # encoded-but-unjournaled frame: (payload, is_key, stats, frame_digest)
        self.pending: Optional[Tuple[bytes, bool, dict, bytes]] = None
        # container assembled by a finalize whose CLOSE write then failed —
        # the retry must not call finish() twice
        self.container: Optional[bytes] = None
        self.lease_s = lease_s
        self.lease_deadline = now + lease_s
        self.last_touch = now
        self.state = "open"
        self.stats = {
            "duplicates": 0,
            "sequence_rejects": 0,
            "pending_replays": 0,
            "restores": 0,
        }
        self.lock = threading.RLock()


def _frame_digest(frame: np.ndarray) -> bytes:
    """Canonical content hash of one frame (float32, C order) — the
    idempotency identity for duplicate-seq retries."""
    x32 = np.ascontiguousarray(np.asarray(frame, dtype=np.float32))
    return hashlib.sha256(x32.tobytes()).digest()


def _config_json(cfg: FFCzConfig, stream_cfg: TemporalConfig, sid: str) -> bytes:
    if cfg.E_roi is not None:
        raise ValueError(
            "sessions journal their config as JSON; ROI bound grids (E_roi) "
            "are per-request arrays and cannot back a durable session"
        )
    doc = {
        "v": 1,
        "session_id": sid,
        "cfg": dataclasses.asdict(cfg),
        "stream": dataclasses.asdict(stream_cfg),
    }
    return json.dumps(doc, sort_keys=True).encode("utf-8")


# -- the manager -------------------------------------------------------------


class StreamSessionManager:
    """Live-session registry over :class:`~repro_torch.core.temporal.TemporalCodec`
    (see module docstring for the durability contract).

    Thread-safety: a registry lock guards the session table and manager
    counters; each session carries its own lock for append/finalize work, so
    concurrent appends to *different* sessions do not serialize.  When driven
    through :class:`~repro_torch.serving.ffcz_service.FFCzService` the single
    encode worker already serializes per-session operations in submission
    order (per-session FIFO); the locks make direct concurrent use safe too.
    """

    def __init__(
        self,
        base: Any,
        engine: Optional[CorrectionEngine] = None,
        *,
        max_sessions: int = 8,
        lease_s: float = 60.0,
        max_history_bytes: int = 0,
        clock: Callable[[], float] = time.monotonic,
        injector: Any = None,
        journal_factory: Optional[Callable[[str], Any]] = None,
    ):
        self.base = base
        self.engine = engine or default_engine()
        self.max_sessions = int(max_sessions)
        self.lease_s = float(lease_s)
        self.max_history_bytes = int(max_history_bytes)
        self._clock = clock
        self.injector = injector
        self._journal_factory = journal_factory or (lambda sid: MemoryJournal())
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}
        self._closed: Dict[str, dict] = {}  # tombstones: reason/container/receipts
        self._next_sid = 0
        self.counters: Dict[str, int] = {
            "opened": 0,
            "finalized": 0,
            "aborted": 0,
            "lease_evictions": 0,
            "spills": 0,
            "restores": 0,
            "duplicates": 0,
            "sequence_rejects": 0,
            "recoveries": 0,
            "recovered_frames": 0,
            "resyncs": 0,
        }

    # -- helpers -----------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def _fire(self, site: str, uid: str) -> None:
        if self.injector is not None:
            self.injector.fire(site, uid=uid)

    def _get(self, sid: str) -> _Session:
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                return s
            tomb = self._closed.get(sid)
        if tomb is not None:
            raise SessionNotFound(
                f"session {sid} is closed ({tomb['reason']})", session_id=sid
            )
        raise SessionNotFound(f"unknown session {sid}", session_id=sid)

    @property
    def live_sessions(self) -> List[str]:
        with self._lock:
            return sorted(self._sessions)

    def next_seq(self, session_id: str) -> int:
        """The seq the session expects next (what a recovered client must
        resume from after :meth:`recover` dropped a damaged tail)."""
        s = self._get(session_id)
        with s.lock:
            return len(s.receipts)

    def session_stats(self, session_id: str) -> SessionStats:
        with self._lock:
            s = self._sessions.get(session_id)
            tomb = self._closed.get(session_id)
        if s is None:
            if tomb is None:
                raise SessionNotFound(f"unknown session {session_id}", session_id=session_id)
            return SessionStats(
                session_id=session_id,
                state=tomb["reason"],
                n_frames=tomb["n_frames"],
                duplicates=tomb["stats"]["duplicates"],
                sequence_rejects=tomb["stats"]["sequence_rejects"],
                pending_replays=tomb["stats"]["pending_replays"],
                restores=tomb["stats"]["restores"],
                journal_bytes=tomb["journal_bytes"],
                lease_remaining_s=0.0,
            )
        with s.lock:
            return SessionStats(
                session_id=session_id,
                state="spilled" if s.enc is None else s.state,
                n_frames=len(s.receipts),
                duplicates=s.stats["duplicates"],
                sequence_rejects=s.stats["sequence_rejects"],
                pending_replays=s.stats["pending_replays"],
                restores=s.stats["restores"],
                journal_bytes=int(s.journal.size()),
                lease_remaining_s=max(0.0, s.lease_deadline - self._clock()),
            )

    def closed_info(self, session_id: str) -> dict:
        """Tombstone of a closed session: ``reason``, ``n_frames``, and — for
        finalized / lease-expired sessions — the ``container`` bytes, so a
        client racing a lease eviction can still fetch its stream."""
        with self._lock:
            tomb = self._closed.get(session_id)
        if tomb is None:
            raise SessionNotFound(
                f"no closed session {session_id}", session_id=session_id
            )
        return dict(tomb)

    # -- lifecycle ---------------------------------------------------------

    def open_session(
        self,
        cfg: FFCzConfig = FFCzConfig(),
        stream: TemporalConfig = TemporalConfig(),
        *,
        session_id: Optional[str] = None,
        lease_s: Optional[float] = None,
        journal: Any = None,
    ) -> str:
        """Admit a new live session; returns its id.

        Validates the config (pspec/ROI grids reject — the journal carries
        config as JSON), writes the OPEN record, and starts the lease.
        Raises :class:`ResourceExhausted` when ``max_sessions`` live
        sessions already exist (expired leases are swept first).
        """
        self.sweep()
        codec = TemporalCodec(self.base, cfg, stream=stream, engine=self.engine)
        now = self._clock()
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                raise ResourceExhausted(
                    f"admission rejected: {len(self._sessions)} live sessions "
                    f">= max_sessions={self.max_sessions}",
                    stage="admit",
                )
            sid = session_id
            if sid is None:
                self._next_sid += 1
                sid = f"sess-{self._next_sid}"
            if sid in self._sessions:
                raise SessionNotFound(f"session {sid} is already live", session_id=sid)
            self._closed.pop(sid, None)
        open_rec = _record(_J_OPEN, _config_json(cfg, stream, sid))
        jrn = journal if journal is not None else self._journal_factory(sid)
        jrn.append(open_rec)
        sess = _Session(
            sid, cfg, stream, codec, jrn, lease_s or self.lease_s, now
        )
        with self._lock:
            self._sessions[sid] = sess
            self.counters["opened"] += 1
        return sid

    def append_frame(
        self,
        session_id: str,
        seq: int,
        frame: np.ndarray,
        *,
        fire_uid: Optional[str] = None,
    ) -> FrameReceipt:
        """Append frame ``seq`` to a live session; returns its durable receipt.

        Idempotent: a duplicate seq with identical content returns the
        original receipt (``duplicate=True``); a duplicate with different
        content, a gap, or a negative seq raises
        :class:`SessionSequenceError`.  The receipt is minted only after the
        frame's journal record is durable — a journal failure leaves the
        encoded frame *pending* and the retry re-journals without
        re-encoding (``pending_replays``).  A successful append refreshes
        the lease and then applies history-memory pressure (idle sessions
        spill to their journals first).
        """
        self.sweep()
        sess = self._get(session_id)
        uid = fire_uid if fire_uid is not None else f"{session_id}#{seq}"
        with sess.lock:
            if sess.state != "open":
                raise SessionNotFound(
                    f"session {session_id} is closed ({sess.state})",
                    session_id=session_id,
                )
            if sess.container is not None:
                # a finalize assembled the container but its CLOSE write is
                # still retrying — the frame set is sealed
                raise SessionNotFound(
                    f"session {session_id} is finalizing; no further appends",
                    session_id=session_id,
                )
            seq = int(seq)
            next_seq = len(sess.receipts)
            if seq < 0:
                sess.stats["sequence_rejects"] += 1
                self._count("sequence_rejects")
                raise SessionSequenceError(
                    f"negative frame seq {seq}",
                    session_id=session_id,
                    expected=next_seq,
                    got=seq,
                )
            digest = _frame_digest(frame)
            if seq < next_seq:
                cached = sess.receipts[seq]
                if cached.frame_digest != digest.hex():
                    sess.stats["sequence_rejects"] += 1
                    self._count("sequence_rejects")
                    raise SessionSequenceError(
                        f"frame seq {seq} re-sent with different content "
                        f"(an idempotent retry must repeat the same frame)",
                        session_id=session_id,
                        expected=next_seq,
                        got=seq,
                    )
                sess.stats["duplicates"] += 1
                self._count("duplicates")
                sess.lease_deadline = self._clock() + sess.lease_s
                return dataclasses.replace(cached, duplicate=True)
            if seq > next_seq:
                sess.stats["sequence_rejects"] += 1
                self._count("sequence_rejects")
                raise SessionSequenceError(
                    f"frame seq gap: got {seq}, expected {next_seq} "
                    f"(frames must arrive densely in order)",
                    session_id=session_id,
                    expected=next_seq,
                    got=seq,
                )
            self._fire("session_append", uid)
            self._materialize(sess)
            enc = sess.enc
            if sess.pending is None:
                payload = enc.add_frame(frame)
                is_key = enc._frames[-1][1]
                fstats = enc.frame_stats[-1]
                sess.pending = (payload, is_key, fstats, digest)
            else:
                # journal write failed after the encoder committed: replay
                # the pending frame instead of re-encoding it
                payload, is_key, fstats, pdigest = sess.pending
                if pdigest != digest:
                    sess.stats["sequence_rejects"] += 1
                    self._count("sequence_rejects")
                    raise SessionSequenceError(
                        f"frame seq {seq} retried with different content than "
                        f"its pending (un-acked) encode",
                        session_id=session_id,
                        expected=next_seq,
                        got=seq,
                    )
                sess.stats["pending_replays"] += 1
            receipt = self._journal_frame(sess, seq, uid)
            sess.lease_deadline = self._clock() + sess.lease_s
            sess.last_touch = self._clock()
        self._enforce_memory(exclude=session_id)
        return receipt

    def _journal_frame(self, sess: _Session, seq: int, uid: str) -> FrameReceipt:
        """Write the pending frame's WAL record, then mint its receipt.
        Caller holds the session lock and has ``sess.pending`` set."""
        payload, is_key, fstats, digest = sess.pending
        enc = sess.enc
        rec = _frame_record(
            seq,
            is_key,
            digest,
            enc._E0,
            enc._Delta0,
            enc._shape,
            enc._block,
            payload,
        )
        self._fire("session_journal", uid)
        sess.journal.append(rec)
        receipt = FrameReceipt(
            seq=seq,
            keyframe=is_key,
            digest=hashlib.sha256(payload).hexdigest(),
            frame_digest=digest.hex(),
            n_bytes=len(payload),
            iterations=int(fstats.get("iterations", 0)),
            converged=fstats.get("converged"),
            restored=bool(fstats.get("restored", False)),
        )
        sess.receipts.append(receipt)
        sess.pending = None
        return receipt

    def flush(self, session_id: str) -> int:
        """Flush the session's journal sink; returns its durable byte size.
        (Appends are already written-ahead per frame — flush exists for
        sinks whose durability needs an explicit barrier.)"""
        sess = self._get(session_id)
        with sess.lock:
            sess.journal.flush()
            sess.lease_deadline = self._clock() + sess.lease_s
            return int(sess.journal.size())

    def finalize(
        self, session_id: str, *, fire_uid: Optional[str] = None, _reason: str = "finalized"
    ) -> bytes:
        """Assemble the session's ``FFCS`` container and close it.

        A pending (encoded-but-unjournaled) frame is journaled first, so the
        container never contains a frame the journal does not.  The
        tombstone keeps the container bytes — a client racing finalize (or a
        lease eviction) can fetch them via :meth:`closed_info`.
        """
        sess = self._get(session_id)
        uid = fire_uid if fire_uid is not None else f"{session_id}#finalize"
        with sess.lock:
            if sess.state != "open":
                raise SessionNotFound(
                    f"session {session_id} is closed ({sess.state})",
                    session_id=session_id,
                )
            if not sess.receipts and sess.pending is None:
                raise SessionError(
                    f"session {session_id} has no frames to finalize; abort it instead",
                    session_id=session_id,
                )
            self._materialize(sess)
            if sess.pending is not None:
                self._journal_frame(sess, len(sess.receipts), uid)
            if sess.container is None:
                sess.container = sess.enc.finish()
            container = sess.container
            self._fire("session_journal", uid)
            sess.journal.append(
                _record(_J_CLOSE, bytes([_CLOSE_CODES[_reason]]))
            )
            self._close(sess, _reason, container)
        self._count(
            "lease_evictions" if _reason == "lease_expired" else "finalized"
        )
        return container

    def abort(self, session_id: str, *, _reason: str = "aborted") -> None:
        """Drop a live session: CLOSE record (best-effort), no container."""
        sess = self._get(session_id)
        with sess.lock:
            if sess.state != "open":
                raise SessionNotFound(
                    f"session {session_id} is closed ({sess.state})",
                    session_id=session_id,
                )
            try:
                sess.journal.append(_record(_J_CLOSE, bytes([_CLOSE_CODES["aborted"]])))
            except Exception:  # noqa: BLE001 - abort must always succeed
                pass
            self._close(sess, _reason, None)
        self._count("lease_evictions" if _reason == "lease_expired" else "aborted")

    def _close(self, sess: _Session, reason: str, container: Optional[bytes]) -> None:
        """Caller holds the session lock."""
        sess.state = reason
        try:
            journal_bytes = int(sess.journal.size())
        except Exception:  # noqa: BLE001
            journal_bytes = 0
        try:
            sess.journal.close()
        except Exception:  # noqa: BLE001
            pass
        sess.enc = None
        sess.pending = None
        with self._lock:
            self._sessions.pop(sess.sid, None)
            self._closed[sess.sid] = {
                "reason": reason,
                "n_frames": len(sess.receipts),
                "container": container,
                "receipts": tuple(sess.receipts),
                "stats": dict(sess.stats),
                "journal_bytes": journal_bytes,
            }

    # -- leases ------------------------------------------------------------

    def sweep(self) -> List[str]:
        """Close every session whose lease expired: finalize to a valid
        partial container when it has frames, abort when empty.  Called on
        every manager operation, or explicitly by a serving loop."""
        now = self._clock()
        with self._lock:
            expired = [
                s for s in self._sessions.values() if s.lease_deadline < now
            ]
        evicted: List[str] = []
        for sess in expired:
            try:
                if sess.receipts or sess.pending is not None:
                    self.finalize(sess.sid, _reason="lease_expired")
                else:
                    self.abort(sess.sid, _reason="lease_expired")
            except SessionNotFound:
                continue  # raced another closer
            evicted.append(sess.sid)
        return evicted

    # -- memory pressure (spill / resume) -----------------------------------

    def _enforce_memory(self, exclude: str) -> None:
        if self.max_history_bytes <= 0:
            return
        with self._lock:
            live = list(self._sessions.values())
        total = sum(s.enc.history_nbytes for s in live if s.enc is not None)
        if total <= self.max_history_bytes:
            return
        idle = sorted(
            (s for s in live if s.sid != exclude and s.enc is not None),
            key=lambda s: s.last_touch,
        )
        for sess in idle:
            if total <= self.max_history_bytes:
                break
            with sess.lock:
                if sess.enc is None or sess.state != "open":
                    continue
                total -= sess.enc.history_nbytes
                # the journal already holds every acked frame; a pending
                # (un-acked) frame is deliberately dropped — its retry
                # re-encodes against the restored state
                sess.enc = None
                sess.pending = None
            self._count("spills")

    def _materialize(self, sess: _Session) -> None:
        """Rebuild a spilled session's encoder from its own journal.
        Caller holds the session lock."""
        if sess.enc is not None:
            return
        parsed = parse_journal(sess.journal.read())
        frames = [(f.payload, f.keyframe) for f in parsed.frames]
        if len(frames) != len(sess.receipts) or parsed.damaged:
            raise BlobCorruptError(
                f"session {sess.sid} journal lost frames while spilled: "
                f"{len(frames)} durable vs {len(sess.receipts)} acked",
                stage="session",
            )
        if not frames:
            sess.enc = sess.codec.open_stream()
        else:
            f0 = parsed.frames[0]
            sess.enc = sess.codec.restore_stream(
                frames,
                shape=f0.shape,
                block=f0.block,
                E0=f0.E0,
                Delta0=f0.Delta0,
            )
        sess.stats["restores"] += 1
        self._count("restores")

    # -- crash recovery ----------------------------------------------------

    def recover(
        self,
        journal: Any,
        *,
        session_id: Optional[str] = None,
        journal_out: Any = None,
        lease_s: Optional[float] = None,
    ) -> str:
        """Rebuild a live session from a journal (bytes or a sink).

        The durable prefix ends at the first damaged record (per-record
        CRC); if the surviving frame chain still fails to replay, recovery
        drops back whole keyframe groups until a prefix restores — the
        keyframe-resync degradation rung.  The recovered session writes a
        fresh compacted journal (``journal_out`` or the manager's factory),
        so it is immediately durable again; receipts for recovered frames
        carry ``restored=True``.  Clients resume from :meth:`next_seq`.
        """
        data = journal if isinstance(journal, (bytes, bytearray)) else journal.read()
        parsed = parse_journal(bytes(data))
        if parsed.open_info is None:
            raise BlobCorruptError(
                "journal has no intact OPEN record: nothing to recover",
                stage="session",
            )
        if parsed.closed is not None:
            raise SessionNotFound(
                f"journal records a closed session ({parsed.closed}); "
                "its container was already finalized",
                session_id=parsed.open_info.get("session_id"),
            )
        try:
            cfg = FFCzConfig(**parsed.open_info["cfg"])
            stream_cfg = TemporalConfig(**parsed.open_info["stream"])
            sid = session_id or str(parsed.open_info["session_id"])
        except (KeyError, TypeError, ValueError) as e:
            raise BlobCorruptError(
                f"journal OPEN record does not describe a session config: {e}",
                stage="session",
                cause=e,
            ) from e
        self.sweep()
        with self._lock:
            if sid in self._sessions:
                raise SessionNotFound(f"session {sid} is already live", session_id=sid)
            if len(self._sessions) >= self.max_sessions:
                raise ResourceExhausted(
                    f"admission rejected: {len(self._sessions)} live sessions "
                    f">= max_sessions={self.max_sessions}",
                    stage="admit",
                )
            self._closed.pop(sid, None)
        codec = TemporalCodec(self.base, cfg, stream=stream_cfg, engine=self.engine)

        # dense seq prefix: a journal replayed out of order (or with a gap
        # from interleaved writers) is only durable up to the break
        kept: List[_JournalFrame] = []
        for i, f in enumerate(parsed.frames):
            if f.seq != i:
                break
            kept.append(f)

        # keyframe-resync degradation: drop whole keyframe groups until the
        # chain replays (an intact journal replays on the first try)
        enc: Optional[StreamEncoder] = None
        resyncs = 0
        while kept:
            try:
                f0 = kept[0]
                enc = codec.restore_stream(
                    [(f.payload, f.keyframe) for f in kept],
                    shape=f0.shape,
                    block=f0.block,
                    E0=f0.E0,
                    Delta0=f0.Delta0,
                )
                break
            except FFCzError:
                last_key = max(i for i, f in enumerate(kept) if f.keyframe)
                if last_key == 0:
                    kept = []
                    break
                kept = kept[:last_key]
                resyncs += 1
        if enc is None:
            enc = codec.open_stream()
            kept = []

        now = self._clock()
        jrn = journal_out if journal_out is not None else self._journal_factory(sid)
        jrn.append(_record(_J_OPEN, _config_json(cfg, stream_cfg, sid)))
        receipts: List[FrameReceipt] = []
        for f in kept:
            jrn.append(
                _frame_record(
                    f.seq, f.keyframe, f.frame_digest, f.E0, f.Delta0,
                    f.shape, f.block, f.payload,
                )
            )
            receipts.append(
                FrameReceipt(
                    seq=f.seq,
                    keyframe=f.keyframe,
                    digest=hashlib.sha256(f.payload).hexdigest(),
                    frame_digest=f.frame_digest.hex(),
                    n_bytes=len(f.payload),
                    restored=True,
                )
            )
        sess = _Session(sid, cfg, stream_cfg, codec, jrn, lease_s or self.lease_s, now)
        sess.enc = enc
        sess.receipts = receipts
        with self._lock:
            self._sessions[sid] = sess
            self.counters["recoveries"] += 1
            self.counters["recovered_frames"] += len(kept)
            self.counters["resyncs"] += resyncs
            self.counters["opened"] += 1
        return sid
