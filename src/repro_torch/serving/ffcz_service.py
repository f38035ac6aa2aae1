"""Fault-tolerant FFCz compression service: queue, retries, degradation ladder.

:class:`FFCzService` fronts one :class:`~repro_torch.core.engine.CorrectionEngine`
with a request queue admitting heterogeneous (shape, dtype, bound) work:

  whole-field compress    the paper pipeline (plan / base / execute / encode),
                          one request per field
  pencil compress         blockwise requests bucketed — up to ``max_batch``
                          queued tensors run as ONE packed ``(B, block)``
                          correction on the donated batched buffer, each with
                          its own resolved (E, Delta)
  temporal stream         one FFCS sequence (predictor residuals + POCS warm
                          start, :class:`~repro_torch.core.temporal.TemporalCodec`)
                          compressed as ONE unit — the frame chain is
                          sequential, so per-stream frame order is preserved
                          by construction while other units still overlap
  live session            incremental frame arrival (``open_session`` /
                          ``submit_append`` / ``submit_finalize``) over the
                          durable session layer (serving/sessions.py):
                          write-ahead journaled, idempotent under retry,
                          lease-bounded, admission-controlled
  decompress              hardened decode of service pencil blobs, FFCS
                          streams, or FFCz blobs

Execution is a two-stage software pipeline (``pipeline_depth``, default 2).
Each unit of work — a pencil bucket, one field, one stream, one decode — is
split at the device fence:

  FRONT (scheduler thread)   per-request PLAN + base codec, pack the bucket
                             into a cached ``(B, block)`` host staging buffer,
                             and *dispatch* the POCS program asynchronously
                             (``engine.correct_async`` / ``execute_field_async``
                             return handles before their CUDA event fence).
  BACK (one worker thread)   fence the handle, run the retry/degradation
                             ladder on failure (re-dispatching synchronously),
                             then host ENCODE and blob assembly.

Both halves launch onto ONE device stream: the stream current on the engine's
device in the thread that built the service.  PyTorch keeps the current
stream per thread, so each half enters that stream explicitly
(:meth:`FFCzService._on_stream`); the worker's ladder re-dispatches are
therefore stream-ordered after the scheduler's dispatches, and every handle's
event fences work on that stream.

With ``pipeline_depth >= 2`` the ring keeps that many units in flight: unit
*i*'s host ENCODE overlaps unit *i+1*'s device EXECUTE.  ``pipeline_depth=1``
runs FRONT and BACK inline on the calling thread — the exact serial behaviour.
Both modes execute the same code in the same per-request order, so responses,
edit streams, and per-request stats are byte-identical across depths (the
parity suite in tests/test_service_pipeline.py gates this).

The headline is the failure path, not the happy path.  Every request drains
to exactly one of completed-within-bounds or rejected-with-reason:

  retries      transient errors (host codec, device dispatch) re-run the
               failing stage with exponential backoff + seeded jitter, up to
               ``max_retries`` per request, inside a per-request deadline.
  ladder       when retries exhaust on the POCS transform — or the loop ends
               non-converged — the service degrades instead of failing:
               first a relaxed re-run (``max_iters`` x4, over-relaxation),
               then fft_impl rungs pallas -> packed -> xla.  Each rung taken
               is recorded in the request's stats.
  bisect       a device allocation failure on a pencil bucket evicts the
               bucket's cached staging buffer (so the halves don't allocate
               against a stale full-size buffer), then splits the bucket and
               runs the halves (recursively, down to one request, which is
               then rejected with the structured OOM).  Injected bucket
               faults fire against the ORIGINAL bucket lead's uid through
               the whole recursion, so fault caps apply per bucket-unit.
  reject       infeasible bound intersections (:class:`InfeasibleBound`),
               corrupt blobs (:class:`BlobCorruptError`), and exhausted
               budgets return a structured error dict — never a raw
               exception out of :meth:`step`, and never a hang: every
               :meth:`step` retires at least one queued unit.
  timeout      a request whose deadline passes mid-stage is rejected with
               :class:`DeadlineExceeded` (disposition ``"timeout"``).

A :class:`~repro_torch.runtime.faults.FaultInjector` can be threaded through every
stage boundary for deterministic chaos testing (tests/test_faults.py); its
per-request substreams make the injected faults identical in serial and
pipelined mode.

The prose version of this page — request kinds, error taxonomy, ladder,
pipeline diagram, and the generated flag reference — is docs/serving.md
(stream semantics: docs/streaming.md), written for the reference package;
the port keeps its names, rungs and flags.  One addition: a failure of the
port's own device code (a kernel that does not build or launch, a sticky
CUDA error) classifies as permanent, so it rejects the request and never
walks the ladder (:func:`repro_torch.core.errors.is_kernel_fault`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.core.errors import (
    DeadlineExceeded,
    FFCzError,
    InfeasibleBound,
    ResourceExhausted,
    classify_exception,
)
from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig

# The pencil envelope (FFSB) lives in repro_torch.core.temporal (the temporal codec
# shares it for pencil-mode stream frames); re-exported here because the
# service mints the format and callers decode through this module.
from repro_torch.core.temporal import (  # noqa: F401 - decode_pencil_blob re-exported
    _PENCIL_MAGIC,
    _STREAM_MAGIC,
    TemporalCodec,
    TemporalConfig,
    _pencil_blob,
    decode_pencil_blob,
)
from repro_torch.serving.sessions import FileJournal, StreamSessionManager

__all__ = [
    "ServiceConfig",
    "ServiceResponse",
    "RequestStats",
    "FFCzService",
    "decode_pencil_blob",
]

# fft_impl degradation rungs: each key falls back to its value when the POCS
# transform keeps failing (or won't converge); "xla" is the floor.
_LADDER = {"pallas": "packed", "packed": "xla"}


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Queue, retry, and degradation knobs for one :class:`FFCzService`."""

    max_batch: int = 8  # pencil requests fused per packed correction
    block: int = 256  # pencil length for blockwise requests
    max_iters: int = 50  # POCS budget for pencil buckets
    deadline_s: float = 30.0  # default per-request deadline
    max_retries: int = 3  # per-request transient-retry budget
    backoff_base_s: float = 0.002
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.5  # uniform [0, jitter) fraction added per delay
    # Non-convergence rung: one re-run with max_iters x this and
    # over-relaxed projections before encoding a non-converged result.
    relax_on_nonconvergence: bool = True
    relax_iters_mult: int = 4
    relax_factor: float = 1.3
    seed: int = 0  # backoff-jitter stream (determinism under test)
    # In-flight units: 1 = serial (front + back inline), >= 2 = the back half
    # (fence + encode) of up to depth units runs on the worker thread while
    # the scheduler front-half dispatches the next units' device work.
    pipeline_depth: int = 2
    # Admission control (docs/serving.md): submits beyond max_queue queued
    # requests raise ResourceExhausted (stage "admit") instead of growing the
    # queue without bound; 0 disables the cap.  The session knobs
    # parameterize the live-session manager (serving/sessions.py):
    # max_sessions live sessions, session_lease_s lease refreshed on append,
    # session_history_bytes of resident decoded history before idle sessions
    # spill to their journals (0 = unbounded), and session_journal_dir for
    # file-backed write-ahead journals ("" = in-memory sinks).
    max_queue: int = 1024
    max_sessions: int = 8
    session_lease_s: float = 60.0
    session_history_bytes: int = 0
    session_journal_dir: str = ""


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request accounting: what the failure machinery actually did."""

    attempts: int  # transient retries consumed
    rungs: Tuple[str, ...]  # degradation rungs taken, in order
    latency_s: float  # admit -> retire (includes injected slowness)
    fft_impl: Optional[str] = None  # transform the final attempt ran with
    converged: Optional[bool] = None
    final_violations: int = 0
    # Derived-quantity shell recheck (cfg.verify_pspec, field requests in
    # pspec mode): max live-shell |P_hat(k)/P(k) - 1| of the decoded blob.
    pspec_shell_err: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ServiceResponse:
    uid: str
    ok: bool
    payload: Any = None  # blob bytes (compress) or ndarray (decompress)
    error: Optional[dict] = None  # FFCzError.to_dict() when not ok
    stats: Optional[RequestStats] = None


@dataclasses.dataclass
class _Request:
    uid: str
    kind: str  # "field" | "pencils" | "stream" | "session" | "decompress"
    payload: Any
    # FFCzConfig (field) | (E_rel, Delta_rel) (pencils)
    # | (FFCzConfig, TemporalConfig) (stream) | (op, session_id, seq)
    # (session) | None (decompress)
    cfg: Any
    deadline_s: float
    seq: int = 0  # submission order (drain() response ordering)
    t0: float = 0.0
    penalty_s: float = 0.0  # injected slowness, charged against the deadline
    attempts: int = 0
    rungs: List[str] = dataclasses.field(default_factory=list)
    fft_impl: Optional[str] = None
    converged: Optional[bool] = None
    final_violations: int = 0
    pspec_shell_err: Optional[float] = None

    def elapsed(self, now: float) -> float:
        return (now - self.t0) + self.penalty_s


@dataclasses.dataclass
class _Staged:
    """A unit of work after its FRONT half: what the BACK half needs.

    Exactly one of three shapes, by ``kind``:

      pencils     ``work`` (plan/base survivors), front-half ``responses``
                  for the rest, and the attempt-1 dispatch as ``handle`` /
                  ``exc`` (one of the two, or neither when ``work`` is empty)
      field       ``plan`` / ``base_blob`` / ``eps0`` plus the attempt-1
                  dispatch, or ``done`` when the request rejected at front
      stream      nothing staged — the frame chain is sequential, all BACK
      session     nothing staged — session state mutates on the single
                  worker only, which is what makes per-session FIFO hold
      decompress  nothing staged — decode is pure host work, all BACK
    """

    kind: str
    unit: List[_Request]
    responses: Dict[str, ServiceResponse] = dataclasses.field(default_factory=dict)
    work: List[Tuple] = dataclasses.field(default_factory=list)
    handle: Any = None  # in-flight async handle from the front-half dispatch
    exc: Optional[BaseException] = None  # raw front-half dispatch failure
    plan: Any = None
    base_blob: bytes = b""
    eps0: Any = None
    done: Optional[ServiceResponse] = None


class FFCzService:
    """Continuous-batching FFCz compress/decompress front end (see module
    docstring for the failure-path and pipelining contract)."""

    def __init__(
        self,
        base: Any,
        engine: Optional[CorrectionEngine] = None,
        config: ServiceConfig = ServiceConfig(),
        injector: Any = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        device=None,
    ):
        if engine is not None and device is not None:
            raise ValueError("pass either an engine or a device: the engine owns its device")
        self.base = base
        # the shared engine of ``device``; None means "cuda" (raises without a card)
        self.engine = engine if engine is not None else default_engine(device)
        dev = torch.device(self.engine.device)
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self.config = config
        self.injector = injector  # None, or a repro_torch.runtime.faults.FaultInjector
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(config.seed)
        self._queue: List[_Request] = []
        self._next_uid = 0
        self._next_seq = 0
        self._submit_seq: Dict[str, int] = {}
        # counters / rng / timers are touched from both the scheduler and the
        # encode worker thread
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "completed": 0,
            "rejected": 0,
            "retries": 0,
            "fallbacks": 0,
            "relaxes": 0,
            "bisects": 0,
            "timeouts": 0,
            "buffer_evictions": 0,
        }
        # cumulative stage clocks (seconds): front = plan/base/pack/dispatch
        # on the scheduler thread, execute = blocked on the device fence
        # (incl. ladder re-runs), encode/decode = host codec work.  The serve
        # bench turns these into host/device busy fractions.
        self.timers: Dict[str, float] = {
            "front_s": 0.0,
            "execute_s": 0.0,
            "encode_s": 0.0,
            "decode_s": 0.0,
        }
        # host staging buffers for packed pencil buckets, keyed (B, block);
        # populated by the scheduler front-half, evicted on allocation failure
        self._staging: Dict[Tuple[int, int], np.ndarray] = {}
        self._staging_lock = threading.Lock()
        # in-flight ring: (unit requests, back-half future), oldest first
        self._ring: Deque[Tuple[List[_Request], Future]] = collections.deque()
        self._worker: Optional[ThreadPoolExecutor] = None
        # live stream sessions (serving/sessions.py): shares the service
        # clock (frozen-clock tests freeze leases too) and the injector (the
        # session_* chaos sites fire with the append request's uid)
        journal_factory = None
        if config.session_journal_dir:
            jdir = config.session_journal_dir
            os.makedirs(jdir, exist_ok=True)
            journal_factory = lambda sid: FileJournal(os.path.join(jdir, f"{sid}.wal"))  # noqa: E731
        self.sessions = StreamSessionManager(
            base,
            engine=self.engine,
            max_sessions=config.max_sessions,
            lease_s=config.session_lease_s,
            max_history_bytes=config.session_history_bytes,
            clock=clock,
            injector=injector,
            journal_factory=journal_factory,
        )

    def _on_stream(self):
        """Make the service's device stream current in the calling thread
        (a no-op on the CPU): the scheduler's FRONT and the worker's BACK
        then launch onto the same stream."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    # -- admission ---------------------------------------------------------

    def _admit(self, req: _Request) -> str:
        if self.config.max_queue and len(self._queue) >= self.config.max_queue:
            raise ResourceExhausted(
                f"admission rejected: {len(self._queue)} queued requests "
                f">= max_queue={self.config.max_queue}",
                stage="admit",
            )
        req.t0 = self._clock()
        req.seq = self._next_seq
        self._next_seq += 1
        self._submit_seq[req.uid] = req.seq
        if self.injector is not None:
            # injected slowness is charged to the request's clock, not slept,
            # so deadline tests run in real milliseconds
            req.penalty_s = self.injector.sleep_s(uid=req.uid)
        self._queue.append(req)
        return req.uid

    def _uid(self, uid: Optional[str]) -> str:
        if uid is not None:
            return uid
        self._next_uid += 1
        return f"req-{self._next_uid}"

    def submit_compress(
        self,
        x: np.ndarray,
        cfg: FFCzConfig,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue one whole-field compression (the paper pipeline)."""
        x = np.asarray(x)
        if x.size == 0:
            raise ValueError("cannot compress an empty field")
        return self._admit(
            _Request(
                uid=self._uid(uid),
                kind="field",
                payload=x,
                cfg=cfg,
                deadline_s=self.config.deadline_s if deadline_s is None else deadline_s,
            )
        )

    def submit_pencils(
        self,
        x: np.ndarray,
        E_rel: float,
        Delta_rel: float,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue one tensor for blockwise (pencil) compression.

        Queued pencil requests are fused: up to ``max_batch`` of them run as
        a single packed batched correction, each with its own resolved
        bounds — heterogeneous shapes and dtypes batch freely because the
        engine tiles every tensor into ``block``-length pencils.
        """
        x = np.asarray(x)
        if x.size == 0:
            raise ValueError("cannot compress an empty tensor")
        if not (E_rel > 0 and Delta_rel > 0):
            raise ValueError(f"bounds must be positive, got E_rel={E_rel}, Delta_rel={Delta_rel}")
        return self._admit(
            _Request(
                uid=self._uid(uid),
                kind="pencils",
                payload=x,
                cfg=(float(E_rel), float(Delta_rel)),
                deadline_s=self.config.deadline_s if deadline_s is None else deadline_s,
            )
        )

    def submit_stream(
        self,
        frames: Sequence[np.ndarray],
        cfg: FFCzConfig,
        stream: TemporalConfig = TemporalConfig(),
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue one temporal sequence for FFCS stream compression.

        The whole sequence is ONE unit of work: frames of a stream are a
        sequential dependency chain (residuals against decoded history, POCS
        warm starts), so per-stream frame order is preserved trivially while
        the pipeline still overlaps this stream's encode with *other* units'
        device work.  The response payload is the ``FFCS`` container; the
        per-frame retry machinery applies inside the unit (a transient frame
        failure re-runs that frame, not the stream).
        """
        frames = [np.asarray(f) for f in frames]
        if not frames:
            raise ValueError("cannot compress an empty stream")
        if any(f.size == 0 for f in frames):
            raise ValueError("cannot compress an empty frame")
        return self._admit(
            _Request(
                uid=self._uid(uid),
                kind="stream",
                payload=frames,
                cfg=(cfg, stream),
                deadline_s=self.config.deadline_s if deadline_s is None else deadline_s,
            )
        )

    # -- live sessions (serving/sessions.py) --------------------------------

    def open_session(
        self,
        cfg: FFCzConfig = FFCzConfig(),
        stream: TemporalConfig = TemporalConfig(),
        session_id: Optional[str] = None,
        lease_s: Optional[float] = None,
    ) -> str:
        """Admit a live stream session (synchronous — admission is
        bookkeeping, not device work).  Raises
        :class:`~repro_torch.core.errors.ResourceExhausted` at ``max_sessions``."""
        return self.sessions.open_session(
            cfg, stream, session_id=session_id, lease_s=lease_s
        )

    def _submit_session(
        self, op: str, session_id: str, seq: int, frame: Any, uid: Optional[str],
        deadline_s: Optional[float],
    ) -> str:
        return self._admit(
            _Request(
                uid=self._uid(uid),
                kind="session",
                payload=frame,
                cfg=(op, session_id, seq),
                deadline_s=self.config.deadline_s if deadline_s is None else deadline_s,
            )
        )

    def submit_append(
        self,
        session_id: str,
        seq: int,
        frame: np.ndarray,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue one incremental frame append to a live session.

        The response payload is the frame's durable
        :class:`~repro_torch.serving.sessions.FrameReceipt` — minted only after
        the write-ahead journal holds the frame, so an acked append survives
        a crash.  Duplicate seqs are idempotent; gaps reject with
        :class:`~repro_torch.core.errors.SessionSequenceError`.  Session units run
        entirely in the back half on the single encode worker, so appends
        and finalizes for one session retire in submission order (per-
        session FIFO) at every pipeline depth.
        """
        frame = np.asarray(frame)
        if frame.size == 0:
            raise ValueError("cannot append an empty frame")
        return self._submit_session("append", session_id, int(seq), frame, uid, deadline_s)

    def submit_session_flush(
        self,
        session_id: str,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue a journal flush barrier; the response payload is the
        session's durable journal byte count."""
        return self._submit_session("flush", session_id, -1, None, uid, deadline_s)

    def submit_finalize(
        self,
        session_id: str,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue session finalization; the response payload is the ``FFCS``
        container (byte-identical to ``submit_stream`` over the same frames
        under the default ``warm_start=False``)."""
        return self._submit_session("finalize", session_id, -1, None, uid, deadline_s)

    def submit_abort(
        self,
        session_id: str,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue a session abort (drops the session; no container)."""
        return self._submit_session("abort", session_id, -1, None, uid, deadline_s)

    def submit_decompress(
        self,
        blob: bytes,
        uid: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue a decode of service pencil bytes, an FFCS stream, or a
        whole-field FFCz blob (stream decodes return the stacked frames)."""
        return self._admit(
            _Request(
                uid=self._uid(uid),
                kind="decompress",
                payload=bytes(blob),
                cfg=None,
                deadline_s=self.config.deadline_s if deadline_s is None else deadline_s,
            )
        )

    # -- scheduling --------------------------------------------------------

    def _pop_unit(self) -> List[_Request]:
        """Pop the next unit of work off the queue: a pencil bucket (up to
        ``max_batch`` fused requests, collected queue-wide so interleaved
        field traffic can't break batching) or one field/decompress request.
        """
        if self._queue[0].kind == "pencils":
            bucket: List[_Request] = []
            rest: List[_Request] = []
            for r in self._queue:
                if r.kind == "pencils" and len(bucket) < self.config.max_batch:
                    bucket.append(r)
                else:
                    rest.append(r)
            self._queue = rest
            return bucket
        return [self._queue.pop(0)]

    def step(self) -> List[ServiceResponse]:
        """Retire one unit of work (a pencil bucket, one field, or one
        decode), returning its responses in submission order.

        Popped requests never re-enqueue — retries happen bounded *within*
        the unit — so ``step`` makes progress whenever work is queued or in
        flight, and :meth:`drain` terminates by induction.

        With ``pipeline_depth >= 2`` this first tops the in-flight ring up
        to depth (front-half + async dispatch per unit, back half submitted
        to the worker thread), then blocks on the OLDEST unit's back half:
        while that unit encodes on the worker, the younger units' device
        programs are already executing.
        """
        if self.config.pipeline_depth <= 1:
            if not self._queue:
                return []
            return self._back(self._front(self._pop_unit()))
        while self._queue and len(self._ring) < self.config.pipeline_depth:
            unit = self._pop_unit()
            staged = self._front(unit)
            self._ring.append((unit, self._executor().submit(self._back, staged)))
        if not self._ring:
            return []
        unit, fut = self._ring.popleft()
        try:
            return fut.result()
        except Exception as e:  # noqa: BLE001 - the back half never raises by
            # contract; anything here (e.g. a cancelled future at teardown)
            # still retires the unit with a structured rejection
            err = classify_exception(e, "service")
            return [self._reject(r, err) for r in unit]

    def drain(self) -> Dict[str, ServiceResponse]:
        """Run :meth:`step` until no work is queued or in flight.

        Responses are keyed AND ordered by submission, regardless of the
        order units retire (bucket fusion and the in-flight ring both reorder
        retirement) — clients can zip submissions to responses directly.
        """
        out: Dict[str, ServiceResponse] = {}
        while self._queue or self._ring:
            for resp in self.step():
                out[resp.uid] = resp
        order = sorted(out, key=lambda u: self._submit_seq.get(u, 1 << 62))
        return {u: out[u] for u in order}

    @property
    def pending(self) -> int:
        """Units of work queued or in flight (load generators poll this to
        decide whether :meth:`step` has anything to do)."""
        return len(self._queue) + len(self._ring)

    def _executor(self) -> ThreadPoolExecutor:
        if self._worker is None:
            # exactly one worker: back halves run in dispatch order, so encode
            # order (and therefore response order within a unit) stays
            # deterministic
            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ffcz-encode"
            )
        return self._worker

    def close(self) -> None:
        """Tear down the encode worker (call after :meth:`drain`).  In-flight
        back halves are cancelled; their requests reject as
        :class:`~repro_torch.core.errors.PipelineAborted` if :meth:`step` is still
        polling them."""
        while self._ring:
            _unit, fut = self._ring.popleft()
            fut.cancel()
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    # -- failure machinery -------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def _tick(self, name: str, t0: float) -> None:
        dt = self._clock() - t0
        with self._lock:
            self.timers[name] += dt

    def _check_deadline(self, req: _Request) -> None:
        if req.elapsed(self._clock()) > req.deadline_s:
            raise DeadlineExceeded(
                f"request {req.uid} exceeded its {req.deadline_s:g}s deadline",
                stage="service",
            )

    def _fire(self, site: str, uid: str) -> None:
        if self.injector is not None:
            self.injector.fire(site, uid=uid)

    def _attempt(self, req: _Request, stage: str, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` with deadline enforcement and bounded transient retries.

        Non-retryable and budget-exhausted errors re-raise classified; each
        retry backs off exponentially with seeded jitter and records a
        ``retry:<stage>`` rung.  Runs on the scheduler thread (front halves)
        or the encode worker (back halves) — the jitter stream is shared and
        lock-guarded, so only delay *values* depend on thread interleaving,
        never retry outcomes.
        """
        while True:
            self._check_deadline(req)
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified immediately below
                err = classify_exception(e, stage)
                if not err.retryable or req.attempts >= self.config.max_retries:
                    raise err from e
                req.attempts += 1
                self._count("retries")
                req.rungs.append(f"retry:{stage}")
                delay = self.config.backoff_base_s * (
                    self.config.backoff_factor ** (req.attempts - 1)
                )
                with self._lock:
                    jitter = float(self._rng.random())
                delay *= 1.0 + self.config.backoff_jitter * jitter
                self._sleep(delay)

    def _reject(self, req: _Request, err: FFCzError) -> ServiceResponse:
        self._count("rejected")
        if err.disposition == "timeout":
            self._count("timeouts")
        return ServiceResponse(
            uid=req.uid, ok=False, error=err.to_dict(), stats=self._stats(req)
        )

    def _complete(self, req: _Request, payload: Any) -> ServiceResponse:
        self._count("completed")
        return ServiceResponse(uid=req.uid, ok=True, payload=payload, stats=self._stats(req))

    def _stats(self, req: _Request) -> RequestStats:
        return RequestStats(
            attempts=req.attempts,
            rungs=tuple(req.rungs),
            latency_s=req.elapsed(self._clock()),
            fft_impl=req.fft_impl,
            converged=req.converged,
            final_violations=req.final_violations,
            pspec_shell_err=req.pspec_shell_err,
        )

    # -- staging-buffer cache ----------------------------------------------

    def _bucket_rows(self, work: List[Tuple]) -> int:
        b = self.config.block
        return sum(-(-int(np.asarray(w[2]).size) // b) for w in work)

    def _staging_get(self, rows: int) -> np.ndarray:
        """Cached ``(rows, block)`` host buffer for packing a pencil bucket.
        Only the scheduler front-half packs, so handing out the shared buffer
        is race-free; the async dispatch copies it to the device before
        ``correct_async`` returns, after which it is reusable."""
        key = (rows, self.config.block)
        with self._staging_lock:
            buf = self._staging.get(key)
            if buf is None:
                buf = np.zeros(key, np.float32)
                self._staging[key] = buf
        return buf

    def _staging_evict(self, rows: int) -> None:
        """Drop the cached full-bucket buffer after an allocation failure so
        the bisected halves don't allocate against a stale full-size buffer."""
        key = (rows, self.config.block)
        with self._staging_lock:
            dropped = self._staging.pop(key, None) is not None
        if dropped:
            self._count("buffer_evictions")

    # -- pipeline halves ---------------------------------------------------

    def _front(self, unit: List[_Request]) -> _Staged:
        """FRONT half, scheduler thread: plan/base + async EXECUTE dispatch."""
        t0 = self._clock()
        try:
            with self._on_stream():
                return self._front_unit(unit)
        finally:
            self._tick("front_s", t0)

    def _front_unit(self, unit: List[_Request]) -> _Staged:
        kind = unit[0].kind
        if kind == "pencils":
            return self._front_pencils(unit)
        if kind == "field":
            return self._front_field(unit[0])
        # stream/session/decompress: nothing to pre-dispatch — the whole
        # unit runs in the back half, overlapping OTHER units at
        # depth >= 2.  Streams because the frame chain is sequential;
        # sessions additionally because running every session op on the
        # one ordered worker is what serializes a finalize racing queued
        # appends (per-session FIFO).
        return _Staged(kind=kind, unit=unit)

    def _back(self, staged: _Staged) -> List[ServiceResponse]:
        """BACK half, worker thread (or inline at depth 1): fence + retry
        ladder + ENCODE.  Never raises — every request retires structured."""
        with self._on_stream():
            return self._back_unit(staged)

    def _back_unit(self, staged: _Staged) -> List[ServiceResponse]:
        if staged.kind == "pencils":
            return self._back_pencils(staged)
        if staged.kind == "field":
            return [self._back_field(staged)]
        if staged.kind == "stream":
            t0 = self._clock()
            try:
                return [self._run_stream(staged.unit[0])]
            finally:
                self._tick("execute_s", t0)
        if staged.kind == "session":
            t0 = self._clock()
            try:
                return [self._run_session(staged.unit[0])]
            finally:
                self._tick("execute_s", t0)
        t0 = self._clock()
        try:
            return [self._run_decompress(staged.unit[0])]
        finally:
            self._tick("decode_s", t0)

    # -- whole-field path --------------------------------------------------

    def _dispatch_field(self, req: _Request, eps0: np.ndarray, run_plan):
        self._fire("dispatch", req.uid)
        self._fire("oom", req.uid)
        return self.engine.execute_field_async(eps0, run_plan)

    def _front_field(self, req: _Request) -> _Staged:
        try:
            cfg: FFCzConfig = req.cfg
            x32 = np.asarray(req.payload, dtype=np.float32)
            plan = self._attempt(req, "plan", lambda: self.engine.plan_field(x32, cfg))

            def _base():
                self._fire("codec", req.uid)
                blob = self.base.compress(x32, plan.E_proj)
                return blob, np.asarray(self.base.decompress(blob), dtype=np.float32)

            base_blob, x_hat = self._attempt(req, "base", _base)
            eps0 = x_hat - x32
            # attempt 1 of the first ladder rung dispatches here so the device
            # starts while the previous unit is still encoding; failures are
            # stashed raw and re-raised inside the back half's ladder, which
            # owns classification and the retry budget
            handle = exc = None
            try:
                handle = self._dispatch_field(
                    req, eps0, dataclasses.replace(plan, fft_impl=plan.fft_impl)
                )
            except Exception as e:  # noqa: BLE001 - re-raised in the back half
                exc = e
            return _Staged(
                kind="field",
                unit=[req],
                plan=plan,
                base_blob=base_blob,
                eps0=eps0,
                handle=handle,
                exc=exc,
            )
        except FFCzError as err:
            return _Staged(kind="field", unit=[req], done=self._reject(req, err))
        except Exception as e:  # noqa: BLE001 - terminal safety net
            return _Staged(
                kind="field", unit=[req], done=self._reject(req, classify_exception(e, "service"))
            )

    def _back_field(self, staged: _Staged) -> ServiceResponse:
        if staged.done is not None:
            return staged.done
        req = staged.unit[0]
        try:
            result, run_plan = self._execute_with_ladder(
                req, staged.eps0, staged.plan, first=(staged.handle, staged.exc)
            )
            req.converged = bool(result.converged)
            req.final_violations = int(result.final_violations)

            def _encode():
                self._fire("codec", req.uid)
                return self.engine.encode_field(result, run_plan)

            t0 = self._clock()
            try:
                se, fe = self._attempt(req, "encode", _encode)
                cfg: FFCzConfig = req.cfg
                blob = FFCzBlob(
                    base_blob=staged.base_blob,
                    spat_edits=se,
                    freq_edits=fe,
                    E=run_plan.E,
                    Delta_scalar=run_plan.delta_scalar,
                    pointwise_delta=run_plan.pointwise_bytes(),
                    shape=run_plan.shape,
                    roi_bound=run_plan.roi_bytes(),
                    crc=cfg.crc,
                )
                payload = blob.to_bytes()
                if getattr(cfg, "verify_pspec", False) and cfg.pspec_rel is not None:
                    # derived-quantity recheck rides the encode stage: decode
                    # the assembled blob and measure the live-shell power-
                    # spectrum ratio in float64 (opt-in; two host FFTs)
                    from repro_torch.core.spectrum import shell_ratio_error

                    x_final = FFCz(self.base, cfg, engine=self.engine).decompress(blob)
                    req.pspec_shell_err = float(
                        shell_ratio_error(x_final, np.asarray(req.payload, dtype=np.float32))
                    )
            finally:
                self._tick("encode_s", t0)
            return self._complete(req, payload)
        except FFCzError as err:
            return self._reject(req, err)
        except Exception as e:  # noqa: BLE001 - terminal safety net
            return self._reject(req, classify_exception(e, "service"))

    def _execute_with_ladder(self, req: _Request, eps0: np.ndarray, plan, first=None):
        """EXECUTE with the degradation ladder (see module docstring).

        ``first`` carries the front half's attempt-1 dispatch — an in-flight
        handle or its raw dispatch exception — consumed by the first attempt
        so the per-request fire/attempt sequence is identical to serial mode.
        Later attempts (and rungs) re-dispatch synchronously right here.

        Terminates: the impl chain pallas -> packed -> xla is finite, the
        relax rung fires at most once, and each attempt's retries are
        bounded by ``_attempt``.
        """
        impl = plan.fft_impl
        relaxed = False
        pre = first if first is not None and first != (None, None) else None
        while True:
            req.fft_impl = impl
            run_plan = dataclasses.replace(plan, fft_impl=impl)

            def _exec(p=run_plan):
                nonlocal pre
                if pre is not None:
                    handle, exc = pre
                    pre = None
                    if exc is not None:
                        raise exc
                    return handle.result()
                return self._dispatch_field(req, eps0, p).result()

            t0 = self._clock()
            try:
                result = self._attempt(req, "execute", _exec)
            except FFCzError as err:
                self._tick("execute_s", t0)
                nxt = _LADDER.get(impl)
                if nxt is None or not err.transient:
                    raise
                # transient failure survived the retry budget on this rung:
                # descend rather than reject
                impl = nxt
                self._count("fallbacks")
                req.rungs.append(f"fallback:{impl}")
                continue
            self._tick("execute_s", t0)
            if result.converged or relaxed or not self.config.relax_on_nonconvergence:
                return result, run_plan
            # Non-convergence rung: one re-run with a bigger budget and
            # over-relaxed projections.  The pallas kernels require
            # relax == 1.0, so that rung implies the packed transform.
            relaxed = True
            self._count("relaxes")
            req.rungs.append("relax")
            if impl == "pallas":
                impl = "packed"
                self._count("fallbacks")
                req.rungs.append(f"fallback:{impl}")
            plan = dataclasses.replace(
                plan,
                max_iters=plan.max_iters * self.config.relax_iters_mult,
                relax=self.config.relax_factor,
            )

    # -- pencil bucket path ------------------------------------------------

    def _dispatch_bucket(self, work: List[Tuple], fire_uid: str, staging=None):
        """One fused dispatch per bucket attempt -> one dispatch/OOM draw,
        always against the ORIGINAL bucket lead's uid (``fire_uid``), so
        injected-fault caps span the whole bisect recursion."""
        self._fire("dispatch", fire_uid)
        self._fire("oom", fire_uid)
        return self.engine.correct_async(
            [w[2] for w in work],
            [w[4].E_proj for w in work],
            [w[4].Delta_proj for w in work],
            block=self.config.block,
            max_iters=self.config.max_iters,
            return_edits=True,
            return_corrected=False,
            staging=staging,
        )

    def _front_pencils(self, bucket: List[_Request]) -> _Staged:
        """Per-request plan/base, then ONE fused async dispatch."""
        responses: Dict[str, ServiceResponse] = {}
        work: List[Tuple[_Request, bytes, np.ndarray, np.ndarray, Any]] = []
        for req in bucket:
            try:
                E_rel, Delta_rel = req.cfg
                x32 = np.asarray(req.payload, dtype=np.float32)
                plan = self._attempt(
                    req,
                    "plan",
                    lambda x=x32, e=E_rel, d=Delta_rel: self.engine.plan_pencils(
                        x, E_rel=e, Delta_rel=d, block=self.config.block
                    ),
                )
                if plan is None:
                    raise InfeasibleBound(
                        f"E_rel={E_rel:g} underflows float32 for this tensor's range",
                        stage="plan",
                    )

                def _base(x=x32, p=plan, r=req):
                    self._fire("codec", r.uid)
                    blob = self.base.compress(x, p.E_proj)
                    return blob, np.asarray(self.base.decompress(blob), dtype=np.float32)

                base_blob, x_hat = self._attempt(req, "base", _base)
                eps0 = x_hat - x32
                tiles0 = self.engine.tile_f64(eps0, self.config.block)
                work.append((req, base_blob, eps0, tiles0, plan))
            except FFCzError as err:
                responses[req.uid] = self._reject(req, err)
            except Exception as e:  # noqa: BLE001
                responses[req.uid] = self._reject(req, classify_exception(e, "plan"))

        handle = exc = None
        if work:
            try:
                handle = self._dispatch_bucket(
                    work, work[0][0].uid, staging=self._staging_get(self._bucket_rows(work))
                )
            except Exception as e:  # noqa: BLE001 - re-raised in the back half
                exc = e
        return _Staged(
            kind="pencils", unit=bucket, responses=responses, work=work, handle=handle, exc=exc
        )

    def _back_pencils(self, staged: _Staged) -> List[ServiceResponse]:
        responses = dict(staged.responses)
        if staged.work:
            first = (staged.handle, staged.exc)
            for resp in self._execute_bucket(staged.work, staged.work[0][0].uid, first=first):
                responses[resp.uid] = resp
        # preserve submission order in the returned list
        return [responses[r.uid] for r in staged.unit]

    def _execute_bucket(
        self, work: List[Tuple], fire_uid: str, first=None
    ) -> List[ServiceResponse]:
        """Fence one fused correction; bisect on allocation failure.

        ``first`` carries the front half's attempt-1 dispatch (handle or raw
        exception); retries and bisected halves re-dispatch here, without the
        shared staging buffer (the scheduler thread may be packing the next
        bucket into it).  Recursion depth is log2(len(work)); a
        single-request OOM rejects, so the recursion always terminates with
        every request retired.
        """
        if not work:
            return []
        pre = first if first is not None and first != (None, None) else None

        def _correct():
            nonlocal pre
            if pre is not None:
                handle, exc = pre
                pre = None
                if exc is not None:
                    raise exc
                return handle.result()
            return self._dispatch_bucket(work, fire_uid, staging=None).result()

        # retry budget for the fused call is carried by the bucket's first
        # request; a transient mid-bucket failure re-runs the whole bucket
        lead = work[0][0]
        t0 = self._clock()
        try:
            _corr, edits, stats = self._attempt(lead, "execute", _correct)
        except ResourceExhausted as err:
            self._tick("execute_s", t0)
            # cache hygiene first: the bisected halves must not allocate
            # against the stale full-size staging buffer
            self._staging_evict(self._bucket_rows(work))
            if len(work) == 1:
                return [self._reject(work[0][0], err)]
            self._count("bisects")
            for req, *_ in work:
                req.rungs.append("bisect")
            mid = len(work) // 2
            return self._execute_bucket(work[:mid], fire_uid) + self._execute_bucket(
                work[mid:], fire_uid
            )
        except FFCzError as err:
            self._tick("execute_s", t0)
            # non-OOM terminal failure: every request in the bucket rejects
            # with the same classified error
            return [self._reject(req, err) for req, *_ in work]
        self._tick("execute_s", t0)

        conv = stats.converged.cpu().numpy()  # the batch's flags, on the engine's device
        out = []
        t0 = self._clock()
        try:
            for j, ((req, base_blob, _eps0, tiles0, plan), (spat_t, freq_t)) in enumerate(
                zip(work, edits)
            ):
                req.converged = bool(conv[j]) if conv.size else True
                try:

                    def _encode(s=spat_t, f=freq_t, t=tiles0, p=plan, r=req):
                        self._fire("codec", r.uid)
                        return self.engine.encode_pencils(s, f, t, p, codec="zlib")

                    se, fe = self._attempt(req, "encode", _encode)
                    x = np.asarray(req.payload)
                    payload = _pencil_blob(x.shape, base_blob, se, fe, plan, self.config.block)
                    out.append(self._complete(req, payload))
                except FFCzError as err:
                    out.append(self._reject(req, err))
                except Exception as e:  # noqa: BLE001
                    out.append(self._reject(req, classify_exception(e, "encode")))
        finally:
            self._tick("encode_s", t0)
        return out

    # -- temporal stream path ----------------------------------------------

    def _run_stream(self, req: _Request) -> ServiceResponse:
        """Compress one temporal sequence into an FFCS container.

        Runs entirely in the back half: frame *t*'s predictor input and
        warm-start spectrum come from frame *t-1*'s results, so the chain
        cannot be split at the device fence.  Each frame runs under the
        per-request retry machinery (``StreamEncoder.add_frame`` mutates
        encoder state only after the frame fully succeeds, so a retried
        frame re-runs cleanly), with the standard codec/dispatch/oom fault
        sites fired per frame.
        """
        try:
            cfg, stream_cfg = req.cfg
            codec = TemporalCodec(self.base, cfg, stream=stream_cfg, engine=self.engine)
            enc = codec.open_stream()
            for frame in req.payload:
                self._check_deadline(req)

                def _frame(f=frame):
                    self._fire("codec", req.uid)
                    self._fire("dispatch", req.uid)
                    self._fire("oom", req.uid)
                    return enc.add_frame(f)

                self._attempt(req, "execute", _frame)
            req.converged = all(s["converged"] for s in enc.frame_stats)
            return self._complete(req, enc.finish())
        except FFCzError as err:
            return self._reject(req, err)
        except Exception as e:  # noqa: BLE001
            return self._reject(req, classify_exception(e, "execute"))

    # -- live session path -------------------------------------------------

    def _run_session(self, req: _Request) -> ServiceResponse:
        """Run one session op on the encode worker (or inline at depth 1).

        Appends go through the retry machinery: the manager's session sites
        fire with this request's uid, injected journal failures leave the
        frame pending (re-journaled on retry, not re-encoded), and terminal
        session errors — sequence gaps, closed sessions, exhausted budgets —
        reject structured like every other kind.
        """
        op, sid, seq = req.cfg
        try:
            self._check_deadline(req)
            if op == "append":

                def _append():
                    return self.sessions.append_frame(
                        sid, seq, req.payload, fire_uid=req.uid
                    )

                receipt = self._attempt(req, "execute", _append)
                req.converged = receipt.converged
                return self._complete(req, receipt)
            if op == "finalize":
                payload = self._attempt(
                    req,
                    "execute",
                    lambda: self.sessions.finalize(sid, fire_uid=req.uid),
                )
                return self._complete(req, payload)
            if op == "flush":
                n = self._attempt(req, "execute", lambda: self.sessions.flush(sid))
                return self._complete(req, n)
            if op == "abort":
                self.sessions.abort(sid)
                return self._complete(req, None)
            raise ValueError(f"unknown session op {op!r}")
        except FFCzError as err:
            return self._reject(req, err)
        except Exception as e:  # noqa: BLE001
            return self._reject(req, classify_exception(e, "session"))

    # -- decode path -------------------------------------------------------

    def _run_decompress(self, req: _Request) -> ServiceResponse:
        try:
            self._check_deadline(req)
            data: bytes = req.payload
            if data[:4] == _STREAM_MAGIC:
                codec = TemporalCodec(self.base, FFCzConfig(), engine=self.engine)
                return self._complete(req, np.stack(codec.decompress_stream(data)))
            if data[:4] == _PENCIL_MAGIC:
                return self._complete(req, decode_pencil_blob(data, self.base))
            # decode consumes no bound config — the blob carries its bounds
            ffcz = FFCz(self.base, FFCzConfig(), engine=self.engine)
            return self._complete(req, ffcz.decompress(FFCzBlob.from_bytes(data)))
        except FFCzError as err:
            return self._reject(req, err)
        except Exception as e:  # noqa: BLE001
            return self._reject(req, classify_exception(e, "decode"))

