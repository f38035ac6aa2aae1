"""Structured FFCz error taxonomy: stage, cause, and retry disposition.

Every failure that can escape the compression pipeline is classified along
two axes the serving layer acts on:

  transient vs permanent   will the same call plausibly succeed if repeated?
  retryable vs reject      should a caller with retry budget try again?

plus a ``disposition`` hint for failures that need a *different* retry, not
the same one:

  ``"retry"``    re-run the same work (backoff first) — host codec hiccups,
                 device dispatch failures.
  ``"bisect"``   the work unit is too large as batched — split it and run
                 the halves (device allocation failure on a batch).
  ``"reject"``   no retry will help — infeasible bounds, corrupt bytes.
  ``"timeout"``  the request's deadline passed; terminal by definition.

Errors carry the pipeline ``stage`` they surfaced in (``plan`` / ``base`` /
``execute`` / ``encode`` / ``decode`` / ``admit`` / ``session`` /
``service``) and the
original ``cause`` exception when they wrap one.  The decode-side
:class:`BlobCorruptError` and the plan-side :class:`InfeasibleBound` also
subclass ``ValueError`` so pre-taxonomy callers (and tests) that catch
``ValueError`` keep working unchanged.

:func:`classify_exception` maps arbitrary exceptions from the runtime onto
this taxonomy — it is how the engine stages turn a raw
``torch.cuda.OutOfMemoryError`` / CUDA ``RuntimeError`` / ``zlib.error`` /
``MemoryError`` into a disposition without string-matching at every call
site.
"""

from __future__ import annotations

from concurrent.futures import CancelledError
from typing import Optional

import torch


class FFCzError(Exception):
    """Base of the FFCz failure taxonomy (see module docstring)."""

    transient: bool = False
    retryable: bool = False
    disposition: str = "reject"  # "retry" | "bisect" | "reject" | "timeout"

    def __init__(self, message: str, *, stage: Optional[str] = None, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.stage = stage
        self.cause = cause

    def to_dict(self) -> dict:
        """Wire-friendly structured form for service rejection responses."""
        return {
            "type": type(self).__name__,
            "stage": self.stage,
            "message": str(self),
            "transient": self.transient,
            "retryable": self.retryable,
            "disposition": self.disposition,
            "cause": repr(self.cause) if self.cause is not None else None,
        }


class TransientError(FFCzError):
    """A failure the same call may not reproduce — retry with backoff."""

    transient = True
    retryable = True
    disposition = "retry"


class HostCodecError(TransientError):
    """Host-side codec (base compressor / entropy coder) raised mid-stream."""


class DeviceDispatchError(TransientError):
    """Device program dispatch / execution failed for a non-OOM reason."""


class ResourceExhausted(FFCzError):
    """Device allocation failure: not retryable as-is, but a *batch* is —
    split it and run the halves (``disposition == "bisect"``)."""

    transient = True
    retryable = False
    disposition = "bisect"


class PermanentError(FFCzError):
    """No retry will change the outcome — reject with reason."""


class InfeasibleBound(PermanentError, ValueError):
    """The requested spatial/frequency bound pair has no representable
    intersection (e.g. E underflows float32 after the quantization shrink).
    A *request* property, not a system fault: structured rejection, never a
    crash escaping the engine."""


class BlobCorruptError(PermanentError, ValueError):
    """Decode-side: truncated, bit-flipped, or foreign blob bytes.  Every
    decode path raises this (never a raw ``zlib.error`` / ``struct.error``)
    so untrusted inputs cannot crash a server with an unclassified
    exception."""

    def __init__(self, message: str, *, stage: str = "decode", cause: Optional[BaseException] = None):
        super().__init__(message, stage=stage, cause=cause)


class StreamStateError(PermanentError):
    """A stream encoder was driven through an illegal lifecycle transition
    (``add_frame`` after ``finish()``, double-``finish()``).  A caller bug,
    not a data fault: the encoder's committed state is left untouched so the
    already-emitted container stays valid."""


class SessionError(PermanentError):
    """Base for live-session failures (unknown/closed session, bad seq)."""

    def __init__(
        self,
        message: str,
        *,
        session_id: Optional[str] = None,
        stage: str = "session",
        cause: Optional[BaseException] = None,
    ):
        super().__init__(message, stage=stage, cause=cause)
        self.session_id = session_id


class SessionNotFound(SessionError):
    """The session id is unknown to this manager — never opened, already
    finalized/aborted, or evicted by lease expiry.  The message says which,
    so a client can distinguish "retry against the finalized container" from
    "open a new session"."""


class SessionSequenceError(SessionError, ValueError):
    """The client-assigned frame sequence number is unusable: a gap (frames
    would be silently skipped), a regression (negative / non-monotonic in a
    way no receipt covers), or a duplicate seq re-sent with *different* frame
    content (an idempotent retry must carry the same payload).  Structured
    reject — the session itself stays open and appendable."""

    def __init__(
        self,
        message: str,
        *,
        session_id: Optional[str] = None,
        expected: Optional[int] = None,
        got: Optional[int] = None,
        cause: Optional[BaseException] = None,
    ):
        super().__init__(message, session_id=session_id, cause=cause)
        self.expected = expected
        self.got = got


class DeadlineExceeded(PermanentError):
    """The request's deadline passed before the work completed."""

    disposition = "timeout"


class PipelineAborted(PermanentError):
    """The pipelined service tore down (or a stage's future was cancelled)
    while this request was in flight.  Terminal for the request — the work
    unit never ran to completion and will not be retried by this service
    instance — but carries no judgement about the request itself."""


_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "Out of memory",
    "Allocation failure",
    "failed to allocate",
)


def is_oom(exc: BaseException) -> bool:
    """Device/host allocation failure, by type or by runtime message."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _OOM_MARKERS)


def classify_exception(exc: BaseException, stage: str) -> FFCzError:
    """Map an arbitrary exception onto the taxonomy.

    Already-classified errors pass through (gaining ``stage`` if unset).
    Allocation failures become :class:`ResourceExhausted` (bisect), OS-level
    errors become :class:`HostCodecError` (retry), runtime/dispatch errors —
    including CUDA launch and kernel faults, which PyTorch raises as
    ``RuntimeError`` subclasses — become :class:`DeviceDispatchError`
    (retry), and contract violations
    (``ValueError`` / ``TypeError`` / ``KeyError``) become
    :class:`PermanentError` (reject).  Anything else is conservatively
    permanent: an unknown failure must never spin a retry loop.

    Thread-boundary contract (the pipelined service resolves EXECUTE/ENCODE
    on a worker thread): an :class:`FFCzError` raised inside a
    ``concurrent.futures`` future re-raises *as the same object* in the
    waiting thread, so classification survives the hop — the stage set where
    the error surfaced is preserved, never overwritten.  A cancelled future
    (service teardown mid-flight) classifies as :class:`PipelineAborted`
    rather than escaping as the ``BaseException``-derived ``CancelledError``.
    """
    if isinstance(exc, FFCzError):
        if exc.stage is None:
            exc.stage = stage
        return exc
    msg = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, CancelledError):
        return PipelineAborted(msg, stage=stage, cause=exc)
    if is_oom(exc):
        return ResourceExhausted(msg, stage=stage, cause=exc)
    if isinstance(exc, (OSError, EOFError)):
        return HostCodecError(msg, stage=stage, cause=exc)
    if isinstance(exc, RuntimeError):
        return DeviceDispatchError(msg, stage=stage, cause=exc)
    return PermanentError(msg, stage=stage, cause=exc)
