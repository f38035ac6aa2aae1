"""Deterministic fault injection for exercising the FFCz service failure path.

The chaos suite (tests/test_faults.py) needs the *same* faults on every run:
a flaky test that only sometimes exercises the retry ladder proves nothing.
Since the pipelined service runs a request's ENCODE on a worker
thread while the scheduler thread dispatches the next bucket's EXECUTE, the
*global* wall-clock order of ``fire`` calls is no longer deterministic — it
depends on thread interleaving.  What IS deterministic, in serial and
pipelined mode alike, is the per-request order: a request's plan always
precedes its base codec call, which precedes its execute attempts, which
precede its encode attempts.  So every probabilistic decision here flows
from a *per-request* seeded ``np.random.default_rng`` substream (derived
from ``(seed, uid)``), and the fire cap is counted per ``(site, uid)``:
given the same seed and the same per-request sequence of ``fire`` calls,
the same faults fire — regardless of how requests interleave across
threads.  That is the property the chaos suite's serial-vs-pipelined
counter-parity test gates.

Injection sites mirror the real failure surface of the pipeline:

  ``codec``     host base-codec / entropy-coder failure (``OSError``-shaped,
                classified transient -> retried with backoff)
  ``dispatch``  device program dispatch failure (``RuntimeError``-shaped,
                transient -> retried; the service's ladder also descends
                fft_impl rungs when retries exhaust)
  ``oom``       device allocation failure (message carries the XLA
                ``RESOURCE_EXHAUSTED`` marker -> batch bisection).  Fused
                pencil buckets fire this site with the ORIGINAL bucket
                lead's uid through the whole bisect recursion, so the cap
                applies to the bucket as a unit, not per sub-bucket.
  ``slow``      the request takes ``slow_s`` longer than it should (tests the
                deadline path; returned as a delay, never an exception)

  ``session_append``   live-session append fails before the frame is encoded
                (``RuntimeError``-shaped -> retried); fired with the append
                request's uid so the sequence stays scheduling-invariant
  ``session_journal``  the write-ahead journal append fails after the frame
                encoded (``OSError``-shaped -> retried); the session keeps
                the encoded-but-unjournaled frame pending so the retry
                re-journals without re-encoding

plus two pure byte-corruption helpers (``flip_bit`` / ``truncate``) for the
decode-hardening fuzz tests (these draw from a plain shared stream — they
are test-harness primitives, not service-threaded sites).

``max_per_site`` caps how many times each site fires *per request* so an
injector with ``p=1.0`` still lets the work eventually succeed — that is
exactly the "transient" contract the retry ladder is built for.

All mutable state (per-request streams, fire counts) is guarded by a lock:
the pipelined service fires sites from both the scheduler thread and the
encode worker thread.

The service-side view of these sites (which stage fires what, and how each
classified error walks the degradation ladder) is docs/serving.md.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np


class InjectedCodecError(OSError):
    """Injected host-codec failure (classifies as HostCodecError -> retry)."""


class InjectedDispatchError(RuntimeError):
    """Injected device-dispatch failure (classifies as DeviceDispatchError)."""


class InjectedOOM(RuntimeError):
    """Injected device allocation failure; the message carries the XLA OOM
    marker so :func:`repro_torch.core.errors.is_oom` classifies it for bisection."""

    def __init__(self, message: str = "injected allocation failure"):
        # the marker must survive any caller-supplied message, or the error
        # classifies as a plain dispatch failure and gets retried not bisected
        super().__init__(f"RESOURCE_EXHAUSTED: {message}")


class InjectedJournalError(OSError):
    """Injected session-journal write failure (``OSError``-shaped, so it
    classifies as HostCodecError -> retried; the write-ahead discipline means
    the un-acked frame is simply re-journaled on the retry)."""


class InjectedAppendError(RuntimeError):
    """Injected session-append failure before the frame is encoded
    (``RuntimeError``-shaped -> DeviceDispatchError -> retried)."""


_SITE_ERRORS = {
    "codec": InjectedCodecError,
    "dispatch": InjectedDispatchError,
    "oom": InjectedOOM,
    "session_journal": InjectedJournalError,
    "session_append": InjectedAppendError,
}


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-site fire probabilities and knobs for one injector."""

    p_codec: float = 0.0
    p_dispatch: float = 0.0
    p_oom: float = 0.0
    p_slow: float = 0.0
    p_session_journal: float = 0.0
    p_session_append: float = 0.0
    slow_s: float = 0.0  # extra latency charged to a request when "slow" fires
    # Per-(site, request) fire cap: after this many fires a site goes quiet
    # for that request, so even p=1.0 faults stay transient and the retry
    # ladder can drain the queue.
    max_per_site: int = 2

    def probability(self, site: str) -> float:
        try:
            return {
                "codec": self.p_codec,
                "dispatch": self.p_dispatch,
                "oom": self.p_oom,
                "slow": self.p_slow,
                "session_journal": self.p_session_journal,
                "session_append": self.p_session_append,
            }[site]
        except KeyError:
            raise ValueError(f"unknown fault site {site!r}") from None


class FaultInjector:
    """Seeded, thread-safe source of faults; ``None`` config or all-zero
    probabilities makes every call a no-op, so production code paths can call
    into an always-present injector unconditionally."""

    def __init__(self, config: Optional[FaultConfig] = None, seed: int = 0):
        self.config = config or FaultConfig()
        self.seed = seed
        self._rng = np.random.default_rng(seed)  # corruption primitives only
        self._lock = threading.Lock()
        self._streams: Dict[str, np.random.Generator] = {}
        self.fired: Dict[Tuple[str, str], int] = {}

    # -- exception sites --------------------------------------------------

    def fire(self, site: str, uid: str = "") -> None:
        """Raise the site's injected error if the (seeded) die says so.

        The decision comes from the request's own ``(seed, uid)`` substream,
        so it depends only on the per-request call sequence — never on how
        requests from different buckets interleave across service threads.
        """
        if not self._draw(site, uid):
            return
        exc_type = _SITE_ERRORS[site]
        raise exc_type(f"injected {site} fault (uid={uid})")

    def sleep_s(self, uid: str = "") -> float:
        """Extra latency to charge the current request (0.0 when the ``slow``
        site does not fire).  Returned, not slept: the service adds it to the
        request's clock so deadline tests stay fast."""
        return self.config.slow_s if self._draw("slow", uid) else 0.0

    def _stream(self, uid: str) -> np.random.Generator:
        # one substream per request: crc32(uid) folds the uid into the seed
        # material deterministically across processes (unlike hash())
        if uid not in self._streams:
            self._streams[uid] = np.random.default_rng(
                [self.seed, zlib.crc32(uid.encode("utf-8"))]
            )
        return self._streams[uid]

    def _draw(self, site: str, uid: str) -> bool:
        p = self.config.probability(site)
        with self._lock:
            if p <= 0.0:
                return False
            if self.fired.get((site, uid), 0) >= self.config.max_per_site:
                return False
            # Always consume exactly one draw per call so a request's
            # fire/no-fire sequence is reproducible regardless of which
            # sites are enabled.
            hit = bool(self._stream(uid).random() < p)
            if hit:
                self.fired[(site, uid)] = self.fired.get((site, uid), 0) + 1
            return hit

    # -- byte corruption (decode fuzzing) ---------------------------------

    def flip_bit(self, blob: bytes, position: Optional[int] = None) -> bytes:
        """Return ``blob`` with one bit flipped (seeded position by default)."""
        if not blob:
            return blob
        if position is None:
            position = int(self._rng.integers(0, len(blob) * 8))
        byte_i, bit_i = divmod(position, 8)
        out = bytearray(blob)
        out[byte_i] ^= 1 << bit_i
        return bytes(out)

    def truncate(self, blob: bytes, keep: Optional[int] = None) -> bytes:
        """Return a truncated prefix of ``blob`` (seeded length by default)."""
        if keep is None:
            keep = int(self._rng.integers(0, len(blob)))
        return blob[:keep]

    def corrupt_blob(self, blob: bytes) -> bytes:
        """Randomly flip a bit or truncate — the mixed-mode fuzz primitive."""
        if self._rng.random() < 0.5:
            return self.flip_bit(blob)
        return self.truncate(blob)
