"""Spans at the layer boundaries of the pencil path, on the profiler's clock.

A span is one call of a layer: its name, its id, its parent's id (the
innermost span open on the same thread when it opened), the id of its
call's root span (every span of one call shares it), its host start and end
(``time.perf_counter_ns``) and named counts.

Spans record only while a ``torch.profiler`` session records: profiling the
process turns them on, and nothing else does.  While on, every span also
opens a ``torch.profiler.record_function`` range of its name, so the
program's layers lie on the profiler's clock beside the kernels, and the
device work of a span is that of the kernels launched inside its range.
While off, :func:`span` reads one module attribute and returns a shared
``nullcontext``, and a function wrapped by :func:`traced` is called as it
is: no clock, no tensor, no profiler call.  Callers compute a span's counts
only under ``if s:``, which the off path skips.

Finished spans are kept in memory, at most :data:`CAP` of them, and counted
in ``dropped`` beyond that.  :func:`take` hands them over and empties the
store; a count given as a device scalar is read there, never on the path
that records it.

Spans of the pencil path (``serving/kv_compress``, ``optim/grad_compress``,
``core/engine``, ``core/blockwise``, ``core/pocs``):

- ``ffcz.kv.compress_cache``, ``ffcz.grad.compress_gradients``,
  ``ffcz.grad.compress_sharded_gradients``: a client's call.
- ``ffcz.engine.correct``: ``CorrectionEngine.correct`` and
  ``correct_async``.
- ``ffcz.engine.pack``: bounds, tiling, concatenation, segment ids.
- ``ffcz.loop``: the packed POCS loop; ``rows``, ``block``, ``iterations``
  (summed over the rows) and ``converged`` (rows), the last two summed on
  the device.
- ``ffcz.loop.wait``: one read-back of a loop's convergence count.
- ``ffcz.engine.unpack``: per-tensor stats, untiling, casts back.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import profiler as _profiler

#: finished spans kept in memory until :func:`take`
CAP = 1 << 16

OFF = contextlib.nullcontext()


class Span:
    """One open or finished span (see the module docstring)."""

    __slots__ = ("_recorder", "name", "id", "parent", "root", "start_ns", "end_ns", "counts", "_range")

    def __init__(self, recorder: "SpanRecorder", name: str):
        self._recorder = recorder
        self.name = name
        self.counts: Dict[str, object] = {}

    def count(self, **counts) -> None:
        """Set named counts: numbers, or device scalars that :func:`take` reads."""
        self.counts.update(counts)

    def __enter__(self) -> "Span":
        stack = self._recorder._stack()
        parent = stack[-1] if stack else None
        self.id = next(self._recorder._ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._recorder._stack().pop()
        self._recorder._finish(self)
        return False

    def record(self) -> dict:
        """The finished span as a dict."""
        return {
            "name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
            "start_ns": self.start_ns, "end_ns": self.end_ns,
            "counts": {k: int(v) if isinstance(v, torch.Tensor) else v for k, v in self.counts.items()},
        }


class SpanRecorder:
    """Hands out spans while a profiler records and keeps the finished ones,
    at most ``cap``; each thread keeps its own stack of open spans."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.dropped = 0
        self._done: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str):
        """A context manager: a :class:`Span` while a profiler records, else
        :data:`OFF` (``as`` gives ``None``)."""
        if not _profiler._is_profiler_enabled:
            return OFF
        return Span(self, name)

    def take(self) -> Tuple[List[dict], int]:
        """The finished spans' records, in the order they finished, and the
        count dropped beyond the cap; empties both."""
        with self._lock:
            done, dropped = self._done, self.dropped
            self._done, self.dropped = [], 0
        return [s.record() for s in done], dropped

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._done) < self.cap:
                self._done.append(span)
            else:
                self.dropped += 1


#: the process's recorder: the pencil path's spans go here
RECORDER = SpanRecorder()
span = RECORDER.span
take = RECORDER.take


def traced(name: str):
    """Decorate a function so that each call is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(RECORDER, name):
                return fn(*args, **kwargs)
        return call
    return wrap
