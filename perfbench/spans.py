"""The program's own spans of the traced cycle (``repro_torch.tracing``).

The port records spans only while a profiler records, so the records that
:func:`records` takes after a run are those of its traced cycle: the same
calls that the device trace covers.  They are taken once a run and kept on
the run, so that every reader of a run sees the same cycle.  A program
without spans (one older than ``repro_torch.tracing``) gives none.

Each span is also a ``record_function`` range of its name in the profiler's
Chrome trace.  The device time of a set of spans is the union of the device
operations (kernels, copies, sets) launched inside their ranges: a
device operation and its launch on the host share a correlation id.  It
counts device work only, whenever it runs, and none of the time the card
sits idle while the host works inside a span.  ``trace.profile`` parses the
Chrome trace and drops its events; importing this module makes
``trace.summarize`` keep the last trace's events for :func:`device_s`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from perfbench import trace

LAUNCHES = ("cuda_runtime", "cuda_driver")

_last: Dict[str, list] = {}


def _keeping(summarize):
    def keep(events):
        _last["events"] = events
        return summarize(events)

    keep.keeps_events = True
    return keep


if not getattr(trace.summarize, "keeps_events", False):
    trace.summarize = _keeping(trace.summarize)


def records(run) -> Optional[List[dict]]:
    """The traced cycle's span records, or ``None``: no device trace
    (``run.timeline`` is ``None``), a program that records no spans, or
    spans dropped beyond the program's cap.  The run also keeps the traced
    cycle's Chrome trace events (``run.trace_events``, empty if none)."""
    if run.timeline is None:
        return None
    if "program_spans" not in vars(run):
        run.trace_events = _last.pop("events", [])
        try:
            from repro_torch import tracing
        except ImportError:
            run.program_spans = None
        else:
            taken, dropped = tracing.take()
            run.program_spans = None if dropped else taken
    return run.program_spans


def roots(recs: List[dict]) -> List[dict]:
    """The calls' root spans: those opened inside no other span."""
    return [r for r in recs if r["parent"] is None]


def named(recs: List[dict], name: str) -> List[dict]:
    """The spans called ``name``."""
    return [r for r in recs if r["name"] == name]


def host_s(spans: Iterable[dict]) -> float:
    """Host seconds inside ``spans``."""
    return sum(r["end_ns"] - r["start_ns"] for r in spans) * 1e-9


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total * 1e-6


def device_s(run, names: Iterable[str]) -> Optional[float]:
    """Device seconds of the work launched inside the ranges called
    ``names`` (their union), or ``None`` where the trace holds no such
    range or no device operation launched inside one."""
    names = set(names)
    ranges: Dict[object, List[Tuple[float, float]]] = {}
    launches, ops = {}, []
    for e in getattr(run, "trace_events", ()):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, a = e.get("cat", ""), float(e["ts"])
        if cat == "user_annotation" and e.get("name") in names:
            ranges.setdefault(e.get("tid"), []).append((a, a + float(e["dur"])))
        elif cat in LAUNCHES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), a)
        elif cat in trace.DEVICE_CATEGORIES and "correlation" in e.get("args", {}):
            ops.append((e["args"]["correlation"], a, a + float(e["dur"])))
    if not ranges:
        return None
    inside = []
    for corr, a, b in ops:
        tid, t = launches.get(corr, (None, None))
        if t is not None and any(x <= t <= y for x, y in ranges.get(tid, ())):
            inside.append((a, b))
    return _union_s(inside) if inside else None
