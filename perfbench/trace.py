"""The device timeline of a few calls, from ``torch.profiler``.

The profiler's Chrome trace puts the host's ranges and the device's
kernels, copies and sets on one clock.  Each entry call is a range
(:data:`CALL_SPAN`), each fenced ``correct`` another
(``recorder.CORRECT_SPAN``): since a fence empties the device before and
after, a device operation that starts inside a ``correct`` range is that
correction's work, and any other inside a call range is the client's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple


from .recorder import CORRECT_SPAN

CALL_SPAN = "perfbench.call"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Timeline:
    window_s: float  # first call range's start to the last one's end
    busy_s: float  # union of device operations inside the window
    correct_s: float  # device seconds inside correct ranges
    client_s: float  # device seconds inside call ranges, outside correct ranges
    device_ops: List[Tuple[str, float]]  # the TOP operations by summed seconds
    idle_gaps: List[Tuple[str, float]]  # the TOP longest gaps, by what the host was doing


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _inside(t: float, spans: List[Tuple[float, float]]) -> bool:
    return any(a <= t <= b for a, b in spans)


def summarize(events: List[dict]) -> Timeline:
    """A :class:`Timeline` of a Chrome trace's events (times in us)."""
    device, host, calls, corrects = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append((a, b, e.get("name", "")))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"):
            host.append((a, b, e.get("name", "")))
            if cat == "user_annotation" and e.get("name") == CALL_SPAN:
                calls.append((a, b))
            elif cat == "user_annotation" and e.get("name") == CORRECT_SPAN:
                corrects.append((a, b))
    if not calls or not device:
        raise RuntimeError("the trace holds no call range or no device operation")
    lo, hi = min(a for a, _ in calls), max(b for _, b in calls)
    device = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _ in device])
    correct_s = client_s = 0.0
    by_name: Dict[str, float] = {}
    for a, b, n in device:
        d = (b - a) * 1e-6
        by_name[n] = by_name.get(n, 0.0) + d
        if _inside(a, corrects):
            correct_s += d
        elif _inside(a, calls):
            client_s += d
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    spans = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a), reverse=True)[:TOP]
    gaps = []
    for length, a, b in spans:
        mid = (a + b) / 2
        around = [(y - x, n) for x, y, n in host if x <= mid <= y and n != CALL_SPAN]
        gaps.append((min(around)[1] if around else "host outside any range", length * 1e-6))
    return Timeline(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        correct_s=correct_s,
        client_s=client_s,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=gaps[:TOP],
    )


def profile(calls: Callable[[Callable[[], object]], None]) -> Timeline:
    """Run ``calls(mark)`` under the profiler, where ``mark()`` gives the
    context of one entry call's range; its Chrome trace goes to a temporary
    file (under ``TMPDIR``) that is read and removed."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls(lambda: record_function(CALL_SPAN))
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)
