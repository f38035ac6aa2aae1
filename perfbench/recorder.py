"""The engine the benchmark hands the clients: the cell's
``CorrectionEngine`` (or the control) behind a wrapper that records each
``correct`` call.

Untimed runs pass every call through and keep the results of the calls the
check samples.  Traced runs also fence each ``correct`` (a synchronise
before and after) and time it on the host, read its pencils' iteration
counts and how many converged, and mark it with a profiler range, so that
its device work can be told from the client's.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

CORRECT_SPAN = "perfbench.correct"


class Recorder:
    def __init__(self, engine, fenced: bool, sync=torch.cuda.synchronize):
        self.engine = engine
        self.sync = sync
        self.fenced = fenced
        self.keep = False
        self.kept: List = []  # results of the current call's corrects, when kept
        self.current: List[dict] = []  # the current call's corrects, when fenced
        self.calls: List[List[dict]] = []  # each finished call's, when fenced

    def begin(self, keep: bool) -> None:
        """Start an entry call; ``keep`` keeps its corrects' results."""
        self.keep, self.kept, self.current = keep, [], []

    def end(self) -> Optional[List]:
        """End the entry call; returns the kept results, if kept."""
        if self.fenced:
            self.calls.append(self.current)
        kept, self.kept = (self.kept if self.keep else None), []
        return kept

    def correct(self, tensors, E, Delta, block: int = 4096, max_iters: int = 50, **kw):
        if not self.fenced:
            out = self.engine.correct(tensors, E, Delta, block=block, max_iters=max_iters, **kw)
        else:
            self.sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(CORRECT_SPAN):
                out = self.engine.correct(tensors, E, Delta, block=block, max_iters=max_iters, **kw)
                self.sync()
            seconds = time.perf_counter() - t0
            its = out[-1].block_iterations
            self.current.append({"seconds": seconds, "block": block, "pencils": int(its.numel()),
                                 "iterations": int(its.sum()), "converged": int(out[-1].block_converged.sum()),
                                 "passes": int(its.max()) if its.numel() else 0})
        if self.keep:
            self.kept.append(out)
        return out
