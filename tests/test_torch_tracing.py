"""The pencil path's spans (``repro_torch.tracing``) on the CPU.

Off (no profiler recording), a span records nothing, calls no profiler
range and dispatches nothing that the undecorated functions and a bare
``nullcontext`` would not.  On, under a CPU ``torch.profiler`` session, the
spans nest client call > engine > pack, loop (> wait), unpack under one
root a call, the loop's counts equal the engine's ``BatchCorrectionStats``,
and every span is a range of the profiler's trace.
"""

import contextlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.pocs import alternating_projection
from repro_torch.optim.grad_compress import compress_gradients
from repro_torch.serving.kv_compress import compress_cache

BLOCK = 64
TIGHT, DEFAULT = 1e-4, 1e-2  # kv_Delta_rel: every pencil steps; none does


def _cache():
    g = torch.Generator().manual_seed(7)
    kv = [torch.randn(2, 1, 2, 150, 8, generator=g).to(torch.bfloat16) for _ in range(2)]
    return {"moe": {"k": kv[0], "v": kv[1], "pos": torch.zeros(3)}}


def _grads():
    g = torch.Generator().manual_seed(8)
    return {"w": torch.randn(12, 300, generator=g), "b": torch.randn(70, generator=g), "s": torch.ones(1)}


def _comp(delta_rel=TIGHT):
    return SimpleNamespace(kv_E_rel=1e-2, kv_Delta_rel=delta_rel)


class _Keeping:
    """An engine that keeps each ``correct`` call's stats."""

    def __init__(self):
        self.engine = CorrectionEngine(device="cpu", fft_impl="pallas")
        self.stats = []

    def correct(self, *args, **kw):
        out = self.engine.correct(*args, **kw)
        self.stats.append(out[-1])
        return out


def _calls(kv=compress_cache, grad=compress_gradients):
    engine = CorrectionEngine(device="cpu", fft_impl="pallas")
    kv(_cache(), _comp(), block=BLOCK, engine=engine)
    grad(_grads(), Delta_rel=5e-5, block=256, engine=engine)


@pytest.fixture(autouse=True)
def _empty_recorder():
    tracing.take()
    yield
    tracing.take()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    _calls()
    assert tracing.take() == ([], 0)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _dispatched(**clients):
    with _Ops() as mode:
        _calls(**clients)
    return mode.ops


def test_off_dispatches_the_ops_of_the_undecorated_calls(monkeypatch):
    traced = _dispatched()
    monkeypatch.setattr(tracing, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(CorrectionEngine, "correct", CorrectionEngine.correct.__wrapped__)
    bare = _dispatched(kv=compress_cache.__wrapped__, grad=compress_gradients.__wrapped__)
    assert traced == bare and len(traced) > 100


def test_on_each_call_nests_under_its_own_root():
    _profiled(lambda: [compress_cache(_cache(), _comp(), block=BLOCK, engine=CorrectionEngine(device="cpu"))
                       for _ in range(2)])
    recs, dropped = tracing.take()
    assert dropped == 0
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["ffcz.kv.compress_cache"] * 2
    assert all(r["root"] == r["id"] and r["counts"] == {} for r in roots)
    want = {"ffcz.engine.correct": "ffcz.kv.compress_cache", "ffcz.engine.pack": "ffcz.engine.correct",
            "ffcz.loop": "ffcz.engine.correct", "ffcz.loop.wait": "ffcz.loop",
            "ffcz.engine.unpack": "ffcz.engine.correct"}
    for root in roots:
        mine = [r for r in recs if r["root"] == root["id"] and r is not root]
        assert {r["name"] for r in mine} == set(want)
        assert all(by_id[r["parent"]]["name"] == want[r["name"]] for r in mine)
        assert all(root["start_ns"] <= r["start_ns"] <= r["end_ns"] <= root["end_ns"] for r in mine)
        loop = next(r for r in mine if r["name"] == "ffcz.loop")
        assert loop["counts"]["rows"] == 4 * -(-2 * 150 * 8 // BLOCK) and loop["counts"]["block"] == BLOCK


def test_on_gradient_calls_root_every_correct():
    _profiled(lambda: compress_gradients(_grads(), Delta_rel=5e-5, block=256,
                                         engine=CorrectionEngine(device="cpu")))
    recs, _ = tracing.take()
    [root] = [r for r in recs if r["parent"] is None]
    assert root["name"] == "ffcz.grad.compress_gradients"
    corrects = [r for r in recs if r["name"] == "ffcz.engine.correct"]
    assert len(corrects) == 2 and all(r["parent"] == root["id"] and r["root"] == root["id"] for r in corrects)
    # one correct a pencil length: 256, and 70 for the short leaf
    loops = [r for r in recs if r["name"] == "ffcz.loop"]
    assert sorted(r["counts"]["block"] for r in loops) == [70, 256]
    assert {r["parent"] for r in loops} == {r["id"] for r in corrects}


@pytest.mark.parametrize("delta_rel", [TIGHT, DEFAULT])
def test_on_loop_counts_equal_the_engines_stats_with_one_wait_a_pass(delta_rel):
    engine = _Keeping()
    _profiled(lambda: compress_cache(_cache(), _comp(delta_rel), block=BLOCK, engine=engine))
    recs, _ = tracing.take()
    [loop] = [r for r in recs if r["name"] == "ffcz.loop"]
    [stats] = engine.stats
    its = stats.block_iterations
    assert loop["counts"] == {"rows": int(its.numel()), "block": BLOCK, "iterations": int(its.sum()),
                              "converged": int(stats.block_converged.sum())}
    # one wait a pass: as many as the most steps any pencil took
    waits = [r for r in recs if r["name"] == "ffcz.loop.wait"]
    assert len(waits) == int(its.max()) == (2 if delta_rel == TIGHT else 1)
    assert all(r["parent"] == loop["id"] for r in waits)


def test_on_the_whole_field_loop_waits_once_an_iteration():
    eps = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (16, 12)).astype(np.float32))
    res = []
    _profiled(lambda: res.append(alternating_projection(eps, 1.0, 0.5, max_iters=6)))
    recs, _ = tracing.take()
    assert [r["name"] for r in recs] == ["ffcz.loop.wait"] * res[0].iterations and res[0].iterations > 1


def test_on_the_async_path_packs_on_the_host_then_on_the_device():
    engine = CorrectionEngine(device="cpu")
    errs = [torch.randn(300) * 1e-3, torch.randn(2, 100) * 1e-3]
    _profiled(lambda: engine.correct_async(errs, 1e-2, 1e-4, block=BLOCK).result())
    recs, _ = tracing.take()
    [correct] = [r for r in recs if r["name"] == "ffcz.engine.correct"]
    assert correct["parent"] is None
    inside = [r["name"] for r in recs if r["parent"] == correct["id"]]
    # the host staging, then the copy to the device; the stats
    assert inside == ["ffcz.engine.pack", "ffcz.engine.pack", "ffcz.loop", "ffcz.engine.unpack"]
    [loop] = [r for r in recs if r["name"] == "ffcz.loop"]
    assert loop["counts"]["rows"] == 5 + 4


def test_the_chrome_trace_holds_every_span_as_a_user_annotation(tmp_path):
    prof = _profiled(_calls)
    names = {r["name"] for r in tracing.take()[0]}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "user_annotation"}
    assert len(names) == 7 and names <= ranges


def test_a_worker_threads_spans_parent_within_that_thread():
    def worker():
        with tracing.span("worker"):
            with tracing.span("worker.inner"):
                pass

    def main():
        with tracing.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
            with tracing.span("main.inner"):
                pass

    _profiled(main)
    recs = {r["name"]: r for r in tracing.take()[0]}
    assert recs["worker"]["parent"] is None and recs["worker"]["root"] == recs["worker"]["id"]
    assert recs["worker.inner"]["parent"] == recs["worker"]["id"] == recs["worker.inner"]["root"]
    assert recs["main.inner"]["parent"] == recs["main"]["id"] == recs["main.inner"]["root"]


def test_the_cap_counts_what_it_drops():
    recorder = tracing.SpanRecorder(cap=2)

    def spans():
        for i in range(5):
            with recorder.span(f"s{i}") as s:
                s.count(i=i)

    _profiled(spans)
    recs, dropped = recorder.take()
    assert [(r["name"], r["counts"]) for r in recs] == [("s0", {"i": 0}), ("s1", {"i": 1})]
    assert dropped == 3
    assert recorder.take() == ([], 0)
