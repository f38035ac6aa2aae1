"""CPU tests of the readers of the program's spans (``spans.py`` and the
metrics that read it), on the records of tiny traced calls of both clients
under a CPU profiler, with a stand-in for the device timeline."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import spans, spec

BENCH = spec.Spec(spec.HERE.parent / "BENCHMARK.json")
HOST = ("engine_span_pct", "loop_wait_pct")
DEVICE = ("pack_device_pct", "loop_roofline_pct")
CLIENTS = ("compress_cache", "compress_gradients")


def _call(client: str) -> None:
    from repro_torch.core.engine import CorrectionEngine

    engine = CorrectionEngine(device="cpu", fft_impl="pallas")
    g = torch.Generator().manual_seed(11)
    if client == "compress_cache":
        from repro_torch.serving.kv_compress import compress_cache

        cache = {"moe": {"k": torch.randn(2, 1, 2, 150, 8, generator=g).to(torch.bfloat16),
                         "v": torch.randn(2, 1, 2, 150, 8, generator=g).to(torch.bfloat16)}}
        compress_cache(cache, SimpleNamespace(kv_E_rel=1e-2, kv_Delta_rel=1e-4), block=64, engine=engine)
    else:
        from repro_torch.optim.grad_compress import compress_gradients

        compress_gradients({"w": torch.randn(12, 300, generator=g), "b": torch.randn(70, generator=g)},
                           Delta_rel=5e-5, block=256, engine=engine)


def _traced_run(client: str, timeline=True):
    """A run's namespace after a traced call of ``client``."""
    from repro_torch import tracing

    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        _call(client)
    return SimpleNamespace(timeline=SimpleNamespace() if timeline else None)


def _read(name: str, run):
    return BENCH.metric(name).read(run)


def test_the_four_metrics_are_in_the_benchmark():
    per_layer = {m["name"]: m for m in BENCH.data["per_layer"]}
    for name in HOST + DEVICE:
        source = "program_span" if name in HOST else "device_trace"
        assert per_layer[name]["source"] == source and per_layer[name]["unit"] == "%"
        assert "workloads" not in per_layer[name]


@pytest.mark.parametrize("client", CLIENTS)
def test_the_host_clock_readers_give_a_share(client):
    run = _traced_run(client)
    for name in HOST:
        assert 0.0 < _read(name, run) <= 100.0, name
    # every reader of a run reads the records taken once
    assert run.program_spans and spans.records(run) is run.program_spans


@pytest.mark.parametrize("client", CLIENTS)
def test_the_device_extent_readers_find_nothing_on_the_cpu(client):
    run = _traced_run(client)
    assert spans.records(run)
    for name in DEVICE:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("client", CLIENTS)
def test_every_reader_gives_nothing_without_a_device_trace(client):
    run = _traced_run(client, timeline=False)
    for name in HOST + DEVICE:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("client", CLIENTS)
def test_every_reader_gives_nothing_where_spans_were_dropped(client, monkeypatch):
    from repro_torch import tracing

    monkeypatch.setattr(tracing.RECORDER, "cap", 3)
    run = _traced_run(client)
    assert spans.records(run) is None
    for name in HOST + DEVICE:
        assert _read(name, run) is None, name


def _range(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a, "tid": tid}


def _launch(corr, t, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 5, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, a, b):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a, "dur": b - a, "tid": 7,
            "args": {"correlation": corr}}


def test_the_device_readers_count_the_work_launched_inside_the_ranges():
    # times in us: a call whose correct packs, loops and unpacks; a kernel
    # of the client before it, and one launched from another thread
    events = [
        _range("ffcz.kv.compress_cache", 0, 1200), _range("ffcz.engine.correct", 100, 1100),
        _range("ffcz.engine.pack", 100, 200), _range("ffcz.loop", 200, 900), _range("ffcz.engine.unpack", 900, 1100),
        _launch(1, 150), _kernel(1, 160, 260),
        _launch(2, 300), _kernel(2, 310, 710),
        _launch(3, 400), _kernel(3, 700, 900),  # overlaps the one before by 10 us
        _launch(4, 950), _kernel(4, 1000, 1100),
        _launch(5, 50), _kernel(5, 1150, 1190),
        _launch(6, 300, tid=2), _kernel(6, 1110, 1140),
    ]
    recs = [
        {"name": "ffcz.kv.compress_cache", "id": 1, "parent": None, "root": 1, "start_ns": 0,
         "end_ns": 10_000_000, "counts": {}},
        {"name": "ffcz.engine.correct", "id": 2, "parent": 1, "root": 1, "start_ns": 1_000_000,
         "end_ns": 9_000_000, "counts": {}},
        {"name": "ffcz.loop", "id": 3, "parent": 2, "root": 1, "start_ns": 2_000_000, "end_ns": 8_000_000,
         "counts": {"rows": 1000, "block": 1024, "iterations": 2000, "converged": 1000}},
    ]
    run = SimpleNamespace(timeline=SimpleNamespace(), program_spans=recs, trace_events=events)
    assert spans.device_s(run, ("ffcz.loop",)) == pytest.approx(590e-6)
    assert _read("pack_device_pct", run) == pytest.approx(100.0 * 200 / (100 + 590 + 100))
    assert _read("engine_span_pct", run) == pytest.approx(80.0)
    from perfbench import counts

    least = counts.least_seconds(*counts.correction_work([(1024, 1000, 2000, 1000)]))[0]
    assert _read("loop_roofline_pct", run) == pytest.approx(100.0 * least / 590e-6)
    # a trace with no such range, or no work launched inside one
    assert spans.device_s(run, ("ffcz.other",)) is None
    assert spans.device_s(SimpleNamespace(trace_events=events[:5]), ("ffcz.loop",)) is None


def test_the_trace_summary_keeps_its_events_for_the_readers():
    from perfbench import trace

    events = [{"ph": "X", "cat": "user_annotation", "name": trace.CALL_SPAN, "ts": 0, "dur": 100, "tid": 1},
              _kernel(1, 10, 20)]
    assert trace.summarize(events).busy_s == pytest.approx(10e-6)
    run = SimpleNamespace(timeline=SimpleNamespace())
    spans.records(run)
    assert run.trace_events is events
    # taken once: the next run starts with none
    later = SimpleNamespace(timeline=SimpleNamespace())
    spans.records(later)
    assert later.trace_events == []


def test_a_span_opened_inside_no_other_is_a_root():
    recs = [{"name": "ffcz.engine.correct", "id": 4, "parent": None, "root": 4, "start_ns": 0, "end_ns": 10,
             "counts": {}},
            {"name": "ffcz.loop", "id": 5, "parent": 4, "root": 4, "start_ns": 2, "end_ns": 8, "counts": {}}]
    assert spans.roots(recs) == recs[:1]
    run = SimpleNamespace(timeline=SimpleNamespace(), program_spans=recs)
    assert _read("engine_span_pct", run) == pytest.approx(100.0)
