"""CPU tests of whole runs: the tiny benchmark (``tiny.py``) through
``run.run_cell`` on the port's CPU twins, past the harness's look for a
card.  A sound run is correct; the lower-precision control and a timed path
broken underneath are not."""

import json
import shutil

import pytest
import torch

from perfbench import run, spec, tiny

BENCH = spec.Spec(spec.HERE.parent / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH.data["workloads"]]


def _first_cell(entry):
    """The first cell whose configuration drives ``entry``."""
    return next(c for c in CELLS if BENCH.config(BENCH.cell(c))["entry"] == entry)

SEED = 2**31 + 99  # more than 32 signed bits hold
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny_spec(tmp_path_factory):
    path = tiny.make(tmp_path_factory.mktemp("tiny"))
    return spec.Spec(path, root=path.parent / "perfbench")


def _run(s, cell, **kw):
    return run.run_cell(s, cell, SEED, 0.2, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_contract_keys(tiny_spec, cell):
    result = json.loads(json.dumps(_run(tiny_spec, cell)))
    # the contract's keys, then the numbers compared, last
    assert list(result) == CONTRACT + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in tiny_spec.metrics(tiny_spec.cell(cell), trace=False)}
    assert set(result["metrics"]) == names
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} and c["value"] <= c["limit"] for c in result["checks"].values())


def test_a_traced_run_on_the_cpu_reports_the_host_clock_layers(tiny_spec):
    result = run.run_cell(tiny_spec, CELLS[0], SEED, 0.2, True, device="cpu")
    assert result["correct"] is True
    # no device trace on the CPU: the device's metrics are left out
    assert set(result["metrics"]) == {"engine_share_pct", "loop_passes"}
    assert "breakdown" not in result


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_refused(tiny_spec, cell):
    result = _run(tiny_spec, cell, control="bf16")
    assert result["correct"] is False
    assert result["checks"]["gap_over_E"]["value"] > result["checks"]["gap_over_E"]["limit"]


def _altered_correct(original):
    def correct(self, *args, **kw):
        out, stats = original(self, *args, **kw)
        out = [t.clone() for t in out]
        out[0].view(-1)[0] += out[0].abs().max()
        return out, stats
    return correct


def _skipped_correct(self, tensors, E, Delta, **kw):
    from repro_torch.core.blockwise import empty_stats

    stats = empty_stats("cpu")
    stats.block_iterations = torch.ones(1, dtype=torch.int32)
    return [t.clone() for t in tensors], stats


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_the_correction_produces_it_is_refused(tiny_spec, cell, monkeypatch):
    from repro_torch.core.engine import CorrectionEngine

    monkeypatch.setattr(CorrectionEngine, "correct", _altered_correct(CorrectionEngine.correct))
    assert _run(tiny_spec, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_a_correction_that_returns_its_input_unchanged_is_refused(tiny_spec, cell, monkeypatch):
    from repro_torch.core.engine import CorrectionEngine

    # refused wherever the sound loop steps a pencil; where it steps none,
    # returning the input is the correction
    steps = run.run_cell(tiny_spec, cell, SEED, 0.2, True, device="cpu")["metrics"]["loop_passes"]["value"] > 1
    monkeypatch.setattr(CorrectionEngine, "correct", _skipped_correct)
    result = _run(tiny_spec, cell)
    assert result["correct"] is not steps
    spectrum = result["checks"]["spectrum_over_Delta"]
    assert (spectrum["value"] > spectrum["limit"]) is steps


@pytest.mark.parametrize("cell", CELLS)
def test_a_float64_polish_on_the_timed_path_is_refused(tiny_spec, cell, monkeypatch):
    import numpy as np

    from repro_torch.core import engine

    original = engine.CorrectionEngine.correct

    def polished(self, *args, **kw):
        # the host's float64 polish, planted in one pencil's correction
        z = np.zeros((1, 8))
        engine.polish_pocs_float64(z, z.copy(), np.zeros((1, 5), np.complex128), 1.0, 1.0, axes=(1,))
        return original(self, *args, **kw)

    monkeypatch.setattr(engine.CorrectionEngine, "correct", polished)
    result = _run(tiny_spec, cell)
    assert result["correct"] is False
    assert result["checks"]["host_stages"]["value"] > result["checks"]["host_stages"]["limit"] == 0
    # the correction itself is sound: only the host stage refuses the run
    assert all(c["value"] <= c["limit"] for k, c in result["checks"].items() if k != "host_stages")


def test_a_cache_value_altered_where_the_client_produces_it_is_refused(tiny_spec, monkeypatch):
    from repro_torch.serving import kv_compress

    original = kv_compress.compress_cache

    def altered(cache, comp, **kw):
        out = original(cache, comp, **kw)
        k = out["moe"]["k"].clone()
        k.view(-1)[0] = -k.view(-1)[0] + 1
        return {**out, "moe": {**out["moe"], "k": k}}

    monkeypatch.setattr(kv_compress, "compress_cache", altered)
    result = _run(tiny_spec, _first_cell("compress_cache"))
    assert result["correct"] is False and result["checks"]["misplaced"]["value"] > 0


def test_a_gradient_altered_where_the_client_produces_it_is_refused(tiny_spec, monkeypatch):
    from repro_torch.optim import grad_compress

    original = grad_compress.compress_gradients

    def altered(grads, **kw):
        out = original(grads, **kw)
        emb = out["embed"].clone()
        emb.view(-1)[5] += emb.abs().max()
        return {**out, "embed": emb}

    monkeypatch.setattr(grad_compress, "compress_gradients", altered)
    assert _run(tiny_spec, _first_cell("compress_gradients"))["correct"] is False


def test_the_jax_package_and_jax_are_found_by_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "perfbench", "torch"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_main_without_a_card_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this test checks the look for a card where there is none")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


# a configuration with inputs of a new kind, and a mix, each added as files
_KIND = """
import torch

from perfbench import generate


def make(config, traffic, seed, device):
    _, gen = generate.generators(seed, device)
    grads = {name: torch.randn(shape, generator=gen, device=device) for name, shape in config["leaves"].items()}
    return generate.Inputs([grads], [0], [sum(t.numel() for t in grads.values())])
"""


def test_a_cell_added_as_files_runs_through_the_harness(tmp_path):
    path = tiny.make(tmp_path)
    root = path.parent / "perfbench"
    (root / "inputs" / "flat_leaves.py").write_text(_KIND)
    config = {"inputs": "flat_leaves", "entry": "compress_gradients", "leaves": {"w": [12, 300], "b": [70]},
              "engine": {"backend": "batched", "fft_impl": "pallas"},
              "call": {"bits": 8, "E_rel": 0.01, "block": 256, "max_iters": 8}}
    (root / "configs" / "flat.json").write_text(json.dumps(config))
    (root / "traffic" / "flat-tight.json").write_text(json.dumps({"Delta_rel": 5e-5}))
    shutil.copy(root / "limits" / f"{_first_cell('compress_gradients')}.json", root / "limits" / "flat.tight.json")
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "flat", "file": "perfbench/configs/flat.json", "reduced": []})
    bench["workloads"].append({"name": "flat.tight", "config": "flat", "traffic": "flat-tight", "chips": 1})
    path.write_text(json.dumps(bench))
    s = spec.Spec(path, root=root)
    result = run.run_cell(s, "flat.tight", SEED, 0.2, True, device="cpu")
    assert result["correct"] is True and result["attempted"] > 0
    assert result["metrics"]["loop_passes"]["value"] > 1
    assert result["checks"]["host_stages"]["value"] == 0
