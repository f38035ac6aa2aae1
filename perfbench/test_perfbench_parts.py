"""CPU tests of the benchmark's parts: the generator, the work counts, the
harness's lookup of files by name, and what its modules import."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from perfbench import counts, generate, spec, tiny

HERE = Path(__file__).resolve().parent
BENCH = spec.Spec(HERE.parent / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH.data["workloads"]]


@pytest.fixture(scope="module")
def tiny_spec(tmp_path_factory):
    path = tiny.make(tmp_path_factory.mktemp("tiny"))
    return spec.Spec(path, root=path.parent / "perfbench")


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _inputs(s, cell, seed):
    c = s.cell(cell)
    config = s.config(c)
    inputs = s.inputs(config).make(config, s.traffic(c), seed, "cpu")
    return inputs, [t for item in inputs.items for t in _flat(item)]


@pytest.mark.parametrize("cell", CELLS)
def test_generator_repeats_for_a_seed_and_differs_across_seeds(tiny_spec, cell):
    big = 2**31 + 12345
    a, ta = _inputs(tiny_spec, cell, big)
    b, tb = _inputs(tiny_spec, cell, big)
    c, tc = _inputs(tiny_spec, cell, 7)
    assert a.order == b.order and a.sizes == b.sizes
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert not all(torch.equal(x, y) for x, y in zip(ta, tc))
    # the seed changes the values and the order, never the amount of work
    assert sorted(a.sizes) == sorted(c.sizes)
    assert sorted(x.numel() for x in ta) == sorted(x.numel() for x in tc)


def test_kv_requests_are_laid_out_as_the_port_serving_cache():
    from repro_torch.models.model import build_model

    config = tiny.config(json.loads((HERE / "configs" / "kv-granite-moe-3b.json").read_text()))
    traffic = tiny.traffic(json.loads((HERE / "traffic" / "kv-tight.json").read_text()))
    inputs = BENCH.inputs(config).make(config, traffic, 3, "cpu")
    for cache, n in zip(inputs.items, inputs.sizes):
        want = build_model(generate.arch_config(config), device="meta").init_cache(config["batch"], n)
        assert cache.keys() == want.keys() and cache["pos"] == n
        for name in ("k", "v"):
            assert cache["moe"][name].shape == want["moe"][name].shape
            assert cache["moe"][name].dtype == want["moe"][name].dtype


def test_gradients_are_laid_out_as_the_trainer_hands_them():
    from repro_torch import tree
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.models.model import lm_class

    config = tiny.config(json.loads((HERE / "configs" / "grad-mamba2-2.7b.json").read_text()))
    cfg = generate.arch_config(config)
    grads = BENCH.inputs(config).make(config, {}, 3, "cpu").items[0]
    named = {k: v for k, v in lm_class(cfg)(cfg, device="meta").named_parameters() if not k.startswith("ln_f")}
    want, want_def = tree.flatten(lm_params_to_reference(named, cfg))
    got, got_def = tree.flatten(grads)
    assert got_def == want_def
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]


def test_tiny_sizes_come_from_the_files_and_the_smoke_configs():
    bare = {"inputs": "anything", "entry": "anything", "call": {"block": 4096}}
    assert tiny.config(bare) == bare
    for c in BENCH.data["configs"]:
        full = json.loads((HERE.parent / c["file"]).read_text())
        small = tiny.config(full)
        assert small["n_layers"] == 2 and small["d_model"] == 64 and small["dtype"] == full["dtype"]
        assert small["call"]["block"] < full["call"]["block"]
    full = json.loads((HERE / "traffic" / "kv-tight.json").read_text())
    assert tiny.traffic(full)["requests"] == 3 and tiny.traffic(full)["Delta_rel"] == full["Delta_rel"]


def test_context_lengths_are_strata_of_the_log_uniform_law():
    lengths = generate.context_lengths({"requests": 4, "context_tokens": {"lo": 1000, "hi": 16000}})
    # middles of four equal strata in log space: 1000 * 16^((i + 0.5) / 4)
    assert lengths == [1414, 2828, 5657, 11314]


def test_counts_for_one_pencil_batch_by_hand():
    # a real FFT of 1024 is 2.5 n log2 n = 25600; the f-clip and its check
    # 12 * 513 + 20 * 512 = 16396; the s-clip 3 * 1024
    per_pass = 2 * 25600 + 16396 + 3072
    per_check = 25600 + 16396
    assert counts.pencil_pass_flops(1024) == per_pass == 70668
    assert counts.pencil_check_flops(1024) == per_check == 41996
    # 8 pencils of 1024, 3 iterations each, all converged: two full passes
    # and a last check each
    n_bytes, flops = counts.correction_work([(1024, 8, 24, 8)])
    assert n_bytes == 8 * 1024 * 8 == 65536
    assert flops == 8 * (2 * 70668 + 41996) == 1466656
    # 5 of them converged, 3 ran to max_iters = 3 stepping every iteration
    _, flops = counts.correction_work([(1024, 8, 24, 5)])
    assert flops == 5 * (2 * 70668 + 41996) + 3 * 3 * 70668
    # one check, no pass (every pencil inside the f-cube at once)
    _, flops = counts.correction_work([(1024, 8, 8, 8)])
    assert flops == 8 * 41996
    t, by = counts.least_seconds(n_bytes, 1466656)
    assert by == "operations" and t == pytest.approx(1466656 / 67e12)
    t, by = counts.least_seconds(3.35e12, 0.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    assert counts.rfft_flops(4096) == 2.5 * 4096 * 12 and math.isclose(counts.rfft_flops(1), 0.0)


def test_harness_finds_a_config_mix_entry_and_metric_added_as_files(tmp_path):
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "inputs", "entries", "metrics", "limits"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "new-model.json").write_text(
        json.dumps({"arch": "qwen2-0.5b", "entry": "new_entry", "inputs": "new_kind"}))
    (root / "inputs" / "new_kind.py").write_text("def make(config, traffic, seed, device):\n    return seed\n")
    (root / "traffic" / "new-mix.json").write_text(json.dumps({"Delta_rel": 0.5}))
    (root / "entries" / "new_entry.py").write_text("class Entry:\n    NAME = 'new'\n")
    (root / "metrics" / "new_metric.py").write_text("def read(run):\n    return 42.0\n")
    (root / "limits" / "new-model.mix.json").write_text(json.dumps({"gap_over_E": 1.0}))
    bench = {
        "configs": [{"name": "new-model", "file": "bench/configs/new-model.json"}],
        "workloads": [{"name": "new-model.mix", "config": "new-model", "traffic": "new-mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "moves": None}, {"name": "other", "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "new_metric", "moves": "setup_s"},
                      {"name": "listed", "moves": "other", "workloads": ["new-model.mix"]},
                      {"name": "unlisted", "moves": "other"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    s = spec.Spec(tmp_path / "BENCHMARK.json", root=root)
    cell = s.cell("new-model.mix")
    config = s.config(cell)
    assert config["arch"] == "qwen2-0.5b"
    assert s.traffic(cell) == {"Delta_rel": 0.5}
    assert s.limits(cell) == {"gap_over_E": 1.0}
    assert s.entry(config).Entry.NAME == "new"
    assert s.inputs(config).make(config, {}, 7, "cpu") == 7
    assert s.metric("new_metric").read(None) == 42.0
    assert [m["name"] for m in s.metrics(cell, trace=False)] == ["setup_s"]
    assert [m["name"] for m in s.metrics(cell, trace=True)] == ["new_metric", "listed"]


def test_every_cell_has_its_parts():
    s = spec.Spec(HERE.parent / "BENCHMARK.json")
    for cell in s.data["workloads"]:
        config = s.config(cell)
        assert s.traffic(cell) and s.limits(cell)
        assert hasattr(s.entry(config), "Entry") and callable(s.inputs(config).make)
        for trace in (False, True):
            for m in s.metrics(cell, trace):
                assert callable(s.metric(m["name"]).read)


def _imports(path: Path):
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        # whole top-level names: repro_torch is not repro
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert not _imports(f) & {"repro_torch", "repro", "jax", "perfbench"}, f
