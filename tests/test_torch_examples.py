"""The port's twins of the reference's examples, run as a user runs them
(``--device cpu``, the smoke configs), their printed lines checked.

- ``examples/serve_batched_torch.py``: one ``served N requests`` line for
  KV compression off and on, each with the requested count and every
  shown request's tokens ``--max-new-tokens`` long and inside the vocab;
  with ``--attention-impl pallas --fft-impl pallas`` (the kernels' plain
  twins on the CPU) the same lines.
- ``examples/compress_checkpoint_torch.py``: the raw line stores the raw
  bytes with a restore error of 0, the FFCz line a smaller store, and every
  compressed leaf restored within the E its header stores.
- Without ``--device cpu`` and without a card, both raise.
- ``examples/pipeline_torch.py`` at 2 gloo ranks ends within its bar.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
RUNS = {
    "serve": ["examples/serve_batched_torch.py", "--device", "cpu", "--requests", "5", "--max-new-tokens", "6"],
    "serve_pallas": ["examples/serve_batched_torch.py", "--device", "cpu", "--requests", "5", "--max-new-tokens", "6",
                     "--attention-impl", "pallas", "--fft-impl", "pallas"],
    "checkpoint": ["examples/compress_checkpoint_torch.py", "--device", "cpu"],
}


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    procs = {k: subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, argv in RUNS.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (k, stderr[-3000:])
        out[k] = stdout
    return out


@pytest.mark.parametrize("run", ["serve", "serve_pallas"])
def test_serve_batched_lines(outputs, run):
    text = outputs[run]
    served = re.findall(r"^kv_compression=(True|False): served (\d+) requests, ([0-9.]+) tok/s$", text, re.M)
    assert [(kv, int(n)) for kv, n, _ in served] == [("False", 5), ("True", 5)]
    assert all(float(r) > 0 for _, _, r in served)
    shown = re.findall(r"^  uid=(\d+): \[([0-9, ]+)\]$", text, re.M)
    assert len(shown) == 6  # three requests each time
    for _, toks in shown:
        toks = [int(t) for t in toks.split(",")]
        assert len(toks) == 6 and all(0 <= t < 256 for t in toks)
    assert text.rstrip().splitlines()[-1].endswith("kernel launches: {}")  # the CPU runs the twins


def test_serve_batched_same_stream_either_impl(outputs):
    # the same requests and weights: the uncompressed run's tokens agree
    # between the attention paths wherever the smoke model's logits do not tie
    a = re.findall(r"uid=\d+: .*", outputs["serve"].split("kv_compression=True")[0])
    b = re.findall(r"uid=\d+: .*", outputs["serve_pallas"].split("kv_compression=True")[0])
    assert a == b


def test_compress_checkpoint_lines(outputs):
    text = outputs["checkpoint"]
    rows = re.findall(r"^(\S+)\s*: +([0-9.]+) MB \(raw ([0-9.]+) MB, ([0-9.]+)x\), max restore err (\S+)$", text, re.M)
    assert [r[0] for r in rows] == ["raw", "ffcz(E_rel=1e-4)"]
    raw, ffcz = rows
    assert float(raw[4]) == 0.0
    assert float(ffcz[1]) < float(raw[1]) and float(ffcz[3]) > 1.0
    assert 0.0 < float(ffcz[4])
    m = re.search(r"compressed leaves: (\d+), every restore error within its stored E: (True|False)", text)
    assert m and int(m.group(1)) > 0 and m.group(2) == "True"


@pytest.mark.skipif(torch.cuda.is_available(), reason="the examples run on the card when there is one")
@pytest.mark.parametrize("script", ["examples/serve_batched_torch.py", "examples/compress_checkpoint_torch.py"])
def test_no_card_no_fallback(script):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    p = subprocess.run([sys.executable, script], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "torch.cuda.is_available() is False" in p.stderr


def test_pipeline_example_on_gloo_ranks(tmp_path):
    """``examples/pipeline_torch.py`` under ``torch.distributed.run`` at 2
    gloo ranks (smoke qwen2-0.5b: one layer a stage, 4 microbatches of 1 x
    64): bitwise the one-rank forward run microbatch by microbatch, within
    the bar of the batched one, GPipe's bubble fraction."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = tmp_path / "pipe.json"
    p = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                        "examples/pipeline_torch.py", "--device", "cpu", "--preset", "smoke", "--seq-len", "64",
                        "--reps", "1", "--out", str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(out.read_text())
    assert line["world_size"] == 2 and line["stages"] == [[0, 1], [1, 2]]
    assert line["bubble_fraction"] == pytest.approx(1 / 5)
    assert line["bitwise_per_microbatch"] and line["within_bar"]
    assert line["flash_launches_per_rank"] == [0, 0]  # the CPU runs the twin
    assert all(0.0 <= b < 1.0 for b in line["measured_bubble"])
    assert 0.0 < line["schedule_seconds"] < line["synchronized_pipelined_seconds"]
