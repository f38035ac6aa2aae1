"""The port's multi-pod dry run (``python -m repro_torch.launch.dryrun``).

One subprocess (the dry run makes the default process group a 256-rank fake
one) runs ``run_cell`` on qwen2-0.5b's ``train_4k`` and ``decode_32k`` cells
over the 16x16 (data, model) mesh at full width and depth, computes the
rules' share of rank 0 beside them, and drives ``main`` as the CLI does:
a cell, the same cell again under ``--resume``, and a cell whose count
raises.

- each record carries the reference's keys (``count_s`` for ``lower_s`` and
  ``compile_s``), finite positive flops, bytes and collective bytes, no
  unknown trips and no kernel launches (meta tensors);
- ``argument_size_bytes`` is the rules' share (``MeshLayout.share_bytes``,
  with AdamW's moments for a train step) plus the rank's rows of the batch
  and its cache;
- ``--resume`` skips a cell already recorded as ok;
- a cell that raises is recorded ``ok: False`` with its error, and the exit
  status is 1.
"""

import json
import math
import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import contextlib, io, json, os, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import tree_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step

out = {"cells": {}, "want_args": {}}
for shape in ("train_4k", "decode_32k"):
    out["cells"][shape] = dryrun.run_cell("qwen2-0.5b", shape, False)
    cfg = get_config("qwen2-0.5b")
    seq, rows, kind = SHAPES[shape]
    step, args, _i, _o = make_step(cfg, shape, make_production_mesh(), device="meta")
    L = step.layout
    split = L.batch_split(rows)
    if kind == "train":
        want = L.share_bytes(moments=True) + tree_bytes(args[2]) // split.size
    else:
        want = L.share_bytes(moments=False) + tree_bytes(args[1]) // split.size + tree_bytes(step.init_cache(rows, seq))
    out["want_args"][shape] = want
    out["split"] = split.size

d = sys.argv[1]
cli = ["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "single", "--out", os.path.join(d, "a.json")]
for label, argv in (("first", cli), ("resume", cli + ["--resume"])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(argv)
    out[label] = {"rc": rc, "stdout": buf.getvalue(), "records": json.load(open(os.path.join(d, "a.json")))}

def boom(*a, **k):
    raise RuntimeError("boom")

dryrun.count_step = boom
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k", "--mesh", "single",
                      "--out", os.path.join(d, "b.json")])
out["failing"] = {"rc": rc, "stdout": buf.getvalue(), "records": json.load(open(os.path.join(d, "b.json")))}
print("RESULTS:" + json.dumps(out))
"""

KEYS = {"arch", "shape", "mesh", "ok", "count_s", "flops", "bytes_accessed", "collective_bytes",
        "unknown_trip_whiles", "kernels", "memory"}
MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes", "temp_size_is_estimate"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(d)], capture_output=True, text=True, env=env,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULTS:")][0]
    return json.loads(line[len("RESULTS:"):])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_cell_record(run, shape):
    r = run["cells"][shape]
    assert set(r) == KEYS and set(r["memory"]) == MEMORY_KEYS
    assert (r["arch"], r["shape"], r["mesh"], r["ok"]) == ("qwen2-0.5b", shape, "16x16", True)
    assert math.isfinite(r["flops"]) and r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["unknown_trip_whiles"] == 0 and r["kernels"] == {}
    assert set(r["collective_bytes"]) >= {"all-gather"} and all(v > 0 for v in r["collective_bytes"].values())
    assert r["memory"]["output_size_bytes"] > 0 and r["memory"]["temp_size_bytes"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_arguments_are_the_rules_share(run, shape):
    assert run["cells"][shape]["memory"]["argument_size_bytes"] == run["want_args"][shape]
    assert run["split"] == 16  # the batch's rows over "data"


def test_train_step_outnumbers_decode(run):
    # 256 x 4096 tokens through forward and backward against one token of 128 rows
    assert run["cells"]["train_4k"]["flops"] > 1000 * run["cells"]["decode_32k"]["flops"]


def test_resume_skips_done_cells(run):
    first, again = run["first"], run["resume"]
    assert first["rc"] == 0 and again["rc"] == 0
    assert len(first["records"]) == 1 and first["records"][0]["ok"]
    assert again["records"] == first["records"]
    assert "whisper-tiny x decode_32k x 16x16 ..." in first["stdout"]
    assert "whisper-tiny x decode_32k x 16x16 ..." not in again["stdout"]


def test_failing_cell_recorded(run):
    f = run["failing"]
    assert f["rc"] == 1
    assert f["records"] == [{"arch": "whisper-tiny", "shape": "train_4k", "mesh": "16x16", "ok": False,
                             "error": "RuntimeError: boom"}]
    assert "1 failed" in f["stdout"]
