"""The port's step cost counter (``repro_torch.launch.hlo_cost``) held to the
contracts of the reference's HLO analyzer (``tests/test_hlo_cost.py``), and
to the reference's count of a compiled step.

The port counts ops as they are dispatched, so a loop's body is counted once
a trip by construction (the reference scales ``while`` bodies by their trip
counts; a data-dependent loop is flagged there and counted exactly here).

- products in a 10-trip loop and a nested 4 x 5 loop, an FFT of 4096
  complex values, a 7-trip data-dependent loop, a single-process product's
  empty collectives: the reference's bars;
- meta tensors counted as CPU tensors are;
- on 2 gloo ranks, an ``all_reduce`` and an ``all_gather_into_tensor`` of
  known sizes attributed by kind and by calling module;
- the launches of a hand-written kernel's wrapper reported by name;
- smoke qwen2-0.5b, ``train_4k``, on a (2, 2) ("data", "model") mesh: the
  port's per-rank flops (its ``make_step`` over a 4-rank fake process
  group, on meta tensors) against the reference's ``analyze_hlo`` of the
  same step compiled on 4 fake CPU devices (an ``AxisType.Auto`` mesh; in
  a subprocess each).  The two cost models part: the port recomputes every
  segment's forward in its backward (four forwards' products against the
  three of a step without rematerialization), and counts each eager op
  where XLA fuses, eliminates common subexpressions and decides its own
  remat.  The bar: the port's flops within [0.9, 1.1] x 4/3 of the
  reference's.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro_torch.launch.hlo_cost import Cost, count_cost

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_smoke_config
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.steps import make_step

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
step, args, in_sh, out_sh = make_step(get_smoke_config("qwen2-0.5b"), "train_4k", mesh)
with mesh:
    compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
c = analyze_hlo(compiled.as_text())
print("RESULTS:" + json.dumps({"flops": c.flops, "unknown_trips": c.unknown_trips}))
"""

_PORT = r"""
import json
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import count_step, fake_group
from repro_torch.launch.mesh import make_mesh

fake_group(4)
cost, memory = count_step(get_smoke_config("qwen2-0.5b"), "train_4k", make_mesh((2, 2), ("data", "model")))
print("RESULTS:" + json.dumps({"flops": cost.flops, "unknown_trips": cost.unknown_trips, "kernels": cost.kernels}))
"""


def _loop(x, w):
    for _ in range(10):
        x = x @ w
    return x


class TestCountContracts:
    def test_loop_trips_counted(self):
        cost = count_cost(_loop, torch.zeros(128, 128), torch.zeros(128, 128))
        expect = 10 * 2 * 128**3
        assert 0.95 * expect < cost.flops < 1.1 * expect, cost.flops

    def test_nested_loops(self):
        def f(x, w):
            for _ in range(4):
                d = x
                for _ in range(5):
                    d = d @ w
                x = d
            return x

        cost = count_cost(f, torch.zeros(64, 64), torch.zeros(64, 64))
        expect = 20 * 2 * 64**3
        assert 0.9 * expect < cost.flops < 1.2 * expect

    def test_fft_flops_counted(self):
        cost = count_cost(torch.fft.fft, torch.zeros(4096, dtype=torch.complex64))
        expect = 5 * 4096 * np.log2(4096)
        assert 0.9 * expect < cost.flops < 1.5 * expect

    def test_data_dependent_loop_counted_each_trip(self):
        def f(n):
            i, v = torch.tensor(0), torch.tensor(1.0)
            while bool(i < n):
                i, v = i + 1, v * 1.5
            return v

        cost = count_cost(f, torch.tensor(7))
        # each trip: the compare, the add and the multiply; one last compare
        assert cost.flops == 7 * 3 + 1, cost.flops
        assert cost.unknown_trips == 0

    def test_single_process_has_no_collectives(self):
        cost = count_cost(lambda a, b: a @ b, torch.zeros(32, 32), torch.zeros(32, 32))
        assert cost.collectives == {} and cost.coll_by_name == {}
        assert cost.flops == 2 * 32**3
        assert cost.bytes == 3 * 32 * 32 * 4

    @pytest.mark.parametrize("fn,shapes", [
        (_loop, [(128, 128), (128, 128)]),
        (lambda x: torch.fft.rfft(torch.tanh(x) * 2.0 + 1.0), [(8, 4096)]),
        (lambda x, w: torch.nn.functional.silu(torch.nn.functional.linear(x, w)).sum(), [(4, 16, 32), (24, 32)]),
    ], ids=["loop", "fft", "linear_silu"])
    def test_meta_counted_as_cpu(self, fn, shapes):
        cpu = count_cost(fn, *[torch.zeros(s) for s in shapes])
        meta = count_cost(fn, *[torch.zeros(s, device="meta") for s in shapes])
        assert cpu.flops == meta.flops > 0
        assert cpu.bytes == meta.bytes > 0
        assert cpu.peak_temp_bytes == meta.peak_temp_bytes > 0

    def test_temporaries_exclude_arguments(self):
        # two live (64, 64) float32 products at most: x @ w is dropped as the
        # next one is made
        cost = count_cost(_loop, torch.zeros(64, 64), torch.zeros(64, 64))
        assert cost.peak_temp_bytes == 2 * 64 * 64 * 4

    def test_kernel_launches_reported(self, monkeypatch):
        from repro_torch.kernels.scube import ops as scube_ops

        def fake_kernel(x):
            scube_ops.launches["scube"] += 1
            return x

        cost = count_cost(lambda x: fake_kernel(fake_kernel(x)), torch.zeros(4))
        assert cost.kernels == {"scube": 2}

    def test_cost_sums_and_scales(self):
        a = Cost(1.0, 2.0, {"all-reduce": 4.0}, 0, {("all-reduce", "m"): 4.0}, {"k": 1}, 10)
        b = Cost(3.0, 1.0, {"all-reduce": 1.0, "all-gather": 2.0}, 1, {("all-gather", "m"): 2.0}, {"k": 2}, 5)
        a += b
        assert (a.flops, a.bytes, a.unknown_trips, a.peak_temp_bytes) == (4.0, 3.0, 1, 10)
        assert a.collectives == {"all-reduce": 5.0, "all-gather": 2.0} and a.kernels == {"k": 3}
        s = a.scaled(2)
        assert s.flops == 8.0 and s.collectives["all-reduce"] == 10.0
        assert s.coll_by_name == {("all-reduce", "m"): 8.0, ("all-gather", "m"): 4.0}


def test_collectives_by_kind_on_gloo_ranks(tmp_path):
    got = ranks.run_worlds("cost", [2], tmp_path, timeout=120.0)[2]
    assert isinstance(got, list), got
    for r in got:
        assert r["collectives"] == {"all-reduce": 8 * 4 * 4.0, "all-gather": 2 * 3 * 5 * 4.0}
        assert r["coll_by_name"] == {("all-reduce", "_torch_ranks"): 128.0, ("all-gather", "_torch_ranks"): 120.0}
        assert r["flops"] == 2 * 8 * 8 * 4


def test_step_flops_against_the_reference_compile():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env)
             for name, script in (("reference", _REFERENCE), ("port", _PORT))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        line = [l for l in stdout.splitlines() if l.startswith("RESULTS:")][0]
        out[name] = json.loads(line[len("RESULTS:"):])
    ratio = out["port"]["flops"] / out["reference"]["flops"]
    assert out["reference"]["unknown_trips"] == 0 and out["port"]["unknown_trips"] == 0
    assert out["port"]["kernels"] == {}  # meta: no kernel launches
    assert 0.9 * 4 / 3 <= ratio <= 1.1 * 4 / 3, (out, ratio)
    assert math.isfinite(ratio)
