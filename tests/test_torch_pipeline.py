"""GPipe over a mesh's "pipe" axis (``repro_torch.sharding.pipeline``) on
gloo ranks, against the sequential stack and the reference's
``pipeline_apply``.

The stack is the reference test's (``tests/test_pipeline.py``): 4 stages of
2 tanh layers, 6 microbatches of 3 rows, width 16, numpy seed 0.  One
module-scoped fixture spawns ``_torch_ranks.body_pipeline`` at world sizes 1
(mesh (1, 1) over ("pipe", "data"): S = 1) and 4 (meshes (4, 1) and (2, 2):
the same 8 layers as 4 stages of 2 and 2 stages of 4), and meanwhile runs
the reference's ``pipeline_apply`` in a subprocess on 8 fake CPU devices at
(4, 2) and on 4 of them at (2, 2).  The reference builds its meshes with
``AxisType.Auto`` axes: ``jax.make_mesh``'s default (``Explicit`` in some
JAX versions) makes its ``shard_map`` refuse the replicated input.

- outputs within 1e-5 of the sequential stack (the reference test's bar),
  and of the reference's ``pipeline_apply`` at the same mesh;
- stage parameters with a leading axis of 1 (each rank its own stage) give
  the same outputs as the whole stack;
- the gradient of a loss every rank computes alike on its copy of the
  outputs (the reference's one loss of its global result), with respect to
  the stage parameters and the microbatches (each pipe rank's own stage's
  part, summed), within rtol 1e-5 of autograd through the sequential stack:
  the loss counts once, not once a rank;
- a stream one stage holds shorter than the others' is refused by every
  stage (none waits on a send that never comes).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro_torch.sharding.pipeline import bubble_fraction

S, LPS, M, MB, D = 4, 2, 6, 3, 16
MESHES = [(world, shape) for world, shapes in ranks.PIPE_MESHES.items() for shape in shapes]

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro.sharding.pipeline import pipeline_apply

data = np.load(sys.argv[1])
Ws, bs, x = (jnp.asarray(data[k]) for k in ("Ws", "bs", "x"))

def stage_fn(params, h):
    W, b = params
    def layer(h, wb):
        w, bb = wb
        return jnp.tanh(h @ w + bb), None
    h, _ = jax.lax.scan(layer, h, (W, b))
    return h

out = {}
for p, d in ((4, 2), (2, 2)):
    mesh = Mesh(np.array(jax.devices()[: p * d]).reshape(p, d), ("pipe", "data"), axis_types=(AxisType.Auto,) * 2)
    per = Ws.shape[0] * Ws.shape[1] // p
    params = (Ws.reshape((p, per) + Ws.shape[2:]), bs.reshape((p, per) + bs.shape[2:]))
    with mesh:
        out[f"{p}x{d}"] = np.asarray(pipeline_apply(stage_fn, params, x, mesh, axis="pipe"))
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((S, LPS, D, D)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((S, LPS, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    w_loss = rng.standard_normal((M, MB, D)).astype(np.float32)
    return {"Ws": Ws, "bs": bs, "x": x, "w_loss": w_loss}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("pipeline")
    inputs = _inputs()
    wait = ranks.start_worlds("pipeline", sorted(ranks.PIPE_MESHES), base, timeout=120.0, inputs=inputs)
    np.savez(base / "inputs.npz", **{k: inputs[k] for k in ("Ws", "bs", "x")})
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(base / "inputs.npz"), str(base / "ref.npz")],
                          capture_output=True, text=True, env=env, timeout=600)
    results = wait()
    ref = dict(np.load(base / "ref.npz")) if proc.returncode == 0 else proc.stderr[-3000:]
    return inputs, results, ref


def _sequential(inputs, requires_grad=False):
    Ws, bs, x = (torch.from_numpy(inputs[k]).requires_grad_(requires_grad) for k in ("Ws", "bs", "x"))
    h = x
    for s in range(S):
        h = ranks.pipe_stage_fn((Ws[s], bs[s]), h)
    return h, (Ws, bs, x)


def _ranks(results, world, shape):
    got = results[world]
    assert isinstance(got, list), got
    return [r[shape] for r in got]


class TestPipeline:
    def test_bubble_fraction(self):
        assert bubble_fraction(4, 6) == pytest.approx(3 / 9)
        assert bubble_fraction(1, 8) == 0.0

    @pytest.mark.parametrize("world,shape", MESHES, ids=[f"{s[0]}x{s[1]}" for _w, s in MESHES])
    def test_matches_sequential(self, runs, world, shape):
        inputs, results, _ref = runs
        with torch.no_grad():
            want = _sequential(inputs)[0].numpy()
        for r in _ranks(results, world, shape):
            assert r["y"].shape == (M, MB, D)
            err = float(np.abs(r["y"] - want).max())
            assert err < 1e-5, (shape, r["pipe"], err)
            np.testing.assert_array_equal(r["own"], r["y"])

    @pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
    def test_matches_reference_pipeline(self, runs, shape):
        inputs, results, ref = runs
        assert isinstance(ref, dict), ref
        want = ref[f"{shape[0]}x2"] if shape == (4, 1) else ref["2x2"]
        for r in _ranks(results, 4, shape):
            err = float(np.abs(r["y"] - want).max())
            assert err < 1e-5, (shape, r["pipe"], err)

    @pytest.mark.parametrize("world,shape", MESHES, ids=[f"{s[0]}x{s[1]}" for _w, s in MESHES])
    def test_gradients_match_sequential(self, runs, world, shape):
        inputs, results, _ref = runs
        h, (Ws, bs, x) = _sequential(inputs, requires_grad=True)
        loss = (h * torch.from_numpy(inputs["w_loss"])).sum()
        loss.backward()
        got = [r for r in _ranks(results, world, shape) if r["data"] == 0]
        assert sorted(r["pipe"] for r in got) == list(range(shape[0]))
        want_loss = float(loss.detach())
        for r in got:  # every rank's replicated loss is the one loss
            assert r["loss"] == pytest.approx(want_loss, rel=1e-5)
        p = shape[0]
        per = S * LPS // p
        gW = sum(r["gW"] for r in got).reshape(Ws.shape)
        gb = sum(r["gb"] for r in got).reshape(bs.shape)
        gx = sum(r["gx"] for r in got)
        for name, g, want in (("W", gW, Ws.grad), ("b", gb, bs.grad), ("x", gx, x.grad)):
            want = want.numpy()
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()), err_msg=name)
        # each rank's parameter gradient lies in its own stage's slice
        for r in got:
            others = np.delete(r["gW"].reshape((p, per, D, D)), r["pipe"], axis=0)
            assert not others.any()
        # the data replicas at (2, 2) agree
        if shape[1] > 1:
            by = {}
            for r in _ranks(results, world, shape):
                by.setdefault(r["pipe"], []).append(r)
            for pair in by.values():
                np.testing.assert_array_equal(pair[0]["gW"], pair[1]["gW"])
                np.testing.assert_array_equal(pair[0]["y"], pair[1]["y"])

    @pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
    def test_every_stage_refuses_a_stream_that_differs(self, runs, shape):
        _inputs, results, _ref = runs
        for r in _ranks(results, 4, shape):
            assert r["refused"] is not None and "microbatches differ" in r["refused"], (r["pipe"], r["refused"])

    def test_one_stage_is_the_stack(self, runs):
        inputs, results, _ref = runs
        (r,) = _ranks(results, 1, (1, 1))
        Ws, bs, x = (torch.from_numpy(inputs[k]) for k in ("Ws", "bs", "x"))
        want = []
        with torch.no_grad():
            for h in x:  # the schedule's order: one microbatch through every stage
                for s in range(S):
                    h = ranks.pipe_stage_fn((Ws[s], bs[s]), h)
                want.append(h)
        np.testing.assert_array_equal(r["y"], torch.stack(want).numpy())
