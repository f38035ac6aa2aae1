"""Sharded FFCz on gloo ranks: the codec, the engine's sharded backend, the
sharded power spectrum, ``compressed_psum`` and elastic re-planning.

One module-scoped fixture spawns the ranks of ``_torch_ranks.body_sharded``
once per world size (1, 2, 4); the tests read what the ranks wrote.

- Codec: ``FFCz.compress(ShardedField)`` gives the same blob on every rank
  and byte-identical payloads at 1, 2 and 4 ranks for every shape and bound
  kind (``Delta_abs``, ``Delta_rel``, ``pspec_rel``, ``E_roi``, the packed
  loop, a check cadence); whole blobs differ only by the ``FFCP`` section of
  an uneven decomposition.  Both stored bounds hold, rechecked in float64,
  under the port's decoder and the reference's.  Against the port's and the
  reference's single-device blobs the bar is bound-class (ROADMAP "How held
  against"): the same host-resolved E (and Delta_abs), Delta_rel within
  rtol 1e-6, every blob within its own bounds.
- Sharded backend: bitwise per pencil, in its edits and in its per-block
  stats against the batched backend on the same inputs (9 and 10 blocks,
  neither a multiple of 4; cold and warm started; sync and async), for the
  three transform selectors.
- ``power_spectrum_sharded``: against ``power_spectrum`` of the gathered
  field (port and reference) at the reference's bar for its own sharded
  spectrum: shells 1.. within rtol 1e-4, the DC shell within 1e-6 of the
  largest (float32 shell sums re-associate across shardings).
- ``compressed_psum``: bitwise the sum over ranks of the reference's
  per-rank quantize codes (``_quantize_dequantize``), dequantized.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro_torch.compressors import get_compressor
from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig
from repro_torch.sharding import dist_fft

WORLDS = (1, 2, 4)
CODEC_CASES = [(shape, name) for shape in ranks.CODEC_SHAPES for name in ranks.codec_configs(shape)]
BACKEND_CASES = [(impl, block) for impl in ("xla", "packed", "pallas") for block in (512, 511)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return ranks.run_worlds("sharded", WORLDS, tmp_path_factory.mktemp("sharded"))


def _ranks(results, world):
    got = results[world]
    if isinstance(got, str):
        pytest.fail(f"world size {world}: {got}")
    return got


def _recheck(x, dec, blob):
    """Float64 margins of ``dec`` against the bounds ``blob`` stores."""
    eps = dec.astype(np.float64) - x.astype(np.float64)
    if blob.roi_bound is not None:
        E = np.frombuffer(blob.roi_bound, np.float32).reshape(blob.shape).astype(np.float64)
    else:
        E = blob.E
    d = np.fft.rfftn(eps)
    if blob.pointwise_delta is not None:
        half = tuple(blob.shape[:-1]) + (blob.shape[-1] // 2 + 1,)
        D = np.frombuffer(blob.pointwise_delta, np.float32).reshape(half).astype(np.float64)
    else:
        D = blob.Delta_scalar
    return float(np.min(E - np.abs(eps))), float(np.min(D - np.maximum(np.abs(d.real), np.abs(d.imag))))


def _ids(cases):
    return [f"{s}-{n}" for s, n in cases]


@pytest.mark.parametrize("shape,name", CODEC_CASES, ids=_ids(CODEC_CASES))
def test_blobs_are_byte_identical_across_world_sizes(sharded, shape, name):
    (one,) = _ranks(sharded, 1)
    want = one["codec"][(shape, name)]
    assert want["converged"]
    for world in (2, 4):
        got = [r["codec"][(shape, name)] for r in _ranks(sharded, world)]
        assert all(g["bytes"] == got[0]["bytes"] for g in got), "ranks returned different blobs"
        assert got[0]["payload"] == want["payload"]
        padded = dist_fft.padded_spatial_shape(shape, world) != shape
        blob = FFCzBlob.from_bytes(got[0]["bytes"])
        if padded:
            assert blob.pad_meta is not None and blob.pad_meta.n_dev == world
            assert blob.pad_meta.padded_shape == dist_fft.padded_spatial_shape(shape, world)
        else:
            assert blob.pad_meta is None and got[0]["bytes"] == want["bytes"]
        assert got[0]["iterations"] == want["iterations"]


@pytest.mark.parametrize("shape,name", CODEC_CASES, ids=_ids(CODEC_CASES))
def test_stored_bounds_hold_under_both_decoders(sharded, shape, name):
    from repro.compressors import get_compressor as ref_compressor
    from repro.core.ffcz import FFCz as RefFFCz
    from repro.core.ffcz import FFCzBlob as RefBlob

    x = ranks.codec_field(shape)
    data = _ranks(sharded, 4)[0]["codec"][(shape, name)]["bytes"]
    blob = FFCzBlob.from_bytes(data)
    dec = FFCz(get_compressor("szlike"), device="cpu").decompress(blob)
    spatial, frequency = _recheck(x, dec, blob)
    assert spatial >= 0 and frequency >= 0
    ref_blob = RefBlob.from_bytes(data)
    ref_dec = RefFFCz(ref_compressor("szlike")).decompress(ref_blob)
    assert min(_recheck(x, ref_dec, blob)) >= 0
    if blob.pad_meta is not None:
        assert (ref_blob.pad_meta.n_dev, ref_blob.pad_meta.padded_shape) == \
            (blob.pad_meta.n_dev, blob.pad_meta.padded_shape)


@pytest.mark.parametrize("shape,name", CODEC_CASES, ids=_ids(CODEC_CASES))
def test_decompress_sharded_is_decompress_scattered(sharded, shape, name):
    for world in WORLDS:
        assert all(r["codec"][(shape, name)]["sharded_decode_bitwise"] for r in _ranks(sharded, world))


SINGLE_CASES = [(s, n) for s in ((16, 8, 12), (9, 8, 10), (12, 18)) for n in ("Delta_abs", "Delta_rel")]


@pytest.mark.parametrize("shape,name", SINGLE_CASES, ids=_ids(SINGLE_CASES))
def test_sharded_blob_is_bound_class_against_single_device_blobs(sharded, shape, name):
    from repro.compressors import get_compressor as ref_compressor
    from repro.core.ffcz import FFCz as RefFFCz
    from repro.core.ffcz import FFCzConfig as RefConfig

    x = ranks.codec_field(shape)
    kw = ranks.codec_configs(shape)[name]
    blob = FFCzBlob.from_bytes(_ranks(sharded, 2)[0]["codec"][(shape, name)]["bytes"])
    port_blob = FFCz(get_compressor("szlike"), FFCzConfig(**kw), device="cpu").compress(x)
    ref_blob = RefFFCz(ref_compressor("szlike"), RefConfig(**kw)).compress(x)
    for other in (port_blob, ref_blob):
        assert other.E == blob.E  # host-resolved in float32: the same value
        if name == "Delta_abs":
            assert other.Delta_scalar == blob.Delta_scalar
        else:
            assert abs(other.Delta_scalar - blob.Delta_scalar) <= 1e-6 * blob.Delta_scalar
    codec = FFCz(get_compressor("szlike"), device="cpu")
    for b in (blob, port_blob):
        assert min(_recheck(x, codec.decompress(b), b)) >= 0
    assert min(_recheck(x, np.asarray(RefFFCz(ref_compressor("szlike")).decompress(ref_blob)), ref_blob)) >= 0


@pytest.mark.parametrize("shape", ranks.CODEC_SHAPES, ids=str)
def test_warm_started_sharded_loop_is_bitwise_across_world_sizes(sharded, shape):
    (one,) = _ranks(sharded, 1)
    want = one["codec"][(shape, "warm")]
    assert want["warm"][2] <= want["cold"][1] and want["warm"][3]
    for world in (2, 4):
        for r in _ranks(sharded, world):
            got = r["codec"][(shape, "warm")]
            for a, b in zip(got["warm"][:2], want["warm"][:2]):
                np.testing.assert_array_equal(a, b)
            assert got["warm"][2:] == want["warm"][2:]


def test_the_sharded_loop_refuses_what_the_reference_refuses(sharded):
    for world in WORLDS:
        for r in _ranks(sharded, world):
            assert "pallas" in r["refusals"]["pallas"] and "packed" in r["refusals"]["pallas"]
            assert "use_kernels" in r["refusals"]["use_kernels"]


def test_a_parity_request_changes_no_byte(sharded):
    """Packed blobs of a "bound"-class shape under parity "auto", "bitwise"
    and "bound": byte for byte the same at every world size (the reference
    refuses "bitwise" there; the port has no second guarantee to select)."""
    (one,) = _ranks(sharded, 1)
    want = one["parity_payloads"][0]
    for world in WORLDS:
        for r in _ranks(sharded, world):
            assert r["parity_payloads"] == [want] * 3


@pytest.mark.parametrize("world", (1, 2, 4))
@pytest.mark.parametrize("impl,block", BACKEND_CASES, ids=[f"{i}-{b}" for i, b in BACKEND_CASES])
def test_sharded_backend_is_bitwise_the_batched_backend(sharded, impl, block, world):
    for rank, r in enumerate(_ranks(sharded, world)):
        case = r["backend"][(impl, block)]
        for name, want in case["batched"].items():
            got = case["sharded"][name]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape, (name, rank)
                np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {rank}")
    n_blocks = len(case["batched"]["stats"][2])
    assert n_blocks % 4  # the pad-to-axis-multiple path runs at 4 ranks (and at 2 for 9 blocks)
    assert bool(case["batched"]["stats"][1].all())
    assert int(case["batched"]["stats"][2].max()) > 1  # the loop corrected


def test_sharded_backend_matches_the_reference_batched_backend(sharded):
    """The world-4 sharded run against the reference's batched backend on the
    same inputs: iterations equal per block, corrected values within the
    cuFFT-vs-XLA-free CPU bar of tests/test_torch_blockwise.py (rtol 1e-5)."""
    from repro.core.engine import CorrectionEngine as RefEngine

    got = _ranks(sharded, 4)[0]["backend"][("xla", 512)]["sharded"]
    corr, _edits, stats = RefEngine("batched").correct(ranks.backend_tensors(), ranks.BACKEND_E, ranks.BACKEND_D,
                                                       block=512, return_edits=True)
    np.testing.assert_array_equal(got["stats"][2], np.asarray(stats.block_iterations))
    for a, b, E in zip(got["corrected"], corr, ranks.BACKEND_E):
        assert np.abs(a - np.asarray(b)).max() <= 1e-5 * E


def test_sharded_backend_needs_a_mesh_or_a_group():
    import torch.distributed as dist

    from repro_torch.core.blockwise import correct_batch
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.optim import compressed_psum

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="mesh"):
        correct_batch([np.zeros(8, np.float32)], 0.1, 0.1, backend="sharded", device="cpu")
    engine = CorrectionEngine(backend="sharded", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        engine.mesh
    with pytest.raises(ValueError, match="mesh"):
        engine.correct([np.zeros(8, np.float32)], 0.1, 0.1, block=8)
    with pytest.raises(ValueError, match="mesh"):
        compressed_psum(torch.zeros(4))


@pytest.mark.parametrize("shape", ranks.PSPEC_SHAPES, ids=str)
def test_power_spectrum_sharded_matches_the_gathered_spectrum(sharded, shape):
    import jax.numpy as jnp

    from repro.core.spectrum import power_spectrum as ref_power_spectrum
    from repro_torch.core.spectrum import power_spectrum

    x = ranks.codec_field(shape, seed=5)
    k, want = (t.numpy() for t in power_spectrum(torch.from_numpy(x)))
    _, ref = (np.asarray(t) for t in ref_power_spectrum(jnp.asarray(x)))
    for world in WORLDS:
        for r in _ranks(sharded, world):
            got_k, got = r["pspec"][shape]
            np.testing.assert_array_equal(got_k, k)
            for other in (want, ref):
                np.testing.assert_allclose(got[1:], other[1:], rtol=1e-4, atol=0)
                assert abs(got[0]) <= 1e-6 * other[1:].max()


def test_compressed_psum_sums_the_reference_codes(sharded):
    import jax.numpy as jnp

    from repro.optim.grad_compress import _quantize_dequantize

    for world in WORLDS:
        codes, steps = [], []
        for rank in range(world):
            same, _ = ranks.psum_inputs(rank)
            _, c, step = _quantize_dequantize(jnp.asarray(same), 8, 1e-2)
            codes.append(np.asarray(c).astype(np.int64))
            steps.append(np.float32(step))
        assert len(set(steps)) == 1  # the planted max: one grid on every rank
        want = np.sum(codes, axis=0).astype(np.float32) * steps[0] / np.float32(world)
        for r in _ranks(sharded, world):
            np.testing.assert_array_equal(r["psum"]["same"], want)


def test_compressed_psum_takes_the_largest_magnitude_over_the_ranks(sharded):
    for world in WORLDS:
        xs = [ranks.psum_inputs(rank)[1] for rank in range(world)]
        gmax = max(np.float32(np.abs(x).max()) for x in xs)
        step = np.maximum(np.float32(2 * 0.05) * gmax / np.float32(2.0**6), np.float32(1e-30))
        total = np.sum([np.rint(x / step).astype(np.int64) for x in xs], axis=0)
        want = total.astype(np.float32) * step / np.float32(world)
        mean = np.mean(xs, axis=0)
        for r in _ranks(sharded, world):
            np.testing.assert_array_equal(r["psum"]["other"], want)
            assert np.abs(r["psum"]["other"] - mean).max() <= step / 2 * (1 + 1e-6)


def test_replanned_mesh_spans_the_live_group(sharded):
    from repro.runtime.elastic import plan_mesh_shape as ref_plan

    for world in WORLDS:
        for r in _ranks(sharded, world):
            assert r["elastic"] == ref_plan(world, preferred_model=2)


@pytest.mark.parametrize("preferred", (1, 2, 3, 16, 64))
def test_elastic_planning_matches_the_reference(preferred):
    from repro.runtime import elastic as ref
    from repro_torch.runtime import elastic as port

    for n in range(1, 130):
        assert port.plan_mesh_shape(n, preferred) == ref.plan_mesh_shape(n, preferred)
    for total, pods, lost in ((512, 2, 1), (512, 4, 1), (256, 8, 3), (16, 2, 0)):
        assert port.survivors_after_pod_loss(total, pods, lost) == ref.survivors_after_pod_loss(total, pods, lost)
    with pytest.raises(ValueError, match="process group"):
        port.replan_mesh(4)


def test_the_torchrun_example_runs_on_two_gloo_ranks(tmp_path):
    """``examples/compress_sharded_torch.py`` under ``torch.distributed.run``
    (localhost rendezvous) at two CPU ranks: every check passes and the
    payload digest is the one-rank codec's."""
    import hashlib
    import json
    import os
    import pathlib
    import subprocess
    import sys

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.fields import make_field

    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "run.json"
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           str(root / "examples" / "compress_sharded_torch.py"), "--device", "cpu", "--field", "nyx-like",
           "--pencils", "64", "--block", "256", "--out", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(out.read_text())
    assert got["ok"] and got["world_size"] == 2
    assert got["codec"]["same_blob_on_every_rank"] and got["codec"]["decompress_sharded_bitwise"]
    assert got["pencils"]["bitwise_vs_batched"]
    assert [len(got["by_rank"][k]) for k in ("stage_seconds", "loop_seconds")] == [2, 2]

    codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="packed", max_iters=3000),
                 device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        blob = codec.compress(dist_fft.ShardedField.shard(make_field("nyx-like"), mesh))
    finally:
        dist.destroy_process_group()
    assert got["codec"]["payload_sha256"] == hashlib.sha256(blob.payload_bytes()).hexdigest()


def test_default_mesh_follows_a_new_default_group(tmp_path):
    """A mesh cached over one default group is not handed out after that
    group is destroyed and another initialized."""
    import torch.distributed as dist

    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / f'init{i}'}", rank=0, world_size=1)
        try:
            mesh = dist_fft.default_mesh("data")
            assert dist_fft.default_mesh("data") is mesh
            t = torch.ones(3)
            dist.all_reduce(t, group=mesh.get_group("data"))
            assert t.tolist() == [1.0, 1.0, 1.0]
            meshes.append(mesh)
        finally:
            dist.destroy_process_group()
    assert meshes[0] is not meshes[1]
