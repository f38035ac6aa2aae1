"""The port's pencil-decomposed rFFT (``repro_torch.sharding.dist_fft``).

Host helpers: byte-identical to the reference's pure functions over a grid
of (shape, n_dev), ``FFCP`` bytes included.  Transforms: gloo ranks at world
sizes 1, 2 and 4 (``_torch_ranks.body_transforms``, spawned once per world
size for the module) give ``pencil_rfftn`` / ``pencil_irfftn`` bitwise equal
to the world-size-1 run, which is bitwise the same per-axis pass sequence on
one process, for every shape (even and uneven slabs, both parity classes).
Against the fused ``torch.fft.rfftn`` / ``irfftn`` and the reference's
``jnp.fft`` they are held at rtol 1e-5 of the spectrum's (or field's)
largest magnitude: torch's fused transform does not reproduce the per-axis
sequence bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro.core.ffcz import PadMeta as RefPadMeta
from repro.sharding import dist_fft as ref
from repro_torch.core.ffcz import FFCzBlob, PadMeta
from repro_torch.sharding import dist_fft as port

WORLDS = (1, 2, 4)
RTOL = 1e-5

# TestShapeClassification's shapes (tests/test_dist_fft.py) and the rank
# bodies', at mesh sizes 1-8
GRID_SHAPES = sorted({(30, 16, 12), (32, 12, 16), (4, 16, 12), (30, 48), (32, 62), (32, 48), (32, 16, 12),
                      (24, 16, 12), (32, 24, 12), (24, 24, 10), (32, 16, 15), (30, 14, 10), (96, 80, 56),
                      (1, 1, 1), (1, 5), *ranks.FFT_SHAPES})
N_DEVS = (1, 2, 3, 4, 5, 8)


def _outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("shape", GRID_SHAPES, ids=str)
def test_host_helpers_match_the_reference(shape):
    for n_dev in N_DEVS:
        for name in ("classify_parity", "local_freq_shape", "padded_freq_shape", "padded_spatial_shape"):
            assert _outcome(getattr(port, name), shape, n_dev) == _outcome(getattr(ref, name), shape, n_dev), name
        for strict in (True, False):
            assert _outcome(port.validate_pencil_shape, shape, n_dev, strict) == \
                _outcome(ref.validate_pencil_shape, shape, n_dev, strict)
        for n in shape:
            assert port.slab_rows(n, n_dev) == ref.slab_rows(n, n_dev)
            assert port.padded_extent(n, n_dev) == ref.padded_extent(n, n_dev)
            assert port.ceil_div(n, n_dev) == ref.ceil_div(n, n_dev)
        spec, rspec = port.DistSpec("data", shape, n_dev), ref.DistSpec("data", shape, n_dev)
        assert dataclass_fields(spec) == dataclass_fields(rspec)


def dataclass_fields(spec):
    return (spec.axis_name, spec.gshape, spec.n_dev, spec.overlap_chunks)


@pytest.mark.parametrize("shape", [(128,), (8, 8, 8, 8), (0, 8, 8), (4, 0), (8, 8, 8)], ids=str)
def test_bad_shapes_raise_as_the_reference_does(shape):
    for n_dev in (0, 2):
        assert _outcome(port.classify_parity, shape, n_dev) == _outcome(ref.classify_parity, shape, n_dev)
        assert _outcome(port.validate_pencil_shape, shape, n_dev, False) == \
            _outcome(ref.validate_pencil_shape, shape, n_dev, False)


@pytest.mark.parametrize("shape", [(30, 48), (32, 62), (9, 7), (24, 30), (8, 6, 10), (30, 14, 9)], ids=str)
def test_local_pair_weights_match_the_reference(shape):
    """The reference reads the rank from ``axis_index``: run it under a
    ``vmap`` named after the axis, one lane a rank."""
    for n_dev in (1, 2, 4, 8):
        fs = port.local_freq_shape(shape, n_dev)
        want = jax.vmap(lambda _: ref.local_pair_weights(shape, fs, "data"), axis_name="data")(jnp.arange(n_dev))
        for rank in range(n_dev):
            got = port.local_pair_weights(shape, fs, rank)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[rank]))


@pytest.mark.parametrize("n_dev", (1, 2, 3, 4, 8, 512))
def test_ffcp_section_bytes_match_the_reference(n_dev):
    for shape in GRID_SHAPES:
        padded = port.padded_spatial_shape(shape, n_dev)
        assert padded == ref.padded_spatial_shape(shape, n_dev)
        got = PadMeta(n_dev=n_dev, padded_shape=padded).to_bytes()
        assert got == RefPadMeta(n_dev=n_dev, padded_shape=padded).to_bytes()
        assert PadMeta.from_bytes(got) == PadMeta(n_dev=n_dev, padded_shape=padded)


def test_blob_with_ffcp_round_trips_through_both_parsers():
    from repro.core.ffcz import FFCzBlob as RefBlob
    from repro_torch.core.edits import EncodedEdits

    edits = EncodedEdits(shape=(2, 3), is_complex=False, flags=b"\x00", payload=b"", n_active=0, quant_bits=4)
    blob = FFCzBlob(base_blob=b"base", spat_edits=edits, freq_edits=edits, E=0.5, Delta_scalar=0.25,
                    pointwise_delta=None, shape=(2, 3), pad_meta=PadMeta(4, (4, 3)))
    data = blob.to_bytes()
    parsed = RefBlob.from_bytes(data)
    assert parsed.pad_meta.n_dev == 4 and parsed.pad_meta.padded_shape == (4, 3)
    assert parsed.to_bytes() == data
    assert FFCzBlob.from_bytes(data).pad_meta == PadMeta(4, (4, 3))


# ---------------------------------------------------------------------------
# the transforms on gloo ranks


@pytest.fixture(scope="module")
def transforms(tmp_path_factory):
    return ranks.run_worlds("transforms", WORLDS, tmp_path_factory.mktemp("dist_fft"))


def _ranks(results, world):
    got = results[world]
    if isinstance(got, str):
        pytest.fail(f"world size {world}: {got}")
    return got


def _field(shape):
    return np.random.default_rng(ranks.FFT_SHAPES.index(shape)).standard_normal(shape).astype(np.float32)


def _per_axis_sequence(x):
    """The forward pass sequence on one process: r2c along the last axis,
    then c2c along axis 0, then axis 1, each along a contiguous last axis."""
    def along(fn, t, axis):
        return fn(t.movedim(axis, -1).contiguous()).movedim(-1, axis)

    t = torch.fft.rfft(torch.from_numpy(x), dim=-1)
    t = along(lambda q: torch.fft.fft(q, dim=-1), t, 0)
    if x.ndim == 3:
        t = along(lambda q: torch.fft.fft(q, dim=-1), t, 1)
    return t.numpy()


@pytest.mark.parametrize("shape", ranks.FFT_SHAPES, ids=str)
def test_world_size_one_is_the_per_axis_sequence(transforms, shape):
    (one,) = _ranks(transforms, 1)
    x = _field(shape)
    np.testing.assert_array_equal(one[shape]["X"], _per_axis_sequence(x))
    np.testing.assert_array_equal(one[shape]["to_host"], x)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("shape", ranks.FFT_SHAPES, ids=str)
def test_pencil_rfftn_is_bitwise_across_world_sizes(transforms, shape, world):
    (one,) = _ranks(transforms, 1)
    for rank, got in enumerate(_ranks(transforms, world)):
        np.testing.assert_array_equal(got[shape]["X"], one[shape]["X"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got[shape]["to_host"], _field(shape))
        assert got[shape]["chunking_neutral"], "overlap_chunks 1, 2, 3 differ"
        assert got[shape]["pad_zero"], "pad rows/columns of the gathered spectrum are not zero"


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("shape", ranks.FFT_SHAPES, ids=str)
def test_pencil_irfftn_is_bitwise_across_world_sizes(transforms, shape, world):
    """Also for "bound"-class shapes: the port's anchor is its own per-axis
    sequence, and every pass is batch-invariant, so the inverse's 1/N
    placement is the same at every world size."""
    (one,) = _ranks(transforms, 1)
    for got in _ranks(transforms, world):
        for key in ("inverse", "inverse_packed"):
            np.testing.assert_array_equal(got[shape][key], one[shape][key], err_msg=key)
        np.testing.assert_array_equal(got[shape]["inverse_foreign_layout"], one[shape]["inverse"])
        assert got[shape]["inverse_local_pad_zero"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_parity_request_selects_nothing(transforms, world):
    """The port has no second guarantee to choose (every shape is bitwise
    across world sizes, none against the fused transform): ``parity`` of
    "auto", "bitwise" and "bound" gives the same slab, spectrum and inverse,
    on every shape of both classes, and reports the reference's class."""
    for got in _ranks(transforms, world):
        for shape in ranks.FFT_SHAPES:
            assert got[shape]["parity_inert"], shape


@pytest.mark.parametrize("shape", ranks.FFT_SHAPES, ids=str)
def test_transforms_agree_with_the_fused_ones_at_a_tolerance(transforms, shape):
    (one,) = _ranks(transforms, 1)
    x = _field(shape)
    X = one[shape]["X"]
    for fused in (torch.fft.rfftn(torch.from_numpy(x)).numpy(), np.asarray(jnp.fft.rfftn(jnp.asarray(x)))):
        assert np.abs(X - fused).max() <= RTOL * np.abs(fused).max()
    scale = np.abs(x).max()
    for inverse in (torch.fft.irfftn(torch.from_numpy(X), s=shape).numpy(),
                    np.asarray(jnp.fft.irfftn(jnp.asarray(X), s=shape, axes=tuple(range(len(shape)))))):
        assert np.abs(one[shape]["inverse"] - inverse).max() <= RTOL * scale
        assert np.abs(one[shape]["inverse_packed"] - inverse).max() <= RTOL * scale
    assert np.abs(one[shape]["inverse"] - x).max() <= RTOL * scale


def test_bound_class_shapes_are_covered():
    """The transforms above include both parity classes, uneven slabs at 2
    and 4 ranks, and axes shorter than the rank count."""
    classes = {ref.classify_parity(s, 4) for s in ranks.FFT_SHAPES}
    assert classes == {"bitwise", "bound"}
    assert any(s[0] % 4 for s in ranks.FFT_SHAPES) and any(s[0] % 2 for s in ranks.FFT_SHAPES)
    assert any(len(s) == 3 and s[1] < 4 for s in ranks.FFT_SHAPES)


def test_dist_spec_carries_its_group_outside_equality():
    a = port.DistSpec("data", (8, 8), 2, group="g1")
    assert a == port.DistSpec("data", (8, 8), 2, group="g2")
    assert hash(a) == hash(port.DistSpec("data", (8, 8), 2))


def test_no_process_group_means_no_default_mesh():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="mesh"):
        port.default_mesh()
    with pytest.raises(ValueError, match="mesh"):
        port.ShardedField.shard(np.zeros((4, 4), np.float32))
