"""The port's codec end to end on the CPU, against the reference codec.

Blobs cross between the packages in both directions and decode within the
bounds they store; the reference's golden fixtures decode bitwise; a subset
of ``test_conformance.py``'s cases (odd and prime shapes; float16, float32
and float64 inputs; ``Delta_abs``, ``Delta_rel``, ``pspec`` and ``E_roi``
bounds) is rechecked in float64 against the STORED bounds.
"""

import os

import numpy as np
import pytest
import torch

from repro.compressors import get_compressor as r_get
from repro.core.ffcz import FFCz as RefFFCz
from repro.core.ffcz import FFCzBlob as RefBlob
from repro.core.ffcz import FFCzConfig as RefConfig
from repro_torch.compressors import get_compressor
from repro_torch.core.cubes import rfft_shape
from repro_torch.core.errors import BlobCorruptError
from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig

_DATA = os.path.join(os.path.dirname(__file__), "data")


def _field(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(shape) * 0.5 + 4.0).cumsum(axis=0)
    return np.ascontiguousarray(f, dtype=dtype)


def _cfg(kind, x, **kw):
    if kind == "Delta_abs":
        d = float(np.abs(np.fft.rfftn(np.asarray(x, np.float32))).max() * 1e-3)
        return dict(E_rel=1e-3, Delta_rel=None, Delta_abs=d, **kw)
    if kind == "Delta_rel":
        return dict(E_rel=1e-3, Delta_rel=1e-3, **kw)
    if kind == "E_roi":
        mask = np.zeros(np.shape(x), bool)
        mask[tuple(slice(n // 4, 3 * n // 4) for n in np.shape(x))] = True
        return dict(E_rel=1e-3, Delta_rel=1e-3, E_roi=mask, **kw)
    return dict(E_rel=1e-3, Delta_rel=None, pspec_rel=1e-3, max_iters=1500, **kw)


def _codec(**cfg):
    return FFCz(get_compressor("szlike"), FFCzConfig(**cfg), device="cpu")


def _assert_conforms(x, blob, dec):
    """Spatial bound unconditional, frequency bound when converged, both in
    float64 against the bounds the blob stores (ROI: its per-point grid)."""
    x32 = np.asarray(x, np.float32)
    assert dec.shape == x32.shape and dec.dtype == np.float32
    eps = dec.astype(np.float64) - x32.astype(np.float64)
    if blob.roi_bound is not None:
        grid = np.frombuffer(blob.roi_bound, np.float32).reshape(blob.shape)
        assert (np.abs(eps) <= grid.astype(np.float64)).all()
    assert np.abs(eps).max() <= blob.E
    assert blob.stats is None or blob.stats.converged
    d = np.fft.rfftn(eps)
    if blob.pointwise_delta is not None:
        delta = np.frombuffer(blob.pointwise_delta, np.float32).reshape(rfft_shape(blob.shape))
        delta = delta.astype(np.float64)
    else:
        delta = blob.Delta_scalar
    assert (np.abs(d.real) <= delta).all() and (np.abs(d.imag) <= delta).all()


CONFORMANCE_SHAPES = [(30, 14, 10), (15, 14, 10), (13, 11, 7), (9, 11), (32, 48)]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["Delta_abs", "Delta_rel", "pspec", "E_roi"])
@pytest.mark.parametrize("shape", CONFORMANCE_SHAPES, ids=str)
def test_conformance_subset(shape, kind, impl):
    x = _field(shape, seed=sum(shape))
    c = _codec(**_cfg(kind, x, fft_impl=impl))
    blob = c.compress(x)
    assert blob.stats.spatial_margin >= 0 and blob.stats.frequency_margin >= 0
    assert set(blob.stats.stage_seconds) == {"plan", "base", "loop", "polish", "execute", "encode", "verify"}
    _assert_conforms(x, blob, c.decompress(blob))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16], ids=str)
def test_input_dtypes_conform(dtype):
    x = _field((15, 14, 10), seed=5, dtype=dtype)
    c = _codec(**_cfg("Delta_rel", x, fft_impl="pallas"))
    blob = c.compress(x)
    _assert_conforms(x, blob, c.decompress(blob))


@pytest.mark.parametrize("kind", ["Delta_rel", "pspec", "E_roi"])
@pytest.mark.parametrize("shape", [(16, 16, 18), (16, 16, 17), (40, 35)], ids=str)
def test_blobs_cross_decode_both_ways(shape, kind):
    x = _field(shape, seed=1)
    cfg = _cfg(kind, x, fft_impl="pallas")
    port = _codec(**cfg)
    ref = RefFFCz(r_get("szlike"), RefConfig(**cfg))
    port_blob = port.compress(x)
    ref_blob = ref.compress(x)
    # port bytes decode under the reference, reference bytes under the port
    dec_r = ref.decompress(RefBlob.from_bytes(port_blob.to_bytes()))
    dec_t = port.decompress(FFCzBlob.from_bytes(ref_blob.to_bytes()))
    _assert_conforms(x, port_blob, dec_r)
    _assert_conforms(x, ref_blob, dec_t)
    # decoding is the same host float64 code in both packages: bitwise
    assert np.array_equal(dec_t, ref.decompress(ref_blob))
    assert np.array_equal(dec_r, port.decompress(port_blob))
    assert port_blob.stats.iterations > 0


@pytest.mark.parametrize(
    "blob_name,out_name",
    [
        ("legacy_blob_v0.bin", "legacy_blob_v0_output.npy"),
        ("padfree_v1_blob.bin", "padfree_v1_output.npy"),
        ("uneven_v1_blob.bin", "uneven_v1_output.npy"),
    ],
)
def test_golden_fixtures_decode_bitwise(blob_name, out_name):
    data = open(os.path.join(_DATA, blob_name), "rb").read()
    blob = FFCzBlob.from_bytes(data)
    got = _codec(E_rel=1e-3, Delta_rel=1e-3).decompress(blob)
    want = np.load(os.path.join(_DATA, out_name))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if blob_name != "legacy_blob_v0.bin":
        assert blob.to_bytes() == data  # parse -> write is byte-stable
    if blob_name == "uneven_v1_blob.bin":
        assert blob.pad_meta.n_dev == 8 and blob.pad_meta.padded_shape == (16, 14, 10)


def test_wire_format_tails_and_corruption():
    x = _field((12, 10), seed=2)
    c = _codec(E_rel=1e-3, Delta_rel=1e-3, crc=True)
    raw = c.compress(x).to_bytes()
    ref_raw = RefFFCz(r_get("szlike"), RefConfig(E_rel=1e-3, Delta_rel=1e-3, crc=True)).compress(x).to_bytes()
    assert raw[-25:-20] == ref_raw[-25:-20] == b"FFCC\x05"
    blob = FFCzBlob.from_bytes(raw)
    assert blob.crc and blob.to_bytes() == raw
    for bad in (raw + b"x", raw[:-1], raw[:3], raw[:4] + b"\x09" + raw[5:]):
        with pytest.raises(BlobCorruptError):
            FFCzBlob.from_bytes(bad)
    flipped = bytearray(raw)
    flipped[60] ^= 0xFF
    with pytest.raises(BlobCorruptError, match="CRC|corrupt"):
        FFCzBlob.from_bytes(bytes(flipped))


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert FFCz(get_compressor("szlike")).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FFCz(get_compressor("szlike"))
    with pytest.raises(ValueError, match="engine"):
        FFCz(get_compressor("szlike"), engine=_codec().engine, device="cpu")
