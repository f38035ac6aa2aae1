"""The port's CUDA kernels on the card: each against its plain twin, bitwise.

Every test is marked ``gpu`` and skips when no CUDA device is present (the
kernels are CUDA C++ with no CPU mode).  The file imports no JAX, so it runs
on a GPU machine without the reference package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.compressors import get_compressor
from repro_torch.core.ffcz import FFCz, FFCzConfig
from repro_torch.kernels.fcube import ops as t_fcube
from repro_torch.kernels.rfft import ops as t_rfft
from repro_torch.kernels.scube import ops as t_scube

SHAPES = [(16, 16, 18), (16, 16, 17), (40, 35), (40, 36), (24,), (3, 4, 5, 6)]
EVEN = [s for s in SHAPES if s[-1] % 2 == 0]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ with no CPU mode)")
    return torch.device("cuda")


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(shape).astype(np.float32)
    return rng, eps, np.fft.rfftn(eps).astype(np.complex64)


def _same(got, want):
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scube_fcube_match_twins(shape, pointwise):
    dev = _cuda()
    rng, eps, delta = _data(shape, 5)
    E = torch.from_numpy(rng.uniform(0.3, 1.5, shape).astype(np.float32)).to(dev) if pointwise else 0.8
    x = torch.from_numpy(eps).to(dev)
    before = t_scube.launches["scube"]
    got = t_scube.project_scube_fused(x, E)
    assert t_scube.launches["scube"] == before + 1
    assert _same(got, t_scube.project_scube_plain(x, E))
    d = torch.from_numpy(delta).to(dev)
    D = torch.from_numpy(rng.uniform(0.5, 4.0, delta.shape).astype(np.float32)).to(dev) if pointwise else 2.0
    for n_last in (None, shape[-1]):
        got = t_fcube.project_fcube_fused(d, D, n_last=n_last, check_tol=1e-5, check_slack=0.3)
        want = t_fcube.project_fcube_plain(d, D, n_last=n_last, check_tol=1e-5, check_slack=0.3)
        assert _same(got, want) and int(got[2]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", EVEN, ids=str)
def test_rfft_epilogues_match_twins(shape, pointwise):
    dev = _cuda()
    rng, _, delta = _data(shape, 6)
    d = torch.from_numpy(delta).to(dev)
    D = torch.from_numpy(rng.uniform(0.5, 4.0, delta.shape).astype(np.float32)).to(dev) if pointwise else 2.0
    for weighted in (False, True):
        got = t_rfft.fwd_epilogue_fused(d, D, weighted=weighted, check_tol=1e-5, check_slack=0.3)
        want = t_rfft.fwd_epilogue_plain(d, D, weighted=weighted, check_tol=1e-5, check_slack=0.3)
        assert _same(got, want)
    z = torch.fft.ifftn(got[2]).contiguous()
    E = torch.from_numpy(rng.uniform(0.01, 0.2, shape).astype(np.float32)).to(dev) if pointwise else 0.05
    assert _same(t_rfft.unpack_sclip_fused(z, E, shape), t_rfft.unpack_sclip_plain(z, E, shape))


@pytest.mark.gpu
def test_wrappers_reject_what_kernels_do_not_take():
    dev = _cuda()
    x = torch.zeros((8, 6), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        t_scube.project_scube_fused(x.t(), 1.0)
    with pytest.raises(TypeError, match="complex64"):
        t_rfft.fwd_epilogue_fused(torch.zeros((4, 5), device=dev), 1.0)
    with pytest.raises(ValueError, match="rank 1 to 4"):
        t_rfft.fwd_epilogue_fused(torch.zeros((2, 2, 2, 2, 5), dtype=torch.complex64, device=dev), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 32, 32), (32, 32, 31)], ids=str)
def test_compress_on_the_card_holds_bounds(shape):
    dev = _cuda()
    rng = np.random.default_rng(7)
    x = np.exp(rng.standard_normal(shape).cumsum(axis=0) * 0.1).astype(np.float32)
    codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas"), device=dev)
    blob = codec.compress(x)
    assert blob.stats.converged
    eps = codec.decompress(blob).astype(np.float64) - x.astype(np.float64)
    assert np.abs(eps).max() <= blob.E
    d = np.fft.rfftn(eps)
    assert max(np.abs(d.real).max(), np.abs(d.imag).max()) <= blob.Delta_scalar
