"""The port's CUDA kernels on the card, each against its plain twin.

The POCS-loop kernels must match bitwise.  The flash-attention kernel sums
in another order than the twin's materialised softmax: in float32 it must
agree within atol 3e-5; in bfloat16 within one bfloat16 ulp at each
element's magnitude, with the float32 bar as a floor.  (Without the floor no
pair of correct float32 algorithms would pass: an output that cancels to
~1e-8 has a bfloat16 ulp near 1e-10, far below float32 rounding of its
order-one terms.)

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
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
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


def _bf16_within_one_ulp(a, b, floor=3e-5):
    """|a - b| <= one bfloat16 ulp of max(|a|, |b|) + floor, elementwise."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    mag = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(mag)  # mag in [2^(e-1), 2^e): its bfloat16 ulp is 2^(e-8)
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8), torch.zeros_like(mag))
    return bool(((a - b).abs() <= ulp + floor).all())


# (b, hq, hkv, sq, sk): GQA groups 1, 2 and 7, ragged lengths, suffix queries
FLASH_CASES = [(1, 4, 4, 8, 8), (2, 4, 2, 37, 37), (1, 14, 2, 130, 130), (2, 2, 1, 16, 300),
               (1, 7, 1, 1030, 1030), (1, 2, 2, 1, 77)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_twin(case, d, dtype):
    dev = _cuda()
    b, hq, hkv, sq, sk = case
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = t_flash.launches["flash_attention"]
    got = t_flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert t_flash.launches["flash_attention"] == before + 1
    want = attention_ref(q, k, v)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        assert float(torch.max(torch.abs(got - want))) <= 3e-5
    else:
        assert _bf16_within_one_ulp(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_non_causal_matches_twin(dtype):
    dev = _cuda()
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
               for s in ((2, 4, 37, 64), (2, 2, 100, 64), (2, 2, 100, 64)))
    got = t_flash.flash_attention(q, k, v, causal=False, scale=0.2)
    want = attention_ref(q, k, v, causal=False, scale=0.2)
    if dtype == torch.float32:
        assert float(torch.max(torch.abs(got - want))) <= 3e-5
    else:
        assert _bf16_within_one_ulp(got, want)


@pytest.mark.gpu
def test_flash_attention_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(NotImplementedError, match="head_dim"):
        t_flash.flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        t_flash.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_flash.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="sq <= sk"):
        t_flash.flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(NotImplementedError, match="backward"):
        t_flash.flash_attention(q.requires_grad_(), q, q)
