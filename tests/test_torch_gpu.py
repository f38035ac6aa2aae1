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
# (sk = 333 is no multiple of the bf16 kernel's 128-row K/V tile), and one
# qwen2-0.5b layer's heads at full length
FLASH_CASES = [(1, 4, 4, 8, 8), (2, 4, 2, 37, 37), (1, 14, 2, 130, 130), (2, 2, 1, 16, 300),
               (1, 7, 1, 1030, 1030), (1, 2, 2, 1, 77), (2, 7, 1, 77, 333), (1, 14, 2, 2048, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [64, 112, 128])
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


# (b, hq, hkv, sq, sk, d): llava-next-mistral-7b's forward (2880 patches +
# 2048 tokens: 38.5 tiles of 128 rows, GQA 4, d = 128) and whisper-tiny's
# decoder at its 448-token context (MHA, d = 64)
FLASH_FAMILY_CASES = [(4, 32, 8, 4928, 4928, 128), (4, 6, 6, 448, 448, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_FAMILY_CASES, ids=["llava", "whisper"])
def test_flash_attention_matches_twin_at_the_vlm_and_audio_shapes(case, dtype):
    dev = _cuda()
    b, hq, hkv, sq, sk, d = case
    gen = torch.Generator(device=dev).manual_seed(sq)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    got = t_flash.flash_attention(q, k, v)
    want = attention_ref(q, k, v)
    torch.cuda.synchronize()
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


# float32 only (split TF32): the smoke configs' head dim 16 at FLASH_CASES,
# and the families' float32 shapes (granite-moe's GQA 3 at d = 64, zamba2's
# d = 112), each causal and not
FLASH_F32_CASES = ([(c, 16) for c in FLASH_CASES]
                   + [((4, 24, 8, 2048, 2048), 64), ((4, 32, 32, 2048, 2048), 112)])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", FLASH_F32_CASES, ids=str)
def test_flash_attention_float32_split_tf32_matches_twin(case, causal):
    dev = _cuda()
    (b, hq, hkv, sq, sk), d = case
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = t_flash.launches["flash_attention"]
    got = t_flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert t_flash.launches["flash_attention"] == before + 1
    assert float(torch.max(torch.abs(got - attention_ref(q, k, v, causal=causal)))) <= 3e-5


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 112, 128])
def test_flash_attention_float32_holds_over_long_kv_when_v_has_a_mean(d):
    """V = 1 + noise over llava's 4928 kv rows: O sums thousands of
    positive terms, where accumulating it on the tensor cores across the
    kv tiles drifted 6e-5 from the twin (a llava forward's attention)."""
    dev = _cuda()
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
               for s in ((2, 8, 4928, d), (2, 2, 4928, d), (2, 2, 4928, d)))
    v += 1.0
    got = t_flash.flash_attention(q, k, v)
    assert float(torch.max(torch.abs(got - attention_ref(q, k, v)))) <= 3e-5


@pytest.mark.gpu
def test_flash_attention_float32_refuses_too_little_scratch():
    from repro_torch.kernels import build

    dev = _cuda()
    q = torch.zeros((1, 2, 8, 64), device=dev)
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    need = lib.flash_attention_scratch_floats(1, 2, 2, 8, 8, 64, 0)
    assert need > 0 and lib.flash_attention_scratch_floats(1, 2, 2, 8, 8, 64, 1) == 0
    scratch = torch.empty(need, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (1, 2, 2, 8, 8, 64, 0, 0.125, 1, stream)
    assert lib.flash_attention_launch(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), need - 1, *args) != 0
    assert lib.flash_attention_launch(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), need, *args) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("nan_head", [(0, 1), (1, 0)], ids=str)
@pytest.mark.parametrize("d", [64, 112, 128])
def test_flash_attention_nan_head_stays_in_its_head(d, nan_head):
    """NaN in one (batch, kv head) of K and V reaches only the query heads of
    that group.  The head just before it in memory is clean: a K/V tile that
    read past that head's last row (sk = 200 is no multiple of the 128-row
    tile) would take the NaN head's first rows, and 0 * NaN in P.V would
    carry them into its output."""
    dev = _cuda()
    b, hq, hkv, sq, sk = 2, 4, 2, 70, 200
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    nb, nh = nan_head
    k[nb, nh] = float("nan")
    v[nb, nh] = float("nan")
    got = t_flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    group = slice(nh * (hq // hkv), (nh + 1) * (hq // hkv))  # the query heads that read it
    clean = torch.ones(b, hq, dtype=torch.bool)
    clean[nb, group] = False
    assert not torch.isfinite(got[nb, group]).any()
    assert torch.isfinite(got[clean]).all()
    assert _bf16_within_one_ulp(got[clean], attention_ref(q, k, v)[clean])


#: the line of csrc/flash_attention.cu whose removal leaves P = bf16(p) alone
SPLIT_P_LO_LINE = "        wgmma_rs<DP>(o, p_lo[kk], dv, 1);\n"


def _bf16_ulp_report(a, b):
    """Elements more than one bfloat16 ulp apart, the largest distance in
    ulps and the largest |a - b|."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    mag = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(mag)
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8), torch.zeros_like(mag))
    diff = (a - b).abs()
    ulps = torch.where(ulp > 0, diff / ulp, torch.zeros_like(diff))
    return {"n_over_one_ulp": int((diff > ulp).sum()), "max_ulps": float(ulps.max()),
            "max_abs_err": float(diff.max())}


def _cuda_ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 112, 128])
def test_flash_attention_split_p_holds_the_bar_a_single_bf16_p_misses(d, tmp_path):
    """Why the bf16 kernel splits P into bf16 hi and lo halves: the same
    source rebuilt without the P_lo product misses the bar at the forward
    loss's shape, (4, 14, 2048, d).  Both variants' errors and times are
    printed (``pytest -rP`` shows them)."""
    import ctypes
    import json
    import math
    import subprocess

    from repro_torch.kernels import build

    dev = _cuda()
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert src.count(SPLIT_P_LO_LINE) == 1, "the P_lo product line moved"
    (tmp_path / "flash_attention.cu").write_text(src.replace(SPLIT_P_LO_LINE, ""))
    lib = tmp_path / "libflash_attention_single_p.so"
    subprocess.run([build.nvcc(), *build.flags("flash_attention"), "-I", str(build.CSRC), "-o", str(lib),
                    str(tmp_path / "flash_attention.cu")], check=True, capture_output=True, timeout=600)
    launch = ctypes.CDLL(str(lib)).flash_attention_launch
    launch.argtypes = list(build.SIGNATURES["flash_attention"]["flash_attention_launch"])
    launch.restype = ctypes.c_int

    b, hq, hkv, s = 4, 14, 2, 2048
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))

    def single_p():
        out = torch.empty_like(q)
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 0, b, hq, hkv, s, s, d,
                     1, 1.0 / math.sqrt(d), 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        return out

    want = attention_ref(q, k, v)
    split, one = t_flash.flash_attention(q, k, v), single_p()
    torch.cuda.synchronize()
    report = {"shape": [b, hq, s, d],
              "split_p": {**_bf16_ulp_report(split, want), "ms": _cuda_ms(lambda: t_flash.flash_attention(q, k, v))},
              "single_p": {**_bf16_ulp_report(one, want), "ms": _cuda_ms(single_p)}}
    print(json.dumps(report))
    assert _bf16_within_one_ulp(split, want)
    assert not _bf16_within_one_ulp(one, want)


@pytest.mark.gpu
def test_flash_attention_rejects_a_misaligned_bf16_operand():
    dev = _cuda()
    shape = (1, 2, 8, 64)
    q = torch.zeros(shape, device=dev, dtype=torch.bfloat16)
    buf = torch.zeros(q.numel() + 1, device=dev, dtype=torch.bfloat16)
    shifted = buf[1:].view(shape)  # contiguous, 2 bytes past a 16-byte boundary
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = t_flash.launches["flash_attention"]
    for args in ((shifted, q, q), (q, shifted, q), (q, q, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            t_flash.flash_attention(*args)
    assert t_flash.launches["flash_attention"] == before


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


# -- slice 3: QuantizeEdits, the block transform, the per-pencil modes --------

from repro_torch.core.blockwise import correct_batch  # noqa: E402
from repro_torch.core.engine import CorrectionEngine  # noqa: E402
from repro_torch.kernels.block_transform import ops as t_bt  # noqa: E402
from repro_torch.kernels.block_transform.ref import block_transform_quantize_ref  # noqa: E402
from repro_torch.kernels.quantize import ops as t_quantize  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_edits_ref  # noqa: E402

ROWS = [(7, 64), (300, 1024), (5, 18)]  # (rows, block)


@pytest.mark.gpu
@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("m", [8, 16, 24])
@pytest.mark.parametrize("shape", [(1000,), (37, 29), (9, 11, 13)], ids=str)
def test_quantize_matches_twin(shape, m, pointwise):
    dev = _cuda()
    rng = np.random.default_rng(m)
    v = torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32)).to(dev)
    if pointwise:
        b = rng.uniform(0.02, 0.08, shape).astype(np.float32)
        b.reshape(-1)[::5] = 0.0
        b = torch.from_numpy(b).to(dev)
    else:
        b = 0.05
    before = t_quantize.launches["quantize"]
    got = t_quantize.quantize_edits(v, b, m=m)
    assert t_quantize.launches["quantize"] == before + 1
    assert _same(got, quantize_edits_ref(v, b, m))
    # out-of-range and NaN values saturate the same way in kernel and twin
    wild = torch.tensor([1e30, -1e30, float("nan"), float("inf"), 3.5e-5], device=dev)
    assert _same(t_quantize.quantize_edits(wild, 1e-6, m=m), quantize_edits_ref(wild, 1e-6, m))


#: rows at which the block transform's ring wraps several times on every SM
#: for every B: 8 laps of the deepest ring of the largest tile (3 x 512 rows)
#: over 132 SMs, plus a ragged tile
BT_WRAP = 8 * 132 * 3 * 512 + 5
#: row counts around every tile the kernel could use (R of 64 to 512 rows),
#: a ring that wraps once on a CTA an SM, and one that wraps several times
BT_ROWS = sorted({0, 1, 132 * 3 * 512 + 5, BT_WRAP} | {r + d for r in (64, 128, 256, 512) for d in (-1, 0, 1)})


@pytest.mark.gpu
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("nb", BT_ROWS)
@pytest.mark.parametrize("B", [16, 32, 64, 128])
def test_block_transform_matches_twin(B, nb, misaligned):
    dev = _cuda()
    rng = np.random.default_rng(B)
    x = np.exp(rng.standard_normal((nb, B), dtype=np.float32))
    # NaN, +-inf and values whose codes leave int32, one in each of a few rows
    wild = np.float32([np.nan, np.inf, -np.inf, 1e30, -1e30])[: nb]
    x[rng.choice(nb, len(wild), replace=False), rng.integers(0, B, len(wild))] = wild
    flat = torch.empty(nb * B + 1, device=dev)
    blocks = flat[int(misaligned): int(misaligned) + nb * B].view(nb, B)
    blocks.copy_(torch.from_numpy(x))
    assert nb == 0 or (blocks.data_ptr() % 16 != 0) == misaligned
    q_mat, _ = np.linalg.qr(rng.standard_normal((B, B)))
    mat = torch.from_numpy(q_mat.astype(np.float32)).to(dev)
    before = t_bt.launches["block_transform"]
    got = t_bt.block_transform_quantize(blocks, mat, 0.01)
    assert t_bt.launches["block_transform"] == before + (nb > 0)
    assert _same((got,), (block_transform_quantize_ref(blocks, mat, 0.01),))


#: cudaErrorMisalignedAddress
CUDA_ERROR_MISALIGNED_ADDRESS = 716


@pytest.mark.gpu
def test_block_transform_launch_refuses_a_misaligned_operand():
    """The C launcher refuses an x or codes that is not 16-byte aligned (the
    bulk copy and the int4 stores need it) and launches nothing; the
    wrapper never hands it one."""
    from repro_torch.kernels import build

    dev = _cuda()
    B, nb = 64, 8
    x = torch.ones(nb * B + 4, device=dev)
    codes = torch.full((nb * B + 4,), -7, dtype=torch.int32, device=dev)
    mat = torch.eye(B, device=dev)
    launch = build.library("block_transform").block_transform_launch
    stream = torch.cuda.current_stream().cuda_stream
    for xp, cp in ((x.data_ptr() + 4, codes.data_ptr()), (x.data_ptr(), codes.data_ptr() + 4)):
        assert launch(xp, mat.data_ptr(), 1.0, B, nb, cp, stream) == CUDA_ERROR_MISALIGNED_ADDRESS
    torch.cuda.synchronize()
    assert bool((codes == -7).all())
    assert launch(x.data_ptr(), mat.data_ptr(), 1.0, B, nb, codes.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert bool((codes[: nb * B] == 1).all()) and bool((codes[nb * B:] == -7).all())


#: csrc/block_transform.cu's kernel with its ring taken out: each CTA walks
#: the same tiles, loading each with all its threads (float4 or scalar loads)
#: between two barriers, then runs the same product loop and stores
BT_SYNC_LOAD_SOURCE = r"""
namespace {

template <int B, bool kVec>
__global__ void __launch_bounds__(Tiling<B>::kThreads, Tiling<B>::kMinBlocks)
bt_sync_kernel(const float* __restrict__ x, const float* __restrict__ mat, float q, long long nb,
               int* __restrict__ codes) {
  using T = Tiling<B>;
  extern __shared__ __align__(128) float smem[];
  float* tile = smem;
  float* mt = smem + T::kTile;
  const int tid = threadIdx.x;
  const long long tiles = (nb + T::kRows - 1) / T::kRows;
  for (int i = tid; i < B * B; i += T::kThreads) mt[i] = mat[(i % B) * B + i / B];
  const int tc = tid % T::kCols, tr = tid / T::kCols;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long rows = nb - t * T::kRows < T::kRows ? nb - t * T::kRows : T::kRows;
    const float* src = x + t * T::kRows * B;
    const int n = (int)(rows * B);  // 32-bit bounds, so that the loops unroll
    __syncthreads();
    if (kVec)
      for (int i = tid; i < n / 4; i += T::kThreads)
        reinterpret_cast<float4*>(tile)[i] = reinterpret_cast<const float4*>(src)[i];
    else
      for (int i = tid; i < n; i += T::kThreads) tile[i] = src[i];
    __syncthreads();
    float acc[T::kTM][T::kTN];
    multiply_rows<B>(tile + tr * T::kTM * B, mt + 4 * tc, acc);
    store_codes<B>(acc, q, t * T::kRows + tr * T::kTM, nb, codes + 4 * tc);
  }
}

template <int B, bool kVec>
int sync_launch(const float* x, const float* mat, float q, long long nb, int* codes, cudaStream_t s) {
  using T = Tiling<B>;
  const auto kernel = bt_sync_kernel<B, kVec>;
  const size_t smem = sizeof(float) * (size_t)(T::kTile + B * B);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (nb + T::kRows - 1) / T::kRows;
  const unsigned grid = (unsigned)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, T::kThreads, smem, s>>>(x, mat, q, nb, codes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bt_sync_launch(const void* x, const void* mat, float q, int B, long long nb, void* codes,
                              void* stream, int vec) {
  const float* xp = (const float*)x;
  const float* mp = (const float*)mat;
  int* cp = (int*)codes;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 64) return vec ? sync_launch<64, true>(xp, mp, q, nb, cp, s) : sync_launch<64, false>(xp, mp, q, nb, cp, s);
  if (B == 128) return vec ? sync_launch<128, true>(xp, mp, q, nb, cp, s) : sync_launch<128, false>(xp, mp, q, nb, cp, s);
  return (int)cudaErrorInvalidValue;
}
"""


@pytest.mark.gpu
@pytest.mark.parametrize("B", [64, 128])
def test_block_transform_ring_outruns_a_synchronous_tile_load(B, tmp_path):
    """Why the kernel fills its tiles through a ring of bulk copies: the same
    kernel with each tile loaded by all its threads between two barriers
    (with float4 loads, or with scalar loads that would need no aligned
    operand) is bitwise too but slower at the smoke's shape, 262,144 x B.
    Each variant's median of five timings, alternated, is printed
    (``pytest -rP`` shows them)."""
    import ctypes
    import json
    import subprocess

    from repro_torch.kernels import build

    dev = _cuda()
    (tmp_path / "bt_sync.cu").write_text((build.CSRC / "block_transform.cu").read_text() + BT_SYNC_LOAD_SOURCE)
    lib = tmp_path / "libbt_sync.so"
    subprocess.run([build.nvcc(), *build.flags("block_transform"), "-I", str(build.CSRC), "-o", str(lib),
                    str(tmp_path / "bt_sync.cu")], check=True, capture_output=True, timeout=600)
    sync = ctypes.CDLL(str(lib)).bt_sync_launch
    sync.argtypes = list(build.SIGNATURES["block_transform"]["block_transform_launch"]) + [ctypes.c_int]
    sync.restype = ctypes.c_int
    ring = build.library("block_transform").block_transform_launch

    nb = 262144
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.standard_normal((nb, B), dtype=np.float32)).to(dev)
    q_mat, _ = np.linalg.qr(rng.standard_normal((B, B)))
    mat = torch.from_numpy(q_mat.astype(np.float32)).to(dev)
    want = block_transform_quantize_ref(x, mat, 0.01)
    codes = torch.empty_like(want)
    args = (x.data_ptr(), mat.data_ptr(), 0.01, B, nb, codes.data_ptr(), torch.cuda.current_stream().cuda_stream)
    variants = {"ring": lambda: ring(*args), "sync_float4": lambda: sync(*args, 1),
                "sync_scalar": lambda: sync(*args, 0)}
    times = {}
    for name, fn in variants.items():
        codes.fill_(-1)
        assert fn() == 0
        torch.cuda.synchronize()
        assert torch.equal(codes, want), name
        times[name] = []
    for _ in range(5):
        for name, fn in variants.items():
            times[name].append(_cuda_ms(fn, reps=50))
    median = {name: float(np.median(t)) for name, t in times.items()}
    print(json.dumps({"B": B, "nb": nb, "median_ms": median, "ms": times}))
    assert median["ring"] < min(median["sync_float4"], median["sync_scalar"])


@pytest.mark.gpu
def test_block_transform_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    with pytest.raises(ValueError, match="B in"):
        t_bt.block_transform_quantize(torch.zeros((4, 48), device=dev), torch.eye(48, device=dev), 0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("rows_block", ROWS, ids=str)
def test_per_pencil_modes_match_twins(rows_block):
    dev = _cuda()
    rows, n = rows_block
    rng = np.random.default_rng(n)
    eps = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
    E = torch.from_numpy(rng.uniform(0.5, 1.5, (rows, 1)).astype(np.float32)).to(dev)
    before = dict(t_scube.launches)
    assert _same(t_scube.project_scube_fused(eps, E), t_scube.project_scube_plain(eps, E))
    assert t_scube.launches["scube_rows"] == before["scube_rows"] + 1
    delta = torch.fft.rfft(eps, dim=-1).contiguous()
    D = torch.from_numpy(rng.uniform(1.0, 4.0, (rows, 1)).astype(np.float32)).to(dev)
    for bound in (D, 2.5):
        got = t_fcube.project_fcube_fused(delta, bound, n_last=n, check_tol=1e-5, per_row=True)
        want = t_fcube.project_fcube_plain(delta, bound, n_last=n, check_tol=1e-5, per_row=True)
        assert _same(got, want) and got[2].shape == (rows,) and int(got[2].sum()) > 0
        if n % 2 == 0:
            got = t_rfft.fwd_epilogue_fused(delta, bound, weighted=True, check_tol=1e-5, per_row=True)
            want = t_rfft.fwd_epilogue_plain(delta, bound, weighted=True, check_tol=1e-5, per_row=True)
            assert _same(got, want) and got[3].shape == (rows,)
            z = torch.fft.ifft(got[2], dim=-1).contiguous()
            assert _same(t_rfft.unpack_sclip_fused(z, E, (rows, n)), t_rfft.unpack_sclip_plain(z, E, (rows, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("block", [256, 255])
@pytest.mark.parametrize("impl", ["xla", "packed", "pallas"])
def test_correct_batch_on_the_card_matches_the_cpu(impl, block):
    dev = _cuda()
    rng = np.random.default_rng(block)
    E, D = [0.03, 0.05, 0.04], [0.2, 0.3, 0.25]
    # initial errors inside each s-cube, as a base compressor's are
    tensors = [np.clip(rng.standard_normal(s) * 0.02, -e, e).astype(np.float32)
               for s, e in zip(((3, 500), (1000,), (7, 9, 11)), E)]
    got, gs = correct_batch([torch.from_numpy(t).to(dev) for t in tensors], E, D, block=block,
                            max_iters=30, fft_impl=impl)
    want, ws = correct_batch([torch.from_numpy(t) for t in tensors], E, D, block=block,
                             max_iters=30, fft_impl=impl)
    assert bool(gs.converged.all()) and bool(ws.converged.all())
    # cuFFT and the CPU FFT round differently, so the trajectories are held
    # bound-class: every pencil converges on both devices within its bounds
    # (the last s-clip clips to the float32 E)
    for g, w, e in zip(got, want, E):
        assert float(torch.abs(g).max()) <= np.float32(e) and float(torch.abs(w).max()) <= np.float32(e)


@pytest.mark.gpu
def test_engine_backends_agree_on_the_card():
    dev = _cuda()
    rng = np.random.default_rng(9)
    tensors = [(rng.standard_normal(s) * 0.02).astype(np.float32) for s in ((4, 1024), (3000,))]
    outs = [CorrectionEngine(backend=b, fft_impl="pallas", device=dev).correct(
        [torch.from_numpy(t).to(dev) for t in tensors], 0.03, 0.2, block=1024, max_iters=30)
        for b in ("local", "batched")]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the training path: gradient and checkpoint compression, remat


def _pencils_within(err, E, D, block):
    """|err| <= E and every full pencil's spectrum within D * (1 + 1e-5) +
    tau, in float64 on the host (tau bounds the float32 FFT's rounding)."""
    x = err.detach().cpu().double().numpy().reshape(-1)
    full = x[: x.size // block * block].reshape(-1, block)
    spec = np.fft.rfft(full, axis=-1)
    mag = np.maximum(np.abs(spec.real), np.abs(spec.imag)).max(axis=1)
    tau = 5 * 2.0**-24 * np.log2(block) * np.sqrt(block) * np.sqrt((full * full).sum(axis=1))
    return float(np.abs(x).max()) <= E and bool(np.all(mag <= D * (1 + 1e-5) + tau))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_compress_gradients_on_the_card_holds_bounds(impl):
    """Float32 and bfloat16 leaves, block 4096 and a short leaf's own
    length; Delta_rel 5e-5 < 2^-8, so the loop corrects."""
    from repro_torch.optim import compress_gradients

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = {"embed": torch.randn((64, 4096), generator=gen, device=dev) * 1e-3,
             "layers": {"w": torch.randn((3, 896, 64), generator=gen, device=dev).to(torch.bfloat16),
                        "scale": torch.randn((3, 896), generator=gen, device=dev)},
             "ln": torch.randn(896, generator=gen, device=dev)}
    engine = CorrectionEngine(fft_impl=impl, device=dev)
    calls, correct = [], engine.correct

    def recording(errs, Es, Ds, **kw):
        out = correct(errs, Es, Ds, **kw)
        calls.append((Es, Ds, out, kw["block"]))
        return out

    engine.correct = recording
    before = dict(t_rfft.launches)
    out = compress_gradients(grads, Delta_rel=5e-5, engine=engine)
    assert sorted(c[3] for c in calls) == [896, 2688, 4096]  # each short leaf its own length
    for Es, Ds, (corrected, stats), block in calls:
        assert bool(stats.converged.all())
        assert block != 4096 or int(stats.block_iterations.max()) >= 2  # the loop corrects
        for E, D, c in zip(Es, Ds, corrected):
            assert _pencils_within(c, float(E), float(D), block)
    assert out["layers"]["w"].dtype == torch.bfloat16 and out["embed"].shape == (64, 4096)
    fired = [t_rfft.launches[k] - before[k] for k in ("rfft_fwd_epilogue_rows", "unpack_sclip_rows")]
    if impl == "pallas":
        assert all(n > 0 for n in fired)
    else:
        assert not any(fired)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encode_batch_on_the_card_holds_bounds(impl):
    import struct

    from repro_torch.checkpoint import CheckpointCodec

    dev = _cuda()
    rng = np.random.default_rng(4)
    arrays = [(rng.standard_normal((256, 4096)) * 0.02).astype(np.float32),
              np.cumsum(rng.standard_normal((4, 8, 16, 32)), axis=-1).astype(np.float32),
              rng.standard_normal(5000).astype(np.float64), np.arange(10)]
    codec = CheckpointCodec(enabled=True, engine=CorrectionEngine(fft_impl=impl, device=dev))
    before = dict(t_rfft.launches)
    blobs = codec.encode_batch(arrays)
    assert [b[:1] for b in blobs] == [b"B", b"B", b"B", b"R"]
    for a, data in zip(arrays, blobs):
        back = codec.decode(data)
        assert back.shape == a.shape and back.dtype == a.dtype
        if data[:1] == b"R":
            assert np.array_equal(back, a)
            continue
        _dt, E, D, block, _nd = struct.unpack_from("<BddIB", data, 1)
        diff = back.astype(np.float64) - a.astype(np.float32).astype(np.float64)
        assert np.abs(diff).max() <= E
        flat = diff.reshape(-1)
        full = flat[: flat.size // block * block].reshape(-1, block)
        if full.size:
            spec = np.fft.rfft(full, axis=-1)
            assert max(np.abs(spec.real).max(), np.abs(spec.imag).max()) <= D * (1 + 1e-9)
    fired = sum(t_rfft.launches[k] - before[k] for k in t_rfft.launches)
    assert (fired > 0) == (impl == "pallas")


def _loss_and_grads(cfg, params, tokens):
    from repro_torch.models.model import build_model

    bundle = build_model(cfg, device="cuda")
    named = dict(params.named_parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = bundle.loss(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(named.values()))
    torch.cuda.synchronize()
    return loss.detach(), grads, torch.cuda.max_memory_allocated() - base


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_modes_agree_on_the_card(dtype):
    """The same loss (bitwise: the forward is deterministic) and gradients
    (within 1e-6 of each leaf's largest: the embedding's backward adds with
    atomics) in every remat mode; the peak memory of ``none`` above both
    checkpointed modes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    dev = _cuda()
    cfg = get_config("qwen2-0.5b", n_layers=4, vocab=32768, dtype=dtype)
    params = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 1024), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    out = {m: _loss_and_grads(dataclasses.replace(cfg, remat=m), params, tokens) for m in ("none", "dots", "full")}
    print({m: o[2] / 1e6 for m, o in out.items()}, "MB peak above the parameters")
    for m in ("dots", "full"):
        assert torch.equal(out[m][0], out["none"][0])
        for a, b in zip(out[m][1], out["none"][1]):
            assert float((a.float() - b.float()).abs().max()) <= 1e-6 * float(b.float().abs().max())
    assert out["none"][2] > out["dots"][2] >= out["full"][2]


# -- the service path: temporal streams and the FFCz service on the card ------


def _evolving(shape, n, white=False):
    """Frames on which the loop acts at E_rel = Delta_rel = 1e-3 (it does not
    on smooth data, whose spectrum peaks far above the base error's): an
    evolving lognormal field, or white noise for pencils."""
    from repro_torch.configs.ffcz_fields import FieldConfig
    from repro_torch.data.fields import make_field

    if white:
        rng = np.random.default_rng(0)
        base = rng.standard_normal(shape)
        return [np.ascontiguousarray(base + 0.01 * t * rng.standard_normal(shape), dtype=np.float32)
                for t in range(n)]
    frames = [make_field(FieldConfig("f", shape, "lognormal", alpha=2.0, seed=0))]
    for t in range(1, n):
        fresh = make_field(FieldConfig("f", shape, "lognormal", alpha=2.0, seed=t))
        frames.append((frames[-1] + 0.01 * fresh).astype(np.float32))
    return frames


def _stream_within_header(codec, data, frames):
    from repro_torch.core.temporal import TemporalStream

    s = TemporalStream.from_bytes(data)
    dec = codec.decompress_stream(data)
    for t, (x, d) in enumerate(zip(frames, dec)):
        eps = d.astype(np.float64) - x.astype(np.float64)
        assert np.abs(eps).max() <= s.E, t
        if s.mode == "pencils":
            flat = eps.reshape(-1)
            spec = np.fft.rfft(flat[: flat.size // s.block * s.block].reshape(-1, s.block), axis=-1)
        else:
            spec = np.fft.rfftn(eps)
        assert np.abs(spec.real).max() <= s.Delta and np.abs(spec.imag).max() <= s.Delta, t
        assert np.array_equal(codec.decode_frame(data, t), d), t


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kernels", [((32, 32, 32), ("rfft_fwd_epilogue", "unpack_sclip")),
                                           ((32, 32, 31), ("fcube", "scube"))], ids=str)
def test_field_stream_through_the_pallas_engine(shape, kernels):
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.core.temporal import TemporalCodec, TemporalConfig

    dev = _cuda()
    frames = _evolving(shape, 6)
    codec = TemporalCodec(get_compressor("szlike"),
                          FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas", warm_start=True),
                          TemporalConfig(mode="field", keyframe_interval=3),
                          engine=CorrectionEngine(fft_impl="pallas", device=dev))
    ops = {"rfft_fwd_epilogue": t_rfft, "unpack_sclip": t_rfft, "fcube": t_fcube, "scube": t_scube}
    before = {k: ops[k].launches[k] for k in kernels}
    enc = codec.open_stream()
    for x in frames:
        enc.add_frame(x)
    assert all(ops[k].launches[k] > before[k] for k in kernels)
    assert enc._warm.device.type == "cuda"
    _stream_within_header(codec, enc.finish(), frames)


@pytest.mark.gpu
@pytest.mark.parametrize("block,kernels", [(0, ("rfft_fwd_epilogue_rows", "unpack_sclip_rows")),
                                           (255, ("fcube_rows", "scube_rows"))], ids=str)
def test_eeg_stream_through_the_pallas_engine(block, kernels):
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.core.temporal import TemporalCodec, TemporalConfig

    dev = _cuda()
    frames = _evolving((16, 512), 5, white=True)
    codec = TemporalCodec(get_compressor("szlike"),
                          FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas", warm_start=True),
                          TemporalConfig(mode="pencils", keyframe_interval=4, block=block),
                          engine=CorrectionEngine(fft_impl="pallas", device=dev))
    ops = {"rfft_fwd_epilogue_rows": t_rfft, "unpack_sclip_rows": t_rfft, "fcube_rows": t_fcube,
           "scube_rows": t_scube}
    before = {k: ops[k].launches[k] for k in kernels}
    data = codec.compress_stream(frames)
    assert all(ops[k].launches[k] > before[k] for k in kernels)
    _stream_within_header(codec, data, frames)


@pytest.mark.gpu
def test_service_depths_are_byte_identical_on_the_card():
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.core.temporal import TemporalConfig
    from repro_torch.serving import FFCzService, ServiceConfig

    dev = _cuda()
    rng = np.random.default_rng(3)
    fields = [rng.standard_normal((64, 64)).astype(np.float32).cumsum(axis=0) for _ in range(3)]
    pencils = [rng.standard_normal(int(n)).astype(np.float32) for n in rng.integers(500, 5000, 6)]
    frames = _evolving((32, 32), 3)
    runs = []
    for depth in (1, 2):
        svc = FFCzService(get_compressor("szlike"), engine=CorrectionEngine(fft_impl="pallas", device=dev),
                          config=ServiceConfig(max_batch=4, block=256, pipeline_depth=depth))
        cfg = FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas", crc=True)
        for x in fields:
            svc.submit_compress(x, cfg)
        for x in pencils:
            svc.submit_pencils(x, 1e-3, 1e-3)
        svc.submit_stream(frames, cfg, TemporalConfig(mode="field", keyframe_interval=2))
        res = svc.drain()
        svc.close()
        assert all(r.ok and not r.stats.rungs for r in res.values())
        assert all(r.stats.fft_impl == "pallas" for r in list(res.values())[:3])
        runs.append([(u, r.payload, r.stats.attempts, r.stats.converged) for u, r in res.items()])
    assert runs[0] == runs[1]


@pytest.mark.gpu
def test_server_cli_serves_through_the_kernels_on_the_card(tmp_path):
    """``python -m repro_torch.launch.serve_ffcz`` on the card builds a pallas
    engine and pallas request configs: its fields and pencils launch the
    correction kernels, and a fault-free run takes no rung."""
    import os
    import pathlib
    import re
    import subprocess
    import sys

    _cuda()
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_ffcz", "--requests", "12", "--field-size", "64",
         "--block", "256", "--session-frac", "0.2", "--session-journal-dir", str(tmp_path)],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(root / "src")), cwd=root,
        timeout=600)
    assert out.returncode == 0, out.stderr
    assert "rungs=-" in out.stdout and not re.search(r"rungs=(?!-)", out.stdout)
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("fft_impl="))
    assert line.startswith("fft_impl=pallas")
    for kernel in ("rfft_fwd_epilogue", "unpack_sclip", "rfft_fwd_epilogue_rows", "unpack_sclip_rows"):
        assert re.search(rf"'{kernel}': [1-9]", line), line


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-7b", "llava-next-mistral-7b", "whisper-tiny"])
def test_serve_cli_serves_a_new_family_at_full_width(arch):
    """``python -m repro_torch.launch.serve --arch <id> --preset full`` on
    the card: the published config with random weights, KV compression on,
    every request served with in-vocabulary tokens."""
    import os
    import pathlib
    import re
    import subprocess
    import sys

    _cuda()
    torch.cuda.empty_cache()  # the card's memory to the served model, not to earlier tests' cache
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--preset", "full",
         "--requests", "4", "--max-new-tokens", "4", "--kv-compression"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(root / "src")), cwd=root,
        timeout=900)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    tokens = [int(t) for line in out.stdout.splitlines() if line.startswith("uid=")
              for t in re.findall(r"\d+", line.split(":", 1)[1])]
    assert len(tokens) == 16


def _scored(cfg, params, batch):
    """(loss, flash launches) of one forward on the card, no autograd graph."""
    from repro_torch.models.model import build_model

    with torch.no_grad():
        before = t_flash.launches["flash_attention"]
        loss = float(build_model(cfg, device="cuda").loss(params, batch))
        return loss, t_flash.launches["flash_attention"] - before


@pytest.mark.gpu
def test_llava_layer_at_full_width_on_the_card():
    """One llava-next-mistral-7b layer at full width (d_model 4096, GQA
    32/8, d_ff 14336, vocab 32000) behind the projector, bf16 with the flash
    kernel: 2880 standard-normal patches + 512 tokens; one launch, the loss
    within 1e-3 of naive attention's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    dev = _cuda()
    cfg = get_config("llava-next-mistral-7b", n_layers=1, attention_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg, device=dev).init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 512), generator=gen, device=dev),
             "patches": torch.randn((1, cfg.vision_tokens, cfg.vision_dim), generator=gen, device=dev)}
    loss, launches = _scored(cfg, params, batch)
    other, naive_launches = _scored(dataclasses.replace(cfg, attention_impl="naive"), params, batch)
    assert launches == 1 and naive_launches == 0
    assert np.isfinite(loss) and abs(loss - other) <= 1e-3 * abs(other)


@pytest.mark.gpu
def test_whisper_forward_on_the_card():
    """whisper-tiny at full width and depth (4 + 4 layers, 1500 frames, 448
    decoder tokens): the float32 loss on the card within rtol 1e-5 of the
    CPU's with the same weights and inputs, and the bf16 loss with one flash
    launch a decoder layer within 1e-3 of naive attention's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    dev = _cuda()
    cfg = get_config("whisper-tiny", attention_impl="pallas")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg32, device="cpu").init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 448), generator=gen),
             "frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)}
    with torch.no_grad():
        want = float(build_model(cfg32, device="cpu").loss(params, batch))
    on_card = build_model(cfg32, device=dev).load(params.state_dict())
    batch = {k: v.to(dev) for k, v in batch.items()}
    got, launches = _scored(cfg32, on_card, batch)
    assert launches == cfg.n_layers and abs(got - want) <= 1e-5 * abs(want)

    params16 = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(1))
    loss, launches = _scored(cfg, params16, batch)
    other, _ = _scored(dataclasses.replace(cfg, attention_impl="naive"), params16, batch)
    assert launches == cfg.n_layers and np.isfinite(loss) and abs(loss - other) <= 1e-3 * abs(other)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-7b", "llava-next-mistral-7b",
                                  "whisper-tiny"])
def test_one_training_step_per_family_on_the_card(arch, tmp_path):
    """A SMOKE ``Trainer`` of each new family takes one step on the card
    from the CPU trainer's initial parameters, with FFCz gradient compression
    through a pallas engine (grad_Delta_rel 5e-5, so the correction acts):
    the loss within rtol 1e-5 of the CPU step's (float32; the card's
    products sum in another order), the per-pencil kernels launched: 3p/4p
    for the even pencil lengths, 1p/2p only where a leaf shorter than the
    4096 block keeps an odd length of its own (no leaf of these five does)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import CompressionConfig, get_smoke_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dev = _cuda()
    comp = CompressionConfig(grad_compression=True, grad_Delta_rel=5e-5)
    cfg = dataclasses.replace(get_smoke_config(arch), compression=comp)
    run = dict(seq_len=32, global_batch=2, ckpt_every=100, ckpt_async=False)
    cpu = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "cpu"), **run), device="cpu")
    card = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "card"), **run), device=dev,
                   engine=CorrectionEngine(fft_impl="pallas", device=dev))
    card.params = card.bundle.load(cpu.params.state_dict())
    card.opt_state = card.optimizer.init(card.params.state_dict())
    counters = (t_rfft.launches, t_scube.launches, t_fcube.launches)
    before = {k: v for c in counters for k, v in c.items()}
    want, got = cpu.train(1)["final_loss"], card.train(1)["final_loss"]
    launched = {k: v - before[k] for c in counters for k, v in c.items() if v > before[k]}
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
    assert launched.get("rfft_fwd_epilogue_rows", 0) > 0 and launched.get("unpack_sclip_rows", 0) > 0
    odd = any(min(4096, t.numel()) % 2 for t in tree.leaves(card.state()[0]) if t.numel() >= 2)
    assert (launched.get("fcube_rows", 0) > 0) == (launched.get("scube_rows", 0) > 0) == odd
    assert not {"rfft_fwd_epilogue", "unpack_sclip", "fcube", "scube"} & set(launched), launched


@pytest.mark.gpu
def test_sharded_paths_at_world_size_one(tmp_path):
    """The distribution on one card, through the code the CPU's gloo ranks
    run (tests/test_torch_sharded.py): a one-rank NCCL group, a packed
    sharded compress whose stored bounds hold in float64 and whose
    ``decompress_sharded`` is bitwise ``decompress``, and a pallas sharded
    pencil engine bitwise the batched one, through kernels 3p/4p."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.sharding import ShardedField

    dev = _cuda()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'init'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        x = (1.0 + 0.5 * np.random.default_rng(3).standard_normal((32, 16, 24))).astype(np.float32)
        codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-2, Delta_rel=1e-3, fft_impl="packed"),
                     device=dev)
        blob = codec.compress(ShardedField.shard(x, mesh))
        dec = codec.decompress(blob)
        eps = dec.astype(np.float64) - x
        d = np.fft.rfftn(eps)
        assert blob.stats.converged and np.abs(eps).max() <= blob.E
        assert np.maximum(np.abs(d.real), np.abs(d.imag)).max() <= blob.Delta_scalar
        assert np.array_equal(codec.decompress_sharded(blob, mesh).to_host(), dec)

        rng = np.random.default_rng(7)
        errs = [torch.from_numpy((rng.uniform(-1, 1, n) * E).astype(np.float32)).to(dev)
                for n, E in ((2500, 0.03), (1536, 0.02), (100, 0.05))]
        Es, Ds = [0.03, 0.02, 0.05], [0.03 * 27, 0.02 * 27, 0.05 * 27]
        want = CorrectionEngine(fft_impl="pallas", device=dev).correct(errs, Es, Ds, block=512, return_edits=True)
        before = dict(t_rfft.launches)
        got = CorrectionEngine(backend="sharded", fft_impl="pallas", mesh=mesh).correct(
            errs, Es, Ds, block=512, return_edits=True)
        assert all(t_rfft.launches[k] > before[k] for k in ("rfft_fwd_epilogue_rows", "unpack_sclip_rows"))
        assert _same(got[0], want[0])
        assert all(_same(a, b) for a, b in zip(got[1], want[1]))
        assert _same([got[2].block_iterations, got[2].block_converged],
                     [want[2].block_iterations, want[2].block_converged])
    finally:
        dist.destroy_process_group()
