"""The float32 flash kernel's split-TF32 arithmetic, emulated in plain torch.

``csrc/flash_attention.cu`` computes float32 attention on the tensor cores in
TF32 (10 mantissa bits): each operand is split as ``x = hi + lo`` with
``hi = cvt.rna.tf32.f32(x)`` and ``lo = cvt.rna.tf32.f32(x - hi)``, and each
product is summed as ``hi*hi + hi*lo + lo*hi`` in float32.  The card is the
only place the kernel runs, so these tests hold its design here: an
emulation of ``cvt.rna.tf32.f32`` on float32 bit patterns, checked on its
edge cases against a float64 rounding; attention computed with the split
products within the kernel's bar (3e-5) of ``attention_ref`` at every head
dim the kernel is built for, where one TF32 product misses it; and the
register bookkeeping that feeds P to the second product (the S
accumulator's columns 2t, 2t + 1 read as the A fragment's k = t, t + 4,
with V^T's kv positions permuted alike).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

BAR = 3e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bit patterns: the 13 low mantissa
    bits rounded off to nearest, ties away from zero (half an ulp added to
    the magnitude, then truncated; a carry moves into the exponent, past
    the largest finite value to inf).  Inf and NaN are kept."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    rounded = mag | (bits & torch.tensor(-(2**31), dtype=torch.int32))
    return torch.where(special, bits, rounded).view(torch.float32)


def tf32_reference(x: np.ndarray) -> np.ndarray:
    """The same rounding in float64 arithmetic: |x| to a multiple of its
    TF32 ulp (2^(e - 10) for a normal x in [2^e, 2^(e + 1)), 2^-136 below
    2^-126), ties away from zero."""
    x64 = x.astype(np.float64)
    mag = np.abs(x64)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.where(mag < 2.0**-126, 2.0**-136, 2.0 ** (e - 10))
    with np.errstate(over="ignore"):
        return (np.sign(x64) * np.floor(mag / ulp + 0.5) * ulp).astype(np.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def products(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """``a @ b`` (float32) from TF32 halves: lo*hi + hi*lo + hi*hi, or hi*hi
    alone with ``terms=1``.  Each product of two TF32 values is exact in
    float32."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah @ bh
    if terms == 3:
        out = al @ bh + ah @ bl + out
    return out


def split_attention(q, k, v, causal=True, scale=None, terms=3):
    """Causal GQA attention as the kernel computes it: both products in
    split TF32, the softmax in float32 (materialised here; the kernel's
    online softmax only reorders its sums)."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    group = hq // k.shape[1]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    s = products(q, kq.transpose(-1, -2), terms) * scale
    if causal:
        row = torch.arange(sq)[:, None] + (sk - sq)
        s = s.masked_fill(torch.arange(sk)[None, :] > row, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return products(p, vq, terms) / torch.sum(p, dim=-1, keepdim=True)


def test_rounding_matches_a_float64_rounding_on_random_values():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * np.exp2(rng.integers(-60, 60, 100_000))).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, tf32_reference(x))
    assert not np.any(got.view(np.int32) & 0x1FFF)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["positive", "negative"])
def test_ties_round_away_from_zero(sign):
    # 1 + k ulp(tf32) + half an ulp, exactly representable in float32
    ulp = 2.0**-10
    x = np.array([sign * (1 + k * ulp + ulp / 2) for k in range(8)], dtype=np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.array([sign * (1 + (k + 1) * ulp) for k in range(8)], np.float32))
    # a hair under the tie rounds toward zero
    below = np.nextafter(x, np.float32(0))
    np.testing.assert_array_equal(tf32_rna(torch.from_numpy(below)).numpy(),
                                  np.array([sign * (1 + k * ulp) for k in range(8)], np.float32))


def test_subnormals_round_on_the_same_grid():
    tiny = np.float32(2.0**-149)
    x = np.array([tiny * k for k in (1, 4095, 4096, 4097, 8191, 8192, 12288, 2**23 - 1)], dtype=np.float32)
    x = np.concatenate([x, -x])
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, tf32_reference(x))
    # 4096 * 2^-149 is half of the subnormal TF32 ulp: it rounds up; the
    # largest subnormal carries into the smallest normal
    assert got[2] == np.float32(2.0**-136) and got[7] == np.float32(2.0**-126)


def test_the_largest_values_round_to_the_largest_tf32_or_overflow():
    big = np.finfo(np.float32).max
    tf32_max = np.float32((2 - 2.0**-10) * 2.0**127)
    x = np.array([big, -big, tf32_max, np.nextafter(tf32_max, np.float32(0)),
                  np.float32((2 - 2.0**-10 - 2.0**-11) * 2.0**127)], dtype=np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.array([np.inf, -np.inf, tf32_max, tf32_max, tf32_max], np.float32))


def test_inf_nan_and_signed_zero_pass_through():
    x = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], dtype=np.float32)
    x[2] = np.frombuffer(np.int32(0x7FC00001).tobytes(), np.float32)[0]  # a NaN with a low payload bit
    got = tf32_rna(torch.from_numpy(x)).numpy()
    assert got[0] == np.inf and got[1] == -np.inf and np.isnan(got[2])
    assert got[3] == 0 and not np.signbit(got[3]) and got[4] == 0 and np.signbit(got[4])


def test_a_split_recovers_all_but_the_last_bits():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(10_000).astype(np.float32))
    hi, lo = split(x)
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0**-21
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0**-11


# (b, hq, hkv, sq, sk, causal): a causal prefill with GQA, suffix queries, a
# ragged length, and full (non-causal) attention over more keys than queries
CASES = [(1, 4, 2, 130, 130, True), (1, 4, 2, 16, 200, True), (2, 2, 1, 37, 37, True),
         (1, 2, 2, 40, 77, False)]


@pytest.mark.parametrize("d", [16, 64, 112, 128])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_tf32_attention_is_within_the_kernel_bar(case, d):
    b, hq, hkv, sq, sk, causal = case
    rng = np.random.default_rng(sq * 1000 + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    want = attention_ref(q, k, v, causal=causal)
    assert float((split_attention(q, k, v, causal=causal) - want).abs().max()) <= BAR


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_product_misses_the_bar(d):
    """Why three products: hi*hi alone (plain TF32) is ~2^-11 relative per
    product, far past 3e-5 at the forward loss's widths."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 130, d), (1, 2, 130, d), (1, 2, 130, d)))
    want = attention_ref(q, k, v)
    assert float((split_attention(q, k, v, terms=1) - want).abs().max()) > 10 * BAR


def vt_source_position(x: int) -> int:
    """csrc/flash_attention.cu's prologue: position x of a transposed V row
    holds kv position ``from`` (0 2 4 6 1 3 5 7 within each group of 8)."""
    return (x & ~7) | ((x & 3) << 1) | ((x >> 2) & 1)


def test_the_p_fragment_against_the_permuted_v_is_p_times_v():
    """One warp's 16 rows by one 8-column k-step.  The wgmma accumulator
    gives thread (g = lane / 4, t = lane % 4) the values c[i] at row
    g + 8 (i >> 1 & 1), column 2t + (i & 1); the kernel passes
    {c[0], c[2], c[1], c[3]} as the A fragment, whose registers sit at
    (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B is V^T with its kv
    positions permuted by the prologue.  A @ B must be P @ V."""
    rng = np.random.default_rng(2)
    n = 24
    p = rng.standard_normal((16, 8))
    v = rng.standard_normal((8, n))
    a = np.zeros((16, 8))
    for g in range(8):
        for t in range(4):
            c = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1]]
            frag = [c[0], c[2], c[1], c[3]]
            a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = frag
    assert sorted(vt_source_position(x) for x in range(32)) == list(range(32))
    b = np.stack([v[vt_source_position(x)] for x in range(8)])  # B[k][n] = V^T permuted
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-12, atol=1e-12)
