"""The port's attention against the reference's.

The flash-attention wrapper's CPU path (its plain twin, ``ref.attention_ref``)
is held against the reference's Pallas ``flash_attention`` in interpret mode,
as ``tests/test_kernels.py`` runs it, and against the reference's
``attention_ref``.  ``attention_apply`` is held against the reference for
each of the three impls, without a cache and with one (prefill from zero,
chunked prefill, decode), at the same weights.

Tolerance: atol 3e-5 in float32, the reference's own bar between its impls
(``tests/test_attention.py``): both sides sum the same products in another
order.  The CUDA kernel is held against the twin on the card by
``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro.models import attention as r_attn
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import attention_ref as t_attention_ref
from repro_torch.models import attention as t_attn

ATOL = 3e-5
H, HKV, HD, D = 4, 2, 16, 64

# (b, hq, hkv, sq, sk, d): sq == sk lengths of the reference's impl test, a
# suffix (decode-style) case, and GQA groups 1, 2 and 7
FLASH_CASES = [
    (2, 4, 2, 8, 8, 16),
    (2, 4, 2, 37, 37, 16),
    (2, 4, 2, 130, 130, 16),
    (1, 4, 2, 1030, 1030, 16),
    (2, 4, 2, 16, 300, 16),
    (1, 3, 3, 45, 45, 64),
    (1, 14, 2, 70, 70, 64),
    (1, 14, 2, 20, 150, 64),
]


def _qkv(case, seed=0):
    b, hq, hkv, sq, sk, d = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_twin_matches_reference(case):
    q, k, v = _qkv(case)
    before = dict(t_flash.launches)
    got = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    assert t_flash.launches == before  # the twin is no launch
    pallas = np.asarray(r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))  # interpret mode
    oracle = np.asarray(r_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert got.shape == pallas.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)


def test_flash_twin_non_causal_and_scale():
    q, k, v = _qkv((1, 4, 2, 24, 24, 16), seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = t_attention_ref(tq, tk, tv, causal=False, scale=0.3).numpy()
    want = np.asarray(r_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, scale=0.3))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_flash_rejects_prefix_queries():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 2, 9, 4, 16)))
    with pytest.raises(ValueError, match="sq <= sk"):
        t_flash.flash_attention(q, k, v)


@pytest.fixture(scope="module")
def params():
    """Reference weights (with a nonzero QKV bias) and their torch copy."""
    p = r_attn.attention_init(jax.random.PRNGKey(0), D, H, HKV, HD, True, jnp.float32)
    rng = np.random.default_rng(11)
    p["bqkv"] = jnp.asarray(rng.standard_normal(p["bqkv"].shape).astype(np.float32) * 0.1)
    return p, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}


def _both(params, x, impl, r_cache=None, t_cache=None, **kw):
    rp, tp = params
    kw = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, impl=impl, **kw)
    ro, rc = r_attn.attention_apply(rp, jnp.asarray(x), cache=r_cache, **kw)
    to, tc = t_attn.attention_apply(tp, torch.from_numpy(x), cache=t_cache, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=ATOL, rtol=0)
    return rc, tc


IMPLS = ["naive", "xla_flash", "pallas"]


@pytest.mark.parametrize("s", [8, 37, 130, 1030])
@pytest.mark.parametrize("impl", IMPLS)
def test_attention_apply_cacheless(impl, s, params):
    x = np.random.default_rng(s).standard_normal((2, s, D)).astype(np.float32)
    _both(params, x, impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_attention_apply_causal_scheduling_off(impl, params):
    x = np.random.default_rng(5).standard_normal((1, 700, D)).astype(np.float32)
    _both(params, x, impl, causal_scheduling=False)


def _caches(b, S):
    return (r_attn.init_kv_cache(b, HKV, S, HD, jnp.float32),
            t_attn.init_kv_cache(b, HKV, S, HD, torch.float32))


def _same_cache(rc, tc):
    assert int(rc["pos"]) == tc["pos"]
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_attention_apply_prefill_then_decode(impl, params):
    """Whole-prompt prefill (the flash branch for s > 8, unless naive), then
    single-token decode steps (the naive branch over the cache)."""
    x = np.random.default_rng(1).standard_normal((2, 29, D)).astype(np.float32)
    rc, tc = _caches(2, 32)
    rc, tc = _both(params, x[:, :26], impl, rc, tc, from_zero=True)
    _same_cache(rc, tc)
    for t in range(26, 29):
        rc, tc = _both(params, x[:, t : t + 1], impl, rc, tc)
    _same_cache(rc, tc)


@pytest.mark.parametrize("impl", IMPLS)
def test_attention_apply_chunked_prefill(impl, params):
    """Prefill at a cache position (the dynamic trip-count branch)."""
    x = np.random.default_rng(2).standard_normal((1, 40, D)).astype(np.float32)
    rc, tc = _caches(1, 40)
    rc, tc = _both(params, x[:, :25], impl, rc, tc)
    rc, tc = _both(params, x[:, 25:], impl, rc, tc)
    _same_cache(rc, tc)
    assert tc["pos"] == 40


def test_xla_flash_trip_counts_match_causal_skip():
    """With causal scheduling, q block i visits kv blocks 0 .. last_row // block_k."""
    calls = []
    real = torch.einsum

    def counting(eq, *ops):
        if eq == "bhqd,bhkd->bhqk":
            calls.append(ops[1].shape[2])
        return real(eq, *ops)

    q = torch.zeros((1, 2, 300, 16))
    k = torch.zeros((1, 1, 300, 16))
    torch.einsum, saved = counting, torch.einsum
    try:
        t_attn._attend_xla_flash(q, k, k, causal=True, kv_offset=0, scale=0.25, block_q=128, block_k=64)
    finally:
        torch.einsum = saved
    # q blocks end at rows 127, 255, 299 (padded to 383): 2, 4 and 5 kv blocks
    assert len(calls) == 2 + 4 + 5


def test_mesh_axes_raise(params):
    """``mesh_axes`` are layout hints: full parameters under a "model" axis
    of 2 (no tensor-parallel context) give the hint-free result bitwise,
    with a cache and without."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 12, D)).astype(np.float32))
    kw = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD)
    for impl in IMPLS:
        plain, _ = t_attn.attention_apply(params[1], x, impl=impl, **kw)
        hinted, _ = t_attn.attention_apply(params[1], x, impl=impl, mesh_axes=(("data", 1), ("model", 2)), **kw)
        assert torch.equal(plain, hinted), impl
    caches = [t_attn.init_kv_cache(2, HKV, 16, HD, torch.float32) for _ in range(2)]
    plain, _ = t_attn.attention_apply(params[1], x, cache=caches[0], from_zero=True, **kw)
    hinted, _ = t_attn.attention_apply(params[1], x, cache=caches[1], from_zero=True,
                                       mesh_axes=(("model", 2),), **kw)
    assert torch.equal(plain, hinted) and torch.equal(caches[0]["k"], caches[1]["k"])
