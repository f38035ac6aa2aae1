"""FFCz KV-cache compression in the port against the reference.

``compress_kv_tensor`` / ``compress_cache`` quantize K/V along the sequence
axis and correct the quantization error through ``CorrectionEngine.correct``.
The reference's own KV tests are replayed on the port with their
tolerances (spatial bound within ``E * 1.001``, frequency bound within
``Delta * 1.01``), and the port's compressed caches are held against the
reference's on the same inputs:

* bitwise where every pencil is already inside both cubes at the first check
  (the defaults: ``Delta = 1e-2 * block * E`` is far above the quantization
  error's spectrum, so the correction leaves the quantized values as they
  are, and the quantizer's float32 arithmetic is the reference's);
* within 1e-6 of the cache's scale where the loop corrects (a tight
  ``kv_Delta_rel``): the two packages' float32 FFTs round differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CompressionConfig as RCompressionConfig
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models.model import build_model as r_build_model
from repro_torch import convert
from repro.serving.kv_compress import compress_cache as r_compress_cache
from repro.serving.kv_compress import compress_kv_tensor as r_compress_kv_tensor
from repro_torch.configs import CompressionConfig, get_smoke_config
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.kv_compress import compress_cache, compress_kv_tensor

ARCH = "qwen2-0.5b"


def _cpu(impl="xla", backend="batched"):
    return CorrectionEngine(backend=backend, fft_impl=impl, device="cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dual_bounds(rng, impl):
    kv = rng.standard_normal((2, 2, 256, 16)).astype(np.float32)
    out = compress_kv_tensor(torch.from_numpy(kv), bits=8, E_rel=1e-2, Delta_rel=1e-2, block=256,
                             engine=_cpu(impl))
    err = out.numpy().astype(np.float64) - kv
    E = 1e-2 * np.abs(kv).max()
    assert np.abs(err).max() <= E * 1.001
    errt = np.swapaxes(err, 2, 3).reshape(-1, 256)
    d = np.fft.fft(errt, axis=-1)
    Delta = 1e-2 * 256 * E
    assert max(np.abs(d.real).max(), np.abs(d.imag).max()) <= Delta * 1.01
    want = r_compress_kv_tensor(jnp.asarray(kv), bits=8, E_rel=1e-2, Delta_rel=1e-2, block=256)
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_compress_cache_tree(rng):
    cache = {
        "k": torch.from_numpy(rng.standard_normal((3, 2, 2, 64, 16)).astype(np.float32)),
        "v": torch.from_numpy(rng.standard_normal((3, 2, 2, 64, 16)).astype(np.float32)),
        "pos": 64,
    }
    keep = {k: v.clone() for k, v in cache.items() if k != "pos"}
    comp = CompressionConfig(kv_cache_compression=True, kv_E_rel=1e-2, kv_Delta_rel=1e-2)
    out = compress_cache(cache, comp, engine=_cpu())
    assert out["pos"] == 64  # untouched
    assert all(torch.equal(cache[k], keep[k]) for k in keep)  # the input is not written
    assert not torch.equal(out["k"], cache["k"])  # lossy
    E = 1e-2 * float(torch.abs(cache["k"]).max())
    assert float(torch.abs(out["k"] - cache["k"]).max()) <= E * 1.01
    assert compress_cache({"pos": 3}, comp) == {"pos": 3}


def test_end_to_end_logit_drift_small():
    """KV compression must barely move the decode logits."""
    comp = CompressionConfig(kv_cache_compression=True, kv_E_rel=1e-3, kv_Delta_rel=1e-2)
    cfg = dataclasses.replace(get_smoke_config(ARCH), compression=comp)
    prompt = np.arange(12) % cfg.vocab
    outs = {}
    for name, c in (("ref", get_smoke_config(ARCH)), ("comp", cfg)):
        eng = ServingEngine(c, ServeConfig(max_batch=1), rng_seed=0, device="cpu")
        eng.submit(prompt, max_new_tokens=4)
        outs[name] = eng.step()[0]["tokens"]
    assert outs["ref"] == outs["comp"], outs


def _smoke_cache(seed=0, batch=2, plen=24, extra=6):
    """A prefilled qwen2-0.5b SMOKE cache from the reference's model, and the
    port's cache from the same parameters (``convert.lm_params_from_reference``)
    and tokens."""
    rcfg = r_get_smoke_config(ARCH)
    bundle = r_build_model(rcfg)
    params = bundle.init(jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(0, rcfg.vocab, (batch, plen)).astype(np.int32)
    cache = bundle.init_cache(batch, plen + extra)
    _, cache = bundle.prefill(params, {"tokens": jnp.asarray(tokens)}, cache)
    cfg = get_smoke_config(ARCH)
    port = build_model(cfg, "cpu")
    tparams = port.load(convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg))
    _, tcache = port.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, port.init_cache(batch, plen + extra))
    return cache, tcache


@pytest.mark.parametrize("Delta_rel", [1e-2, 1e-4])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["local", "batched"])
def test_compress_cache_matches_reference_on_the_smoke_cache(backend, impl, Delta_rel):
    rcache, tcache = _smoke_cache()
    assert rcache["k"].ndim == 5  # (n_layers, b, hkv, S, hd): split into n_layers sub-tensors
    for name in ("k", "v"):  # the port's own prefill gives the same cache up to float32 rounding
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(rcache[name]), atol=1e-5, rtol=0)
    rcomp = RCompressionConfig(kv_cache_compression=True, kv_E_rel=1e-2, kv_Delta_rel=Delta_rel)
    comp = CompressionConfig(kv_cache_compression=True, kv_E_rel=1e-2, kv_Delta_rel=Delta_rel)
    block = 64  # several pencils per sub-tensor at this size
    # both packages compress the reference's cache: a cache value next to a
    # quantizer step boundary would otherwise move a whole step
    want = r_compress_cache(rcache, rcomp, block=block)
    cache = {"k": torch.from_numpy(np.array(rcache["k"])), "v": torch.from_numpy(np.array(rcache["v"])),
             "pos": 24}
    got = compress_cache(cache, comp, block=block, engine=_cpu(impl, backend))
    for name in ("k", "v"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape
        if Delta_rel == 1e-2:
            assert np.array_equal(g, w)
        else:
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, atol=1e-6 * scale, rtol=0)
            assert not np.array_equal(g, np.asarray(rcache[name]))


def test_serving_uses_the_default_engine():
    comp = CompressionConfig(kv_cache_compression=True)
    cfg = dataclasses.replace(get_smoke_config(ARCH), compression=comp)
    eng = ServingEngine(cfg, ServeConfig(max_batch=2), device="cpu")
    eng.submit(np.arange(5), max_new_tokens=3)
    eng.submit(np.arange(9), max_new_tokens=2)
    seen = []
    engine = default_engine("cpu")
    orig = engine.correct
    engine.correct = lambda *a, **k: seen.append(k["block"]) or orig(*a, **k)
    try:
        out = eng.step()
    finally:
        del engine.correct
    assert seen == [1024] and [len(o["tokens"]) for o in out] == [3, 2]
