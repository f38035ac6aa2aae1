"""The port's whisper encoder-decoder (audio family) against the reference's,
on the CPU, at whisper-tiny SMOKE (2 encoder and 2 decoder layers, 32
frames, float32).

Tolerances (besides those of ``test_torch_lm_parity.py``: loss rtol 1e-5,
logits atol 1e-4, served tokens equal where the reference's top-2 margin
exceeds 1e-3, round trips bitwise):
  * sinusoidal_embed: rtol 1e-6 of the output's scale (atol 1e-6, the
    values are sines): XLA's CPU sin/cos and libm's differ by an ulp on
    some angles.  The float32 power in the frequencies is held bitwise.
  * gelu_mlp: rtol 1e-5, atol 1e-6 (float32 products summed in another
    order; tanh and its argument's rounding in XLA against libm).
  * the blocks and the cross-attention: rtol 1e-5, atol 1e-5 of the
    output's scale (a block of float32 products summed in another order).

The frames and tokens are numpy arrays from a seed, the weights the
reference's ``init`` carried over by ``convert``.  With
``attention_impl="pallas"`` the reference runs its Pallas flash kernel in
interpret mode and the port the kernel's twin; only the decoder's causal
self-attention reaches it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_parity as lm
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import attention as r_attention
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro.models.model import build_model as r_build_model
from repro_torch import convert
from repro_torch.configs import CompressionConfig, get_config, get_smoke_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.models import attention as t_attention
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf

ARCH = "whisper-tiny"
IMPLS = ["naive", "xla_flash", "pallas"]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_is_the_references(preset):
    ours = get_config(ARCH) if preset == "full" else get_smoke_config(ARCH)
    theirs = r_get_config(ARCH) if preset == "full" else r_get_smoke_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "resolved_head_dim"):
        assert getattr(ours, prop) == getattr(theirs, prop)


def test_published_model_is_whisper_tiny():
    model = t_model.WhisperLM(get_config(ARCH), device="meta")
    assert len(model.encoder) == len(model.decoder) == 4
    assert model.decoder[0].self_attn.wqkv.shape == (384, 18, 64)  # MHA: 6 + 2 * 6 heads of 64
    assert model.decoder[0].mlp.w_up.shape == (384, 1536)
    assert not hasattr(model, "lm_head") and model.embed.shape == (51968, 384)  # tied, vocab padded


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("d", [16, 64, 384])
def test_sinusoidal_embed_matches_reference(d):
    pos = np.arange(0, 1600, 3, dtype=np.int32)
    got = t_layers.sinusoidal_embed(torch.from_numpy(pos), d)
    want = np.asarray(r_layers.sinusoidal_embed(jnp.asarray(pos), d))
    assert got.dtype == torch.float32 and got.shape == want.shape == (pos.size, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sinusoidal_positions_match_reference():
    got = t_layers.sinusoidal_positions(50, 32)
    want = np.asarray(r_layers.sinusoidal_positions(50, 32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the table is the run-time embedding at positions 0..49 (float64 angles there)
    np.testing.assert_allclose(t_layers.sinusoidal_embed(torch.arange(50), 32).numpy(), want, atol=2e-6)


def test_gelu_mlp_matches_reference_tanh_gelu():
    p = r_layers.gelu_mlp_init(jax.random.PRNGKey(3), 32, 48, jnp.float32)
    x = _rand((2, 7, 32), 7)
    w_up, w_down = (torch.from_numpy(np.array(p[k])) for k in ("w_up", "w_down"))
    got = t_layers.gelu_mlp(w_up, w_down, torch.from_numpy(x)).numpy()
    want = np.asarray(r_layers.gelu_mlp(p, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # jax.nn.gelu's default is the tanh form; torch's exact default is not within the bar
    exact = (torch.nn.functional.gelu(torch.from_numpy(x) @ w_up) @ w_down).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_gelu_mlp_module_init_and_state():
    mlp = t_layers.GeluMLP(32, 48, torch.float32)
    mlp.init_(torch.Generator().manual_seed(0))
    assert set(mlp.state_dict()) == {"w_up", "w_down"}
    assert mlp(torch.zeros(3, 32)).shape == (3, 32)


def _block_params(init, seed, cfg):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


def _load(module, params_np):
    sd = convert.lm_params_from_reference(params_np, get_smoke_config(ARCH))
    module.load_state_dict(sd, strict=True)
    return module


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_encoder_block_matches_reference():
    rcfg, cfg = lm.configs(ARCH)
    p = _block_params(r_tf.encoder_block_init, 4, rcfg)
    x = _rand((2, cfg.encoder_seq, cfg.d_model), 5)
    want = np.asarray(r_tf.encoder_block_apply(p, jnp.asarray(x), rcfg))
    block = _load(t_tf.EncoderBlock(cfg), p)
    with torch.no_grad():
        got = block(torch.from_numpy(x), cfg).numpy()
    _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_decoder_xblock_matches_reference(impl):
    """Causal self-attention (at ``impl``), cross-attention over the
    encoder's K/V (``cross_kv_from_encoder``), GELU MLP; cache-less."""
    rcfg, cfg = lm.configs(ARCH, attention_impl=impl)
    p = _block_params(r_tf.decoder_xblock_init, 6, rcfg)
    enc = _rand((2, cfg.encoder_seq, cfg.d_model), 7)
    x = _rand((2, 11, cfg.d_model), 8)
    rkv = r_tf.cross_kv_from_encoder(p, jnp.asarray(enc), rcfg)
    want, _ = r_tf.decoder_xblock_apply(p, jnp.asarray(x), rkv, rcfg)
    block = _load(t_tf.DecoderXBlock(cfg), p)
    with torch.no_grad():
        tkv = t_tf.cross_kv_from_encoder(block, torch.from_numpy(enc), cfg)
        for t, r in zip(tkv, rkv):
            assert t.shape == r.shape == (2, cfg.n_kv_heads, cfg.encoder_seq, cfg.resolved_head_dim)
            _close(t.numpy(), np.asarray(r))
        got, cache = block(torch.from_numpy(x), tkv, cfg)
    assert cache is None
    _close(got.numpy(), np.asarray(want))


def test_decoder_xblock_with_a_cache_matches_reference():
    """Prefill 9 tokens into a cache of 12, then one decode step."""
    rcfg, cfg = lm.configs(ARCH)
    p = _block_params(r_tf.decoder_xblock_init, 9, rcfg)
    enc = _rand((1, cfg.encoder_seq, cfg.d_model), 10)
    x = _rand((1, 10, cfg.d_model), 11)
    rkv = r_tf.cross_kv_from_encoder(p, jnp.asarray(enc), rcfg)
    block = _load(t_tf.DecoderXBlock(cfg), p)
    hd = cfg.resolved_head_dim
    rc = r_attention.init_kv_cache(1, cfg.n_kv_heads, 12, hd, jnp.float32)
    tc = t_attention.init_kv_cache(1, cfg.n_kv_heads, 12, hd, torch.float32)
    with torch.no_grad():
        tkv = t_tf.cross_kv_from_encoder(block, torch.from_numpy(enc), cfg)
        for sl, fz in ((slice(0, 9), True), (slice(9, 10), False)):
            want, rc = r_tf.decoder_xblock_apply(p, jnp.asarray(x[:, sl]), rkv, rcfg, cache=rc, from_zero=fz)
            got, tc = block(torch.from_numpy(x[:, sl]), tkv, cfg, cache=tc, from_zero=fz)
            _close(got.numpy(), np.asarray(want))
    assert tc["pos"] == int(rc["pos"]) == 10
    _close(tc["k"].numpy(), np.asarray(rc["k"]))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_cross_attention_matches_reference(heads, impl):
    """``attention_apply(cross_kv=...)``: q only, non-causal over all of the
    precomputed (k, v), naive under every impl (the kernel is causal only)."""
    hq, hkv = heads
    d, hd, s, se = 32, 8, 5, 13
    p = jax.tree.map(np.array, r_attention.attention_init(jax.random.PRNGKey(1), d, hq, hkv, hd, True, jnp.float32))
    p["bqkv"] = _rand(p["bqkv"].shape, 2)
    x, k, v = _rand((2, s, d), 3), _rand((2, hkv, se, hd), 4), _rand((2, hkv, se, hd), 5)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, impl=impl, pos_type="none")
    want, _ = r_attention.attention_apply({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                                          cross_kv=(jnp.asarray(k), jnp.asarray(v)), **kw)
    calls = []
    real = t_flash.attention_ref
    t_flash.attention_ref = lambda *a, **k_: calls.append(1) or real(*a, **k_)
    try:
        got, cache = t_attention.attention_apply({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                                                 cross_kv=(torch.from_numpy(k), torch.from_numpy(v)), **kw)
    finally:
        t_flash.attention_ref = real
    assert cache is None and not calls
    _close(got.numpy(), np.asarray(want))


def test_qkv_slices_are_the_references():
    p = r_attention.attention_init(jax.random.PRNGKey(0), 16, 4, 2, 8, False, jnp.float32)
    want = r_attention.qkv_slices(p, 4, 2, 8)
    got = t_attention.qkv_slices({"wqkv": torch.from_numpy(np.asarray(p["wqkv"]))}, 4, 2, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_matches_reference(impl):
    lm.check_loss(ARCH, attention_impl=impl)


def test_kernel_runs_once_a_decoder_layer_and_never_in_the_encoder():
    """Under ``pallas`` the loss calls the flash wrapper once a decoder layer
    at the decoder's (b, h, s, hd); the encoder and the cross-attention run
    naive."""
    cfg = get_smoke_config(ARCH, attention_impl="pallas")
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    calls = []
    real = t_flash.attention_ref
    t_flash.attention_ref = lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw)
    try:
        with torch.no_grad():
            bundle.loss(params, lm.batch(cfg, lm.tokens(cfg)))
    finally:
        t_flash.attention_ref = real
    assert calls == [(2, cfg.n_heads, 40, cfg.resolved_head_dim)] * cfg.n_layers


def test_prefill_and_decode_match_reference():
    rc, tc = lm.check_prefill_decode(ARCH)
    assert set(tc) == set(rc) == {"self", "cross"}
    assert tc["self"]["pos"] == 15 and set(tc["self"]) == {"k", "v", "pos"}
    assert isinstance(tc["cross"], tuple) and len(tc["cross"]) == 2
    for t, r in zip(tc["cross"], rc["cross"]):
        assert t.shape == r.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=1e-5 * float(np.abs(np.asarray(r)).max()))
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["self"][k].numpy(), np.asarray(rc["self"][k]), atol=1e-4)


def test_init_cache_is_the_references_layout():
    rcfg, cfg = lm.configs(ARCH)
    want = r_build_model(rcfg).init_cache(3, 20)
    got = t_model.build_model(cfg, device="cpu").init_cache(3, 20)
    for k in ("k", "v"):
        assert tuple(got["self"][k].shape) == want["self"][k].shape and got["self"][k].dtype == torch.float32
    assert [tuple(t.shape) for t in got["cross"]] == [t.shape for t in want["cross"]]
    assert got["self"]["pos"] == 0


@pytest.mark.parametrize("kv_compression", [False, True])
def test_serving_matches_reference(kv_compression):
    lm.check_serving(ARCH, kv_compression=kv_compression)


def test_incremental_equals_full():
    lm.check_incremental_equals_full(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    model = lm.check_round_trip(ARCH, dtype)
    assert len(model.encoder) == len(model.decoder) == 2
    keys = model.state_dict()
    assert "decoder.1.cross_attn.wqkv" in keys and "encoder.0.mlp.w_up" in keys and "lm_head" not in keys


def test_blocks_keep_cfg_dtype_and_the_head_param_dtype():
    """The reference creates the encoder and decoder blocks in ``cfg.dtype``
    (not ``param_dtype``), the embedding in ``param_dtype``."""
    cfg = get_smoke_config(ARCH, dtype="bfloat16")
    model = t_model.WhisperLM(cfg, device="meta")
    assert model.embed.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters() if n.startswith(("encoder", "decoder")))


def test_convert_rejects_a_tree_of_another_depth():
    rcfg, cfg = lm.configs(ARCH)
    with pytest.raises(ValueError, match="stacked axis"):
        convert.lm_params_from_reference(lm.ref_params(rcfg), dataclasses.replace(cfg, encoder_layers=3))


def test_compress_cache_compresses_self_and_leaves_cross():
    """The reference compresses the ``self`` k/v leaves only (``cross`` is a
    tuple, whose path has no ``k``/``v`` key); so does the port."""
    got, cache = lm.check_compress_nested_cache(ARCH)
    assert got["cross"] is cache["cross"] and got["self"]["pos"] == cache["self"]["pos"] == 40
    assert list(lm.kv_paths(cache)) == [("self", "k"), ("self", "v")]


def test_serving_compresses_only_the_self_leaves():
    """In the engine: the compressed cache's ``cross`` tensors are prefill's."""
    cfg = get_smoke_config(ARCH, compression=CompressionConfig(kv_cache_compression=True))
    from repro_torch.serving import engine as serving_engine
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    eng = ServingEngine(cfg, ServeConfig(max_batch=2), device="cpu")
    seen = []
    real = serving_engine.compress_cache

    def spy(cache, comp, **kw):
        out = real(cache, comp, **kw)
        seen.append((cache, out))
        return out

    serving_engine.compress_cache = spy
    try:
        eng.submit(np.arange(5), max_new_tokens=3)
        out = eng.step()
    finally:
        serving_engine.compress_cache = real
    assert len(out[0]["tokens"]) == 3 and len(seen) == 1
    before, after = seen[0]
    assert after["cross"] is before["cross"] and not torch.equal(after["self"]["k"], before["self"]["k"])


def test_gradients_are_finite():
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    loss = bundle.loss(params, lm.batch(cfg, lm.tokens(cfg, s=16)))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params.parameters())


# ---------------------------------------------------------------------------
# the pipeline's audio stub


def test_pipeline_frames_are_the_references_keys_and_shapes():
    from repro.data.pipeline import pipeline_for as r_pipeline_for

    rcfg, cfg = lm.configs(ARCH)
    got = pipeline_for(cfg, 24, 4, seed=1).batch_at(3)
    want = r_pipeline_for(rcfg, 24, 4, seed=1).batch_at(3)
    assert set(got) == set(want) == {"tokens", "frames"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
    assert got["frames"].dtype == torch.float32 and got["tokens"].dtype == torch.int32
    assert got["frames"].shape == (4, cfg.encoder_seq, cfg.d_model)
    # standard normal draws (the reference's distribution, not its stream)
    f = got["frames"].numpy()
    assert abs(f.mean()) < 0.1 and abs(f.std() - 1) < 0.1
    assert torch.equal(got["frames"], pipeline_for(cfg, 24, 4, seed=1).batch_at(3)["frames"])


def test_the_pipelines_batch_scores():
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        loss = bundle.loss(params, pipeline_for(cfg, 24, 2).batch_at(0))
    assert np.isfinite(float(loss))
