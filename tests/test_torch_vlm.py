"""The port's llava (vlm family: the dense Mistral backbone behind a patch
projector) against the reference's, on the CPU, at llava-next-mistral-7b
SMOKE (2 layers, 16 vision tokens of width 32, float32).

Tolerances are those of ``test_torch_lm_parity.py`` (loss rtol 1e-5;
prefill and decode logits atol 1e-4; served tokens equal where the
reference's top-2 margin exceeds 1e-3; round trips bitwise); the projector
alone: rtol 1e-5, atol 1e-6 (float32 products summed in another order).

The reference's ``ServingEngine`` cannot serve this family: it sizes the
cache for the prompt and the new tokens only, and the prefill writes the
vision tokens too (ROADMAP.md Queue 3, reference caveat (c)).  The served
tokens are therefore held against a greedy loop over the reference's
bundle that sizes the cache for the vision tokens as well, and one test
pins the reference's fault.
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
from repro.models.model import build_model as r_build_model
from repro.serving.engine import ServeConfig as RServeConfig
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.models import model as t_model
from repro_torch.serving.engine import ServeConfig, ServingEngine

ARCH = "llava-next-mistral-7b"
IMPLS = ["naive", "xla_flash", "pallas"]


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_is_the_references(preset):
    ours = get_config(ARCH) if preset == "full" else get_smoke_config(ARCH)
    theirs = r_get_config(ARCH) if preset == "full" else r_get_smoke_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "resolved_head_dim"):
        assert getattr(ours, prop) == getattr(theirs, prop)


def test_published_model_is_mistral_7b_behind_the_projector():
    model = t_model.VLMLM(get_config(ARCH), device="meta")
    assert len(model.layers) == 32
    assert model.layers[0].attn.wqkv.shape == (4096, 48, 128)  # GQA: 32 + 2 * 8 heads of 128
    assert model.projector.w1.shape == (1024, 4096) and model.projector.w2.shape == (4096, 4096)
    assert model.projector.w1.dtype == torch.float32 and model.layers[0].attn.wqkv.dtype == torch.bfloat16
    n = sum(p.numel() for p in model.parameters())
    assert 7.2e9 < n < 7.3e9


# ---------------------------------------------------------------------------
# the projector


def test_projector_matches_reference():
    """``gelu(patches @ w1) @ w2`` with the reference's tanh GELU (the
    reference computes it inline in its ``inputs_from_batch``)."""
    rcfg, cfg = lm.configs(ARCH)
    params_np = lm.ref_params(rcfg)
    w1, w2 = (params_np["projector"][k] for k in ("w1", "w2"))
    patches = lm.stubs(cfg)["patches"]
    want = np.asarray(jax.nn.gelu(jnp.asarray(patches) @ jnp.asarray(w1)) @ jnp.asarray(w2))
    _, model = lm.port_model(cfg, params_np)
    with torch.no_grad():
        got = model.projector(torch.from_numpy(patches), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_projected_patches_come_before_the_tokens():
    """The backbone's input is the projected patches, then the tokens'
    embeddings: a prefill's first ``vision_tokens`` cache rows are the
    patches' K/V, whatever the tokens."""
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    v = cfg.vision_tokens
    caches = []
    for seed in (1, 2):
        toks = lm.tokens(cfg, b=1, s=6, seed=seed)
        _, cache = bundle.prefill(params, lm.batch(cfg, toks), bundle.init_cache(1, v + 6))
        caches.append(cache)
    assert caches[0]["pos"] == v + 6
    assert torch.equal(caches[0]["k"][:, :, :, :v], caches[1]["k"][:, :, :, :v])
    assert not torch.equal(caches[0]["k"][:, :, :, v:], caches[1]["k"][:, :, :, v:])


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_matches_reference(impl):
    lm.check_loss(ARCH, attention_impl=impl)


def test_kernel_runs_once_a_layer_over_patches_and_tokens():
    cfg = get_smoke_config(ARCH, attention_impl="pallas")
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    calls = []
    real = t_flash.attention_ref
    t_flash.attention_ref = lambda *a, **kw: calls.append((a[0].shape, a[1].shape)) or real(*a, **kw)
    try:
        with torch.no_grad():
            bundle.loss(params, lm.batch(cfg, lm.tokens(cfg)))
    finally:
        t_flash.attention_ref = real
    s = cfg.vision_tokens + 40
    hd = cfg.resolved_head_dim
    assert calls == [((2, cfg.n_heads, s, hd), (2, cfg.n_kv_heads, s, hd))] * cfg.n_layers


def test_prefill_and_decode_match_reference():
    """Both sides get a cache of vision_tokens + prompt + new entries."""
    rc, tc = lm.check_prefill_decode(ARCH)
    assert tc["pos"] == get_smoke_config(ARCH).vision_tokens + 15
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), atol=1e-4)


def test_incremental_equals_full():
    lm.check_incremental_equals_full(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    model = lm.check_round_trip(ARCH, dtype)
    assert {"projector.w1", "projector.w2"} <= set(model.state_dict())
    assert model.projector.w1.dtype == torch.float32  # param_dtype, as the reference's


def test_compress_cache_of_the_vlm_cache():
    got, cache = lm.check_compress_nested_cache(ARCH)
    assert got["pos"] == cache["pos"] == get_smoke_config(ARCH).vision_tokens + 40


def test_gradients_are_finite_and_reach_the_projector():
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    loss = bundle.loss(params, lm.batch(cfg, lm.tokens(cfg, s=16)))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params.parameters())
    assert float(params.projector.w1.grad.abs().max()) > 0


def test_bf16_backbone_runs_in_bf16_where_the_reference_promotes():
    """A standing divergence: the reference concatenates the float32
    projector output with the bf16 token embeddings, which promotes its
    whole sequence to float32 (its bf16 prefill returns float32 logits);
    the port casts the projected patches to ``cfg.dtype``, so the backbone
    runs in bf16 as every other family's does."""
    rcfg, cfg = lm.configs(ARCH, dtype="bfloat16")
    params_np = lm.ref_params(rcfg)
    toks = lm.tokens(cfg, b=1, s=6)
    b = lm.batch(cfg, toks)
    n = cfg.vision_tokens + 6
    rl, rc = r_build_model(rcfg).prefill(params_np, lm.jnp_batch(b), r_build_model(rcfg).init_cache(1, n))
    bundle, params = lm.port_model(cfg, params_np)
    tl, tc = bundle.prefill(params, b, bundle.init_cache(1, n))
    assert rl.dtype == jnp.float32 and tl.dtype == torch.bfloat16
    assert rc["k"].dtype == jnp.bfloat16 and tc["k"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# serving


def _prompts(cfg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(rng.integers(3, 14))) for _ in range(n)]


def _reference_greedy(rcfg, params_np, prompts, n_new):
    """The reference's engine loop over its bundle, the cache sized for the
    vision tokens too: front-padded prompts, zero patches, prefill, greedy
    decode.  Returns each step's last logits and the tokens."""
    rb = r_build_model(rcfg)
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), dtype=np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p) :] = p
    batch = {"tokens": jnp.asarray(toks),
             "patches": jnp.zeros((len(prompts), rcfg.vision_tokens, rcfg.vision_dim), jnp.float32)}
    cache = rb.init_cache(len(prompts), rcfg.vision_tokens + plen + n_new)
    logits, cache = rb.prefill(params_np, batch, cache)
    logs, outs = [np.asarray(logits[:, -1], dtype=np.float32)], [jnp.argmax(logits[:, -1], axis=-1)]
    for _ in range(n_new - 1):
        logits, cache = rb.decode(params_np, outs[-1][:, None], cache)
        logs.append(np.asarray(logits[:, -1], dtype=np.float32))
        outs.append(jnp.argmax(logits[:, -1], axis=-1))
    return logs, np.stack([np.asarray(o) for o in outs], axis=1)


def test_serving_matches_a_greedy_loop_over_the_reference():
    rcfg, cfg = lm.configs(ARCH)
    params_np = lm.ref_params(rcfg)
    prompts = _prompts(cfg)
    eng = ServingEngine(cfg, ServeConfig(max_batch=2), params=convert.lm_params_from_reference(params_np, cfg),
                        device="cpu")
    t_logs = lm._record(eng)
    for p in prompts:
        eng.submit(p, max_new_tokens=5)
    compared = 0
    for start in (0, 2):
        r_logs, r_toks = _reference_greedy(rcfg, params_np, prompts[start : start + 2], 5)
        n_logs = len(t_logs)
        out = eng.step()
        assert [o["uid"] for o in out] == [start + 1, start + 2]
        diverged = set()
        for step, (rl, tl) in enumerate(zip(r_logs, t_logs[n_logs:])):
            for row in range(2):
                if row in diverged:
                    continue
                np.testing.assert_allclose(tl[row], rl[row], atol=1e-4, rtol=0)
                if out[row]["tokens"][step] != int(r_toks[row, step]):
                    top2 = np.sort(rl[row])[-2:]
                    assert top2[1] - top2[0] <= lm.MARGIN, (row, step, top2)
                    diverged.add(row)
                else:
                    compared += 1
        assert len(t_logs) - n_logs == 5
    assert compared >= 10


def test_engine_sizes_the_cache_for_the_vision_tokens():
    cfg = get_smoke_config(ARCH)
    eng = ServingEngine(cfg, ServeConfig(max_batch=2), device="cpu")
    eng.submit(np.arange(1, 6), max_new_tokens=3)
    batch = eng._make_batch(eng.queue)
    assert batch["patches"].shape == (1, cfg.vision_tokens, cfg.vision_dim)
    assert batch["patches"].dtype == torch.float32 and not bool(batch["patches"].any())
    assert eng.cache_len(batch, 3) == cfg.vision_tokens + 5 + 3
    assert len(eng.step()[0]["tokens"]) == 3


def test_reference_engine_cannot_serve_the_vlm_where_the_port_does():
    """Reference caveat (c): ``repro.serving.engine.ServingEngine.step``
    sizes the cache ``prompt + new`` and the vlm prefill writes
    ``vision_tokens + prompt`` entries into it.  When this test fails, the
    reference was fixed: drop the caveat and hold the port's engine
    against the reference's directly."""
    rcfg, cfg = lm.configs(ARCH)
    params_np = lm.ref_params(rcfg)
    prompt = np.arange(1, 9)
    ref = RServingEngine(rcfg, RServeConfig(max_batch=2), params=params_np)
    ref.submit(prompt, max_new_tokens=4)
    with pytest.raises(TypeError, match="dynamic_update_slice update shape must be smaller than operand shape"):
        ref.step()
    eng = ServingEngine(cfg, ServeConfig(max_batch=2), params=convert.lm_params_from_reference(params_np, cfg),
                        device="cpu")
    eng.submit(prompt, max_new_tokens=4)
    assert len(eng.step()[0]["tokens"]) == 4


# ---------------------------------------------------------------------------
# the pipeline's vision stub


def test_pipeline_patches_are_the_references_keys_and_shapes():
    from repro.data.pipeline import pipeline_for as r_pipeline_for

    rcfg, cfg = lm.configs(ARCH)
    seq = cfg.vision_tokens + 24
    got = pipeline_for(cfg, seq, 4, seed=1).batch_at(3)
    want = r_pipeline_for(rcfg, seq, 4, seed=1).batch_at(3)
    assert set(got) == set(want) == {"tokens", "patches"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
    assert got["tokens"].shape == (4, 24) and got["patches"].shape == (4, cfg.vision_tokens, cfg.vision_dim)
    assert got["patches"].dtype == torch.float32
    p = got["patches"].numpy()
    assert abs(p.mean()) < 0.1 and abs(p.std() - 1) < 0.1
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert np.isfinite(float(bundle.loss(params, got)))
