"""The port's LM layers, configs and dense model against the reference's.

Tolerances:
  * rmsnorm, apply_rope, cross-entropy: rtol 1e-6 in float32 (the same
    float32 formula; libm and XLA may round rsqrt, sin/cos and the
    logsumexp's exp differently in the last place).  For apply_rope the
    1e-6 is relative to the input's scale as well (atol 1e-6 * max|x|):
    XLA's CPU sin/cos differ from libm's by one ulp on some angles, and a
    rotation that cancels to a small output keeps that absolute error.
  * swiglu: rtol 1e-5, atol 1e-6 (a float32 matrix product summed in
    another order).
  * ModelBundle.loss at qwen2-0.5b SMOKE (float32): loss rtol 1e-5 and
    logits atol 1e-4, for each attention impl; with ``attention_impl=
    "pallas"`` the reference runs its Pallas kernel in interpret mode and
    the port its wrapper's twin.  Two layers of float32 products summed in
    another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_parity as lm
from repro.configs import ArchConfig as RArchConfig
from repro.configs import CompressionConfig as RCompressionConfig
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import layers as r_layers
from repro.models import model as r_model
from repro.models import transformer as r_tf
from repro_torch import convert
from repro_torch.configs import (
    ARCH_IDS,
    PORTED_ARCH_IDS,
    SHAPES,
    ArchConfig,
    CompressionConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model

ARCH = "qwen2-0.5b"
IMPLS = ["naive", "xla_flash", "pallas"]


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("ours, theirs", [(ArchConfig, RArchConfig), (CompressionConfig, RCompressionConfig)])
def test_config_fields_are_the_references(ours, theirs):
    a = [(f.name, f.default) for f in dataclasses.fields(ours)]
    b = [(f.name, f.default) for f in dataclasses.fields(theirs)]
    assert a == b


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_qwen2_config_copied(preset):
    ours = get_config(ARCH) if preset == "full" else get_smoke_config(ARCH)
    theirs = r_get_config(ARCH) if preset == "full" else r_get_smoke_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "resolved_head_dim"):
        assert getattr(ours, prop) == getattr(theirs, prop)


def test_full_width_is_the_published_config():
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.resolved_head_dim, c.d_ff) == (24, 896, 14, 2, 64, 4864)
    assert c.vocab == c.vocab_padded == 151936 and c.qkv_bias and c.tie_embeddings
    assert (c.dtype, c.param_dtype) == ("bfloat16", "float32")
    assert get_config(ARCH, n_layers=3).n_layers == 3


@pytest.mark.parametrize("arch", [a for a in PORTED_ARCH_IDS if a != ARCH])
def test_ported_arch_config_is_the_reference(arch):
    """The dense, moe, ssm and hybrid archs: full and SMOKE configs are the
    reference's, field for field."""
    for ours, theirs in ((get_config(arch), r_get_config(arch)),
                         (get_smoke_config(arch), r_get_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _trains_a_step(cfg, ckpt_dir):
    """A SMOKE Trainer of ``cfg`` on the CPU takes one step (a vlm's
    seq_len counts its vision positions: 32 leave 16 tokens)."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    run = TrainerConfig(seq_len=32, global_batch=2, ckpt_dir=str(ckpt_dir), ckpt_every=100, ckpt_async=False)
    out = Trainer(cfg, run, device="cpu").train(1)
    assert out["final_step"] == 1 and np.isfinite(out["final_loss"])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_vlm_and_audio_arch_configs_build_and_train(arch, tmp_path):
    """The vlm and audio archs: their configs, full and SMOKE, are the
    reference's field for field, they build, and a SMOKE ``Trainer`` takes
    a step (their training parity is in test_torch_train_families.py)."""
    for ours, theirs in ((get_config(arch), r_get_config(arch)),
                         (get_smoke_config(arch), r_get_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert t_model.build_model(get_smoke_config(arch), device="cpu").cfg.name == arch
    _trains_a_step(get_smoke_config(arch), tmp_path)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-9")


PORTED_FAMILY_ARCH = {"moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b", "hybrid": "zamba2-7b",
                     "vlm": "llava-next-mistral-7b", "audio": "whisper-tiny"}


@pytest.mark.parametrize("family", sorted(PORTED_FAMILY_ARCH))
def test_ported_family_builds(family):
    """moe, ssm, hybrid, vlm and audio build (their parity with the
    reference is in test_torch_{moe,ssm,hybrid,vlm,whisper}.py)."""
    bundle = t_model.build_model(get_smoke_config(PORTED_FAMILY_ARCH[family]), device="cpu")
    assert bundle.cfg.family == family


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_vlm_and_audio_families_train_and_an_unknown_family_raises(family, tmp_path):
    """The vlm and audio families build, score and train (a SMOKE
    ``Trainer`` takes a step); an unknown family raises in ``build_model``
    and in ``lm_class``."""
    cfg = get_smoke_config(PORTED_FAMILY_ARCH[family])
    assert t_model.build_model(cfg, device="cpu").cfg.family == family
    _trains_a_step(cfg, tmp_path)
    with pytest.raises(ValueError, match="unknown family"):
        t_model.build_model(dataclasses.replace(cfg, family=family + "x"), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        t_model.lm_class(dataclasses.replace(cfg, family=family + "x"))


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_model.build_model(get_smoke_config(ARCH))


# ---------------------------------------------------------------------------
# layers


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rmsnorm_matches_reference():
    x, scale = _rand((3, 5, 64), 0), 1.0 + 0.1 * _rand((64,), 1)
    got = t_layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-5).numpy()
    want = np.asarray(r_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("positions_2d", [False, True])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta, positions_2d):
    x = _rand((2, 3, 40, 16), 2)
    pos = np.arange(40, dtype=np.int32) + 7
    if positions_2d:
        pos = np.stack([pos, pos + 100])
    got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = np.asarray(r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # XLA's CPU sin/cos and libm's differ by an ulp on some angles, and a
    # rotation can cancel to a small value: the bar is rtol 1e-6 of the
    # input's scale, not of each (possibly cancelled) output element
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(x).max()))
    np.testing.assert_array_equal(t_layers.rope_frequencies(16, theta).numpy(),
                                  np.asarray(r_layers.rope_frequencies(16, theta)))


def test_bf16_layers_keep_their_dtype():
    x = torch.from_numpy(_rand((2, 3, 8, 16), 3)).to(torch.bfloat16)
    assert t_layers.apply_rope(x, torch.arange(8), 1e6).dtype == torch.bfloat16
    assert t_layers.rmsnorm(torch.ones(16), x, 1e-5).dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    logits = 3.0 * _rand((2, 9, 50), 4)
    labels = np.random.default_rng(5).integers(0, 50, (2, 9)).astype(np.int32)
    mask = (np.random.default_rng(6).random((2, 9)) > 0.3).astype(np.float32) if masked else None
    got = t_layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if mask is None else torch.from_numpy(mask))
    want = r_layers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                       None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_swiglu_matches_reference():
    p = r_layers.swiglu_init(jax.random.PRNGKey(3), 32, 48, jnp.float32)
    x = _rand((2, 7, 32), 7)
    got = t_layers.swiglu(torch.from_numpy(np.array(p["w_gu"])), torch.from_numpy(np.array(p["w_down"])),
                          torch.from_numpy(x)).numpy()
    want = np.asarray(r_layers.swiglu(p, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# parameters


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, r_model.build_model(cfg).init(jax.random.PRNGKey(seed)))


def _to_reference_tree(state_dict, cfg):
    """The inverse of ``convert.lm_params_from_reference`` (test-side)."""
    def put(tree, path, v):
        for name in path[:-1]:
            tree = tree.setdefault(name, {})
        tree[path[-1]] = v

    def as_np(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()

    tree, layers = {}, {}
    for key, t in state_dict.items():
        path = key.split(".")
        if path[0] == "layers":
            layers.setdefault(int(path[1]), {})[tuple(path[2:])] = as_np(t)
        else:
            put(tree, path, as_np(t))
    for path in layers[0]:
        put(tree, ("layers",) + path, np.stack([layers[i][path] for i in range(cfg.n_layers)]))
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(dtype):
    cfg = get_smoke_config(ARCH, dtype=dtype)
    ref = _ref_params(r_get_smoke_config(ARCH, dtype=dtype))
    sd = convert.lm_params_from_reference(ref, cfg)
    model = t_model.build_model(cfg, device="cpu").load(sd)
    assert model.layers[0].attn.wqkv.dtype == t_layers.dtype_of(dtype)
    assert model.embed.dtype == torch.float32
    back = _to_reference_tree(model.state_dict(), cfg)
    flat_a, tree_a = jax.tree.flatten(ref)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_load_rejects_a_wrong_tree():
    cfg = get_smoke_config(ARCH)
    sd = convert.lm_params_from_reference(_ref_params(r_get_smoke_config(ARCH)), cfg)
    del sd["layers.1.mlp.w_down"]
    with pytest.raises(RuntimeError, match="w_down"):
        t_model.build_model(cfg, device="cpu").load(sd)


def test_init_draws_from_the_generator():
    cfg = get_smoke_config(ARCH)
    b = t_model.build_model(cfg, device="cpu")
    m1 = b.init(torch.Generator().manual_seed(3)).requires_grad_(False)
    m2 = b.init(torch.Generator().manual_seed(3))
    m3 = b.init(torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
    assert not torch.equal(m1.embed, m3.embed)
    ref = _ref_params(r_get_smoke_config(ARCH))
    # the reference's init statistics: embed std 0.02, wqkv std 1/sqrt(d), zero bias, unit norms
    assert abs(float(m1.embed.std()) - float(ref["embed"].std())) < 2e-3
    w = m1.layers[0].attn.wqkv
    assert abs(float(w.std()) - 1 / np.sqrt(cfg.d_model)) < 0.01
    assert float(m1.layers[0].attn.bqkv.abs().max()) == 0.0
    assert float(m1.layers[1].ln_mlp.scale.min()) == 1.0


# ---------------------------------------------------------------------------
# the dense model


def _tokens(cfg, b=2, s=40, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _ref_logits(params, tokens, cfg):
    """The reference's cache-less forward, layer by layer (its loss scans the same blocks)."""
    x = r_model._embed(params, jnp.asarray(tokens), cfg)
    for i in range(cfg.n_layers):
        x, _ = r_tf.dense_block_apply(jax.tree.map(lambda a: a[i], params["layers"]), x, cfg)
    return r_model._logits(params, x, cfg)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_logits_match_reference(impl):
    rcfg = r_get_smoke_config(ARCH, attention_impl=impl)
    cfg = get_smoke_config(ARCH, attention_impl=impl)
    ref_params = _ref_params(rcfg)
    tokens = _tokens(cfg)
    r_loss = float(r_model.build_model(rcfg).loss(ref_params, {"tokens": jnp.asarray(tokens)}))
    r_logits = _ref_logits(ref_params, tokens, rcfg)
    assert abs(float(r_model._lm_loss(r_logits, jnp.asarray(tokens))) - r_loss) <= 1e-6 * abs(r_loss)

    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.load(convert.lm_params_from_reference(ref_params, cfg))
    loss = bundle.loss(params, {"tokens": tokens})
    with torch.no_grad():
        h, _ = params(torch.from_numpy(tokens).long(), cfg)
        logits = t_model._logits(params, h, cfg)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), r_loss, rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=0)


def test_loss_takes_the_kernel_path_once_per_layer():
    """With attention_impl="pallas" every layer calls the wrapper once (on
    the CPU its twin, which counts no launch)."""
    cfg = get_smoke_config(ARCH, attention_impl="pallas")
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    calls = []
    real = t_flash.attention_ref
    t_flash.attention_ref = lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw)
    try:
        bundle.loss(params, {"tokens": _tokens(cfg)})
    finally:
        t_flash.attention_ref = real
    assert calls == [(2, cfg.n_heads, 40, cfg.resolved_head_dim)] * cfg.n_layers


def test_padded_vocab_is_masked():
    cfg = get_smoke_config(ARCH, vocab=250)  # pads to 256
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    rcfg = r_get_smoke_config(ARCH, vocab=250)
    h = torch.from_numpy(_rand((1, 3, cfg.d_model), 9))
    got = t_model._logits(params, h, cfg)
    assert got.shape[-1] == 256 and bool((got[..., 250:] == torch.finfo(torch.float32).min).all())
    ref_p = {"ln_f": {"scale": params.ln_f.scale.detach().numpy()}, "embed": params.embed.detach().numpy()}
    want = np.asarray(r_model._logits(ref_p, jnp.asarray(h.numpy()), rcfg))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(impl):
    """Bundle-level prefill (from zero) and decode against the reference's."""
    rcfg = r_get_smoke_config(ARCH, attention_impl=impl)
    cfg = get_smoke_config(ARCH, attention_impl=impl)
    ref_params = _ref_params(rcfg)
    rb = r_model.build_model(rcfg)
    tb = t_model.build_model(cfg, device="cpu")
    params = tb.load(convert.lm_params_from_reference(ref_params, cfg))
    tokens = _tokens(cfg, b=2, s=12, seed=4)
    rc, tc = rb.init_cache(2, 16), tb.init_cache(2, 16)
    rl, rc = rb.prefill(ref_params, {"tokens": jnp.asarray(tokens)}, rc)
    tl, tc = tb.prefill(params, {"tokens": tokens}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=0)
    for t in range(3):
        nxt = np.full((2, 1), 7 + t, dtype=np.int32)
        rl, rc = rb.decode(ref_params, jnp.asarray(nxt), rc)
        tl, tc = tb.decode(params, nxt, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=0)
    assert tc["pos"] == 15 and int(rc["pos"][0]) == 15


def test_one_set_of_parameters_runs_under_every_impl():
    """The impl comes from the bundle's config, not from the parameters."""
    cfg = get_smoke_config(ARCH)
    params = t_model.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    tokens = _tokens(cfg, s=24)
    losses = [float(t_model.build_model(dataclasses.replace(cfg, attention_impl=i), device="cpu")
                    .loss(params, {"tokens": tokens})) for i in IMPLS]
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# the dense configs beyond qwen2-0.5b (qwen2-7b, granite-3-2b, minitron-4b)

DENSE = ["qwen2-7b", "granite-3-2b", "minitron-4b"]


def test_registry_is_the_references():
    from repro.configs import ARCH_IDS as R_ARCH_IDS
    from repro.configs import SHAPES as R_SHAPES

    assert ARCH_IDS == R_ARCH_IDS and SHAPES == R_SHAPES
    assert PORTED_ARCH_IDS == ARCH_IDS


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_loss_matches_reference(arch):
    lm.check_loss(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_prefill_and_decode_match_reference(arch):
    lm.check_prefill_decode(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_params_round_trip(arch):
    lm.check_round_trip(arch, "float32")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "mamba2-2.7b", "zamba2-7b"])
def test_serve_cli_serves_the_new_families_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as t_serve

    t_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new-tokens", "2",
                  "--kv-compression"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and out.count("uid=") == 3
