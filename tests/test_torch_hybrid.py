"""The port's zamba2 hybrid (mamba2 groups around one weight-shared attention
block) against the reference's, on the CPU, at zamba2-7b SMOKE.

Tolerances as in ``test_torch_lm_parity.py``.  The SMOKE config has 4 layers in 2
groups of 2 (``attn_every=2``) and no tail; the published 81 layers at
``attn_every=6`` are 13 groups and a 3-layer mamba tail, so the tail is
held at SMOKE widths with 5 layers (2 groups and a 1-layer tail).  With
``attention_impl="pallas"`` the reference runs its Pallas flash kernel in
interpret mode and the port the kernel's twin, at head_dim 16 here (112 in
the published config, held on the card by ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_lm_parity as lm
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.models import model as t_model

ARCH = "zamba2-7b"
DEPTHS = [{}, {"n_layers": 5}]  # SMOKE; and 2 groups + a 1-layer tail


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_is_the_references(preset):
    ours = get_config(ARCH) if preset == "full" else get_smoke_config(ARCH)
    theirs = r_get_config(ARCH) if preset == "full" else r_get_smoke_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "resolved_head_dim", "d_inner", "ssm_nheads"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.supports_long_context()


def test_published_depth_is_13_groups_and_a_3_layer_tail():
    model = t_model.ZambaLM(get_config(ARCH), device="meta")
    assert len(model.groups) == 13 and len(model.tail) == 3
    assert all(len(g.mamba) == 6 for g in model.groups)
    assert model.shared.attn.wqkv.shape == (3584, 96, 112)  # head_dim 112, MHA (32 + 2 * 32 heads)
    assert model.shared.in_proj.shape == (2 * 3584, 3584)


@pytest.mark.parametrize("impl", ["naive", "xla_flash", "pallas"])
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_loss_matches_reference(depth, impl):
    lm.check_loss(ARCH, attention_impl=impl, **depth)


def test_shared_block_runs_once_a_group_on_the_kernel_path():
    """With attention_impl="pallas" the loss calls the flash wrapper once a
    group (the shared block), with the same weights each time."""
    cfg = get_smoke_config(ARCH, attention_impl="pallas")
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    calls = []
    real = t_flash.attention_ref
    t_flash.attention_ref = lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw)
    try:
        with torch.no_grad():
            bundle.loss(params, {"tokens": lm.tokens(cfg)})
    finally:
        t_flash.attention_ref = real
    assert calls == [(2, cfg.n_heads, 40, cfg.resolved_head_dim)] * len(params.groups)
    assert len(params.groups) == 2 and sum(k.startswith("shared.") for k in params.state_dict()) == 7


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_prefill_and_decode_match_reference(depth):
    rc, tc = lm.check_prefill_decode(ARCH, **depth)
    assert set(tc) == set(rc) | {"pos"} and tc["pos"] == 15
    for k in ("conv", "state"):
        np.testing.assert_allclose(tc["groups"]["mamba"][k].numpy(), np.asarray(rc["groups"]["mamba"][k]),
                                   atol=1e-4 * float(np.abs(np.asarray(rc["groups"]["mamba"][k])).max()))
    assert tc["groups"]["mamba"]["state"].dtype == torch.float32


@pytest.mark.parametrize("kv_compression", [False, True])
def test_serving_matches_reference(kv_compression):
    lm.check_serving(ARCH, kv_compression=kv_compression)


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_incremental_equals_full(depth):
    lm.check_incremental_equals_full(ARCH, **depth)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
def test_params_round_trip(depth, dtype):
    model = lm.check_round_trip(ARCH, dtype, **depth)
    assert len(model.groups) == 2 and len(getattr(model, "tail", ())) == (1 if depth else 0)


def test_convert_rejects_a_tree_of_another_depth():
    from repro_torch import convert

    rcfg, cfg = lm.configs(ARCH)
    with pytest.raises(ValueError, match="stacked axis"):
        convert.lm_params_from_reference(lm.ref_params(rcfg), dataclasses.replace(cfg, n_layers=6))


def test_compress_cache_walks_the_nested_hybrid_cache():
    got, cache = lm.check_compress_nested_cache(ARCH)
    assert set(got["groups"]) == {"attn", "mamba"} and got["pos"] == cache["pos"]
    assert got["groups"]["mamba"]["state"] is cache["groups"]["mamba"]["state"]


def test_gradients_are_finite():
    """The reference's zamba2 SMOKE gradient regression
    (``tests/test_ssm.py::test_zamba2_smoke_train_step_grads_finite``)."""
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    loss = bundle.loss(params, {"tokens": lm.tokens(cfg, s=32)})
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params.parameters())
