"""The port's Mamba2/SSD blocks and the mamba2 model against the reference's, on the CPU.

Same numpy inputs in both packages (the reference's parameters for the
block and the model).  Tolerance: the port's ``_segsum_decay``,
``ssd_chunked``, ``ssd_decode_step`` and ``mamba2_apply`` within rtol 1e-5
of the reference's, scaled by the output's largest magnitude (atol = 1e-5 *
max|want|): the same float32 formulas, with sums (cumsum, einsum
contractions) taken in another order.  The port's chunked scan against its
own sequential oracle keeps the reference's bar, atol 2e-4
(``tests/test_ssm.py``).
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
from repro.models import ssm as r_ssm
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import ssm as t_ssm

ARCH = "mamba2-2.7b"


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _ssd_inputs(seed, b=2, l=37, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32),
            rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("q", [8, 32, 64])
def test_segsum_decay_matches_reference(q):
    dtA = -np.random.default_rng(q).uniform(0.0, 3.0, (2, 3, q, 4)).astype(np.float32)
    cum, L = t_ssm._segsum_decay(torch.from_numpy(dtA))
    r_cum, r_L = r_ssm._segsum_decay(jnp.asarray(dtA))
    _close(cum.numpy(), r_cum)
    _close(L.numpy(), r_L)
    assert float(L.numpy()[..., 0, 1].max()) == 0.0  # strictly upper triangle masked


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_matches_reference(chunk):
    x, dt, A, B, C = _ssd_inputs(chunk)
    y, S = t_ssm.ssd_chunked(*_t((x, dt, A, B, C)), chunk=chunk)
    r_y, r_S = r_ssm.ssd_chunked(*_j((x, dt, A, B, C)), chunk=chunk)
    _close(y.numpy(), r_y)
    _close(S.numpy(), r_S)
    y_seq, S_seq = t_ssm.ssd_ref(*_t((x, dt, A, B, C)))
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), atol=2e-4)
    np.testing.assert_allclose(S.numpy(), S_seq.numpy(), atol=2e-4)


@pytest.mark.parametrize("chunk", [16, 32])
def test_state_continuation_matches_reference(chunk):
    x, dt, A, B, C = _ssd_inputs(7, l=48)
    first = [a[:, :32] for a in (x, dt)] + [A] + [a[:, :32] for a in (B, C)]
    rest = [a[:, 32:] for a in (x, dt)] + [A] + [a[:, 32:] for a in (B, C)]
    _, S = t_ssm.ssd_chunked(*_t(first), chunk=chunk)
    y2, S2 = t_ssm.ssd_chunked(*_t(rest), chunk=chunk, initial_state=S)
    _, r_S = r_ssm.ssd_chunked(*_j(first), chunk=chunk)
    r_y2, r_S2 = r_ssm.ssd_chunked(*_j(rest), chunk=chunk, initial_state=r_S)
    _close(y2.numpy(), r_y2)
    _close(S2.numpy(), r_S2)


def test_ssd_ref_matches_reference():
    x, dt, A, B, C = _ssd_inputs(3, l=10)
    y, S = t_ssm.ssd_ref(*_t((x, dt, A, B, C)))
    r_y, r_S = r_ssm.ssd_ref(*_j((x, dt, A, B, C)))
    _close(y.numpy(), r_y)
    _close(S.numpy(), r_S)


def test_decode_steps_match_reference():
    x, dt, A, B, C = _ssd_inputs(4, l=10)
    S = torch.zeros((2, 4, 8, 16))
    r_S = jnp.zeros((2, 4, 8, 16), dtype=jnp.float32)
    tx, tdt, tA, tB, tC = _t((x, dt, A, B, C))
    for t in range(10):
        y, S = t_ssm.ssd_decode_step(S, tx[:, t], tdt[:, t], tA, tB[:, t], tC[:, t])
        r_y, r_S = r_ssm.ssd_decode_step(r_S, *_j((x[:, t], dt[:, t], A, B[:, t], C[:, t])))
        _close(y.numpy(), r_y)
        _close(S.numpy(), r_S)


def _block(dtype="float32", seed=0):
    rcfg, cfg = r_get_smoke_config(ARCH, dtype=dtype), get_smoke_config(ARCH, dtype=dtype)
    p = jax.tree.map(np.asarray, r_ssm.mamba2_init(jax.random.PRNGKey(seed), rcfg))
    block = t_ssm.Mamba2(cfg)
    block.load_state_dict({"norm.scale": convert._tensor(p["norm"]["scale"]),
                           **{k: convert._tensor(v) for k, v in p.items() if k != "norm"}})
    return rcfg, cfg, p, block


def test_mamba2_apply_matches_reference():
    rcfg, cfg, p, block = _block()
    x = np.random.default_rng(5).standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, cache = block(torch.from_numpy(x), cfg)
    r_out, _ = r_ssm.mamba2_apply(p, jnp.asarray(x), rcfg)
    assert cache is None
    _close(out.numpy(), r_out)


def test_mamba2_prefill_and_decode_match_reference():
    rcfg, cfg, p, block = _block()
    x = np.random.default_rng(6).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    cache = t_ssm.init_mamba_cache(2, cfg, torch.float32)
    r_cache = r_ssm.init_mamba_cache(2, rcfg, jnp.float32)
    assert cache["state"].dtype == torch.float32
    with torch.no_grad():
        for sl in (slice(0, 8), slice(8, 9)):  # a prefill (l > 1), then one decode step (l == 1)
            out, cache = block(torch.from_numpy(x[:, sl]), cfg, cache=cache)
            r_out, r_cache = r_ssm.mamba2_apply(p, jnp.asarray(x[:, sl]), rcfg, cache=r_cache)
            _close(out.numpy(), r_out)
            for k in ("conv", "state"):
                _close(cache[k].numpy(), r_cache[k])


def test_bf16_block_keeps_the_references_types():
    rcfg, cfg, p, block = _block(dtype="bfloat16")
    x = np.random.default_rng(8).standard_normal((1, 20, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, _ = block(torch.from_numpy(x).to(torch.bfloat16), cfg)
        cache = t_ssm.init_mamba_cache(1, cfg, torch.bfloat16)
        _, cache = block(torch.from_numpy(x).to(torch.bfloat16), cfg, cache=cache)
    r_out, _ = r_ssm.mamba2_apply(p, jnp.asarray(x, dtype=jnp.bfloat16), rcfg)
    assert out.dtype == torch.bfloat16 and cache["conv"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32
    # one bf16 rounding of the output apart at most (inputs and weights identical)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(r_out, dtype=np.float32),
                               atol=2 ** -7 * float(np.abs(np.asarray(r_out, dtype=np.float32)).max()))


def test_bf16_decode_step_keeps_the_references_types():
    """A bf16 prefill, then one decode step (the recurrence): the state stays
    float32 and the conv window bf16 through the step, as in the reference,
    and each output within two bf16 ulps at the output's largest magnitude
    of the reference's (the cache path rounds the conv window and the SSD
    output; at one ulp 2 of the prefill's 1024 values miss by one more)."""
    rcfg, cfg, p, block = _block(dtype="bfloat16", seed=1)
    x = np.random.default_rng(9).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    cache = t_ssm.init_mamba_cache(2, cfg, torch.bfloat16)
    r_cache = r_ssm.init_mamba_cache(2, rcfg, jnp.bfloat16)
    with torch.no_grad():
        for sl in (slice(0, 8), slice(8, 9)):
            out, cache = block(torch.from_numpy(x[:, sl]).to(torch.bfloat16), cfg, cache=cache)
            r_out, r_cache = r_ssm.mamba2_apply(p, jnp.asarray(x[:, sl], dtype=jnp.bfloat16), rcfg, cache=r_cache)
            assert out.dtype == torch.bfloat16
            for k in ("conv", "state"):
                assert str(cache[k].dtype).split(".")[-1] == str(r_cache[k].dtype)
            want = np.asarray(r_out, dtype=np.float32)
            np.testing.assert_allclose(out.float().numpy(), want, atol=2 ** -6 * float(np.abs(want).max()))
    assert cache["state"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16


def test_finite_grads_under_overflowing_masked_exponent():
    """The reference's regression (``tests/test_ssm.py``): the masked-out
    entries of the decay matrix are positive sums of |dt * A| that overflow
    exp; without the double where the backward is inf * 0 = NaN."""
    x, dt, A, B, C = _t(_ssd_inputs(9, l=32))
    dt = torch.full_like(dt, 0.35)  # 32 steps * 0.35 * 16 = 179 > 88.7
    A = torch.full_like(A, 16.0)
    x.requires_grad_()
    y, S = t_ssm.ssd_chunked(x, dt, A, B, C, chunk=32)
    loss = torch.sum(y**2) + torch.sum(S**2)
    loss.backward()
    assert np.isfinite(float(loss.detach())) and bool(torch.isfinite(x.grad).all())


def test_cache_is_o1():
    cfg = get_smoke_config(ARCH)
    c = t_ssm.init_mamba_cache(4, cfg, torch.float32)
    assert sum(t.numel() * t.element_size() for t in c.values()) < 1e6
    bundle = lm.build_model(cfg, device="cpu")
    assert {k: tuple(t.shape) for k, t in bundle.init_cache(2, 10).items()} == \
           {k: tuple(t.shape) for k, t in bundle.init_cache(2, 10_000).items()}


# ---------------------------------------------------------------------------
# the mamba2 model


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_is_the_references(preset):
    ours = get_config(ARCH) if preset == "full" else get_smoke_config(ARCH)
    theirs = r_get_config(ARCH) if preset == "full" else r_get_smoke_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "d_inner", "ssm_nheads"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.supports_long_context() == theirs.supports_long_context() is True


def test_loss_matches_reference():
    lm.check_loss(ARCH)


def test_prefill_and_decode_match_reference():
    rc, tc = lm.check_prefill_decode(ARCH)
    assert set(tc) == {"conv", "state"} and tc["state"].dtype == torch.float32
    for k in ("conv", "state"):
        _close(tc[k].numpy(), rc[k], rtol=1e-4)


def test_serving_matches_reference():
    lm.check_serving(ARCH)


def test_serving_skips_kv_compression():
    lm.check_serving(ARCH, kv_compression=True)


def test_incremental_equals_full():
    lm.check_incremental_equals_full(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    model = lm.check_round_trip(ARCH, dtype)
    assert model.layers[0].A_log.dtype == torch.float32  # A_log, D, dt_bias stay float32


def test_model_gradients_are_finite():
    cfg = get_smoke_config(ARCH)
    bundle = lm.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(1))
    bundle.loss(params, {"tokens": lm.tokens(cfg, s=33)}).backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params.parameters())
