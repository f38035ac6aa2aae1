"""The port's AdamW and FFCz gradient compression against the reference's.

Tolerances:
  * AdamW: rtol 1e-6 in float32 (the same float32 formulas; the global norm
    sums the leaves' squares in another order, and ``b ** step`` may round
    differently in the last place).
  * ``compress_gradients`` at the defaults: bitwise.  The quantizer's
    float32 arithmetic is the reference's, and the correction cannot act:
    every error is at most E * 2^-bits, so every spectrum component is at
    most block * E * 2^-bits, below Delta = Delta_rel * block * E whenever
    Delta_rel >= 2^-bits.
  * With a tightened Delta (Delta_rel < 2^-bits, where the loop corrects):
    bound-class.  The port's corrected errors within E, and every full
    pencil's spectrum within Delta * (1 + 1e-5) + tau (the loop's float32
    test plus a bound on the float32 FFT's rounding), rechecked in float64;
    both packages' outputs within the reference test's bars of E * 1.001
    and Delta * 1.02 (the float32 sum g + correction rounds on g's scale).
    The two packages' float32 FFTs round differently, so the outputs agree
    only to within 2 E.
  * The reference's own ``tests/test_grad_compress.py`` checks replayed on
    the port with their tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as RAdamW
from repro.optim.grad_compress import _quantize_dequantize as r_quantize_dequantize
from repro.optim.grad_compress import compress_gradients as r_compress_gradients
from repro_torch import tree
from repro_torch.core.engine import CorrectionEngine
from repro_torch.optim import AdamW, compress_gradients, compressed_psum
from repro_torch.optim.grad_compress import _quantize_dequantize


def _torch_tree(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _np_tree(t):
    return [x.numpy() for x in tree.leaves(t)]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((64, 32)).astype(np.float32),
        "layers": {"w": rng.standard_normal((3, 16, 8)).astype(np.float32),
                   "b": rng.standard_normal((3, 8)).astype(np.float32)},
        "scale": np.ones(32, np.float32),
    }


@pytest.fixture
def rng():
    """A fresh generator per test (the conftest's lives for the whole test run)."""
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# AdamW


@pytest.mark.parametrize("grad_scale", [3.0, 1e-3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("steps", [1, 3, 12])
def test_adamw_matches_reference(steps, grad_scale):
    rng = np.random.default_rng(1)
    P = _params()
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * grad_scale).astype(np.float32), P)
             for _ in range(steps)]
    ro, to = RAdamW(warmup_steps=5), AdamW(warmup_steps=5)
    rp, rs = P, ro.init(P)
    tp, ts = _torch_tree(P), to.init(_torch_tree(P))
    for g in grads:
        rp, rs = ro.update(g, rs, rp)
        tp, ts = to.update(_torch_tree(g), ts, tp)
    assert int(ts["step"]) == int(rs["step"]) == steps and ts["step"].dtype == torch.int32
    for want_tree, got_tree in ((rp, tp), (rs["m"], ts["m"]), (rs["v"], ts["v"])):
        for want, got in zip(jax.tree.leaves(want_tree), _np_tree(got_tree)):
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_adamw_clamps_a_negative_second_moment():
    """A lossily restored ``v`` can be epsilon-negative: no NaN, as the reference."""
    P = _params()
    g = jax.tree.map(lambda a: np.full(a.shape, 1e-12, np.float32), P)
    ro, to = RAdamW(), AdamW()
    rs = ro.init(P)
    rs["v"] = jax.tree.map(lambda a: np.full(a.shape, -1e-9, np.float32), P)
    ts = to.init(_torch_tree(P))
    ts["v"] = tree.map_leaves(lambda a: torch.full(a.shape, -1e-9), ts["v"])
    rp, _ = ro.update(g, rs, P)
    tp, _ = to.update(_torch_tree(g), ts, _torch_tree(P))
    for want, got in zip(jax.tree.leaves(rp), _np_tree(tp)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_adamw_keeps_a_bfloat16_parameter_dtype():
    p = {"w": torch.randn(8, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    opt = AdamW()
    state = opt.init(p)
    assert state["m"]["w"].dtype == torch.float32
    new, state = opt.update({"w": torch.ones(8, 4, dtype=torch.bfloat16)}, state, p)
    assert new["w"].dtype == torch.bfloat16 and state["v"]["w"].dtype == torch.float32


def test_adamw_fields_are_the_references():
    import dataclasses

    a = [(f.name, f.default) for f in dataclasses.fields(AdamW)]
    b = [(f.name, f.default) for f in dataclasses.fields(RAdamW)]
    assert a == b


# ---------------------------------------------------------------------------
# compress_gradients


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((512, 16)).astype(np.float32),
        "e": (rng.standard_normal((3, 5000)) * 1e-3).astype(np.float32),
        "nested": {"short": rng.standard_normal(300).astype(np.float32),
                   "pair": np.float32([0.5, -2.0]),
                   "scalar": np.float32(2.0)},
        "layers": [rng.standard_normal(4096).astype(np.float32), rng.standard_normal(1030).astype(np.float32)],
    }


def _engine():
    return CorrectionEngine(device="cpu")


@pytest.mark.parametrize("bits", [8, 6])
def test_quantize_dequantize_is_the_references(bits):
    g = np.random.default_rng(3).standard_normal(10_000).astype(np.float32) * 7
    want = r_quantize_dequantize(jnp.asarray(g), bits, 1e-2)
    got = _quantize_dequantize(torch.from_numpy(g), bits, 1e-2)
    for w, t in zip(want, got):
        assert np.array_equal(np.asarray(w), t.numpy())


@pytest.mark.parametrize("kw", [{}, {"block": 1024, "max_iters": 4}], ids=["defaults", "block1024"])
def test_compress_gradients_bitwise_where_the_loop_cannot_act(kw):
    G = _grads()
    want = r_compress_gradients(jax.tree.map(jnp.asarray, G), **kw)
    got = compress_gradients(_torch_tree(G), engine=_engine(), **kw)
    assert jax.tree.structure(want) == jax.tree.structure(jax.tree.map(lambda t: 0, got))
    for w, t in zip(jax.tree.leaves(want), _np_tree(got)):
        assert t.dtype == np.asarray(w).dtype and np.array_equal(np.asarray(w), t)


def _spectrum_max(err, block):
    """Per full ``block``-pencil max of |Re|, |Im| of the float64 rfft, and
    each pencil's l2 norm."""
    err = np.asarray(err, np.float64).reshape(-1)
    full = err[: err.size // block * block].reshape(-1, block)
    spec = np.fft.rfft(full, axis=-1)
    return np.maximum(np.abs(spec.real), np.abs(spec.imag)).max(axis=1), np.sqrt((full * full).sum(axis=1))


class _Recording(CorrectionEngine):
    """A CPU engine that keeps each ``correct`` call's inputs and outputs."""

    def __init__(self):
        super().__init__(device="cpu")
        self.calls = []

    def correct(self, tensors, E, Delta, block=4096, **kw):
        out = super().correct(tensors, E, Delta, block=block, **kw)
        self.calls.append((tensors, E, Delta, out[0], block))
        return out


@pytest.mark.parametrize("bits,Delta_rel", [(8, 2e-5), (6, 1e-4)])
def test_compress_gradients_bound_class_where_the_loop_corrects(bits, Delta_rel):
    """Outputs of both packages within the reference test's bars (E * 1.001,
    Delta * 1.02: the float32 sum g + correction rounds on g's scale); the
    port's corrected errors themselves within E and Delta * (1 + 1e-5) + tau."""
    assert Delta_rel < 2.0**-bits
    G = _grads(1)
    kw = dict(bits=bits, E_rel=1e-2, Delta_rel=Delta_rel, block=1024, max_iters=30)
    want = r_compress_gradients(jax.tree.map(jnp.asarray, G), **kw)
    engine = _Recording()
    got = compress_gradients(_torch_tree(G), engine=engine, **kw)
    for g, w, t in zip(jax.tree.leaves(G), jax.tree.leaves(want), _np_tree(got)):
        g = np.asarray(g)
        if g.size < 2:
            assert np.array_equal(t, g)
            continue
        E = float(np.float32(1e-2) * np.abs(g).max())
        Delta = float(np.float32(Delta_rel * 1024) * np.float32(E))
        for out in (np.asarray(w), t):
            err = out.astype(np.float64) - g.astype(np.float64)
            assert np.abs(err).max() <= E * 1.001
            mag, _ = _spectrum_max(err, min(1024, g.size))
            assert mag.size == 0 or mag.max() <= Delta * 1.02
        assert np.abs(t.astype(np.float64) - np.asarray(w, np.float64)).max() <= 2 * E
    acted = 0
    for errs, Es, Ds, corrected, block in engine.calls:
        for err0, E, D, c in zip(errs, Es, Ds, corrected):
            c = c.numpy().astype(np.float64)
            assert np.abs(c).max() <= float(E)
            mag, norm = _spectrum_max(c, block)
            tau = 5 * 2.0**-24 * np.log2(block) * np.sqrt(block) * norm
            assert np.all(mag <= float(D) * (1 + 1e-5) + tau)
            acted += not np.array_equal(c, err0.numpy())
    assert acted, "the tightened Delta should make the loop correct"


def test_compress_gradients_default_engine_follows_the_tensors():
    g = {"w": torch.randn(2048, generator=torch.Generator().manual_seed(0))}
    out = compress_gradients(g)  # CPU tensors: the CPU's default engine
    assert out["w"].device.type == "cpu" and out["w"].shape == (2048,)


def test_compressed_psum_is_not_ported():
    with pytest.raises(ValueError, match="mesh"):
        compressed_psum(torch.zeros(4), mesh=None)


# the reference's tests/test_grad_compress.py, replayed on the port


def test_spatial_bound(rng):
    g = {"w": torch.from_numpy(rng.standard_normal((512, 16)).astype(np.float32))}
    out = compress_gradients(g, bits=8, E_rel=1e-2, Delta_rel=1e-1, block=1024, engine=_engine())
    err = (out["w"] - g["w"]).numpy().astype(np.float64)
    E = 1e-2 * np.abs(g["w"].numpy()).max()
    assert np.abs(err).max() <= E * 1.001


def test_frequency_bound_per_block(rng):
    g = {"w": torch.from_numpy(rng.standard_normal(2048).astype(np.float32))}
    block = 512
    out = compress_gradients(g, bits=6, E_rel=5e-2, Delta_rel=1e-2, block=block, max_iters=30,
                             engine=_engine())
    err = (out["w"] - g["w"]).numpy().astype(np.float64).reshape(-1, block)
    d = np.fft.fft(err, axis=-1)
    E = 5e-2 * np.abs(g["w"].numpy()).max()
    Delta = 1e-2 * block * E
    assert max(np.abs(d.real).max(), np.abs(d.imag).max()) <= Delta * 1.02


def test_direction_preserved(rng):
    """Compressed gradient must stay well-aligned with the original."""
    g = {"w": torch.from_numpy(rng.standard_normal(4096).astype(np.float32))}
    out = compress_gradients(g, bits=8, E_rel=1e-2, Delta_rel=1e-1, engine=_engine())
    a, b = g["w"].numpy(), out["w"].numpy()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.999


def test_tiny_leaves_passthrough():
    g = {"scalar": torch.tensor(2.0)}
    out = compress_gradients(g)
    assert float(out["scalar"]) == 2.0
