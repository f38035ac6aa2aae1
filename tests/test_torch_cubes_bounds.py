"""Cubes, bounds and spectrum metrics: the port against the reference.

Projections and counts are bitwise on the CPU (one rounding per operation in
both packages).  Bounds resolved without an FFT (``E_abs``, ``E_rel``,
``Delta_abs``) are bitwise too; those resolved from a spectrum
(``Delta_rel``, ``pspec``) are held at rtol 1e-6, because torch's CPU FFT and
XLA's differ in the last bits (about 6.5e-5 absolute on a 24^3 ``rfftn`` of
order-100 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as r_bounds
from repro.core import cubes as r_cubes
from repro.core import spectrum as r_spectrum
from repro.core.engine import CorrectionEngine as RefEngine
from repro.core.errors import InfeasibleBound as RefInfeasible
from repro.core.ffcz import FFCzConfig as RefConfig
from repro_torch.core import bounds as t_bounds
from repro_torch.core import cubes as t_cubes
from repro_torch.core import spectrum as t_spectrum
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.errors import InfeasibleBound
from repro_torch.core.ffcz import FFCzConfig

SHAPES = [(24, 24, 24), (40, 35), (16, 16, 17)]


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray((rng.standard_normal(shape) * 0.5 + 4.0).cumsum(axis=0), np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rfft_shape_and_pair_weights(shape):
    assert t_cubes.rfft_shape(shape) == r_cubes.rfft_shape(shape)
    w = t_cubes.rfft_pair_weights(shape)
    assert w.dtype == torch.int32
    assert np.array_equal(_np(w), np.asarray(r_cubes.rfft_pair_weights(shape)))
    assert int(torch.broadcast_to(w, t_cubes.rfft_shape(shape)).sum()) == int(np.prod(shape))


@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_projections_bitwise(shape, pointwise):
    rng = np.random.default_rng(1)
    eps = rng.standard_normal(shape).astype(np.float32)
    delta = np.fft.rfftn(eps).astype(np.complex64)
    E = rng.uniform(0.3, 1.2, shape).astype(np.float32) if pointwise else 0.7
    D = rng.uniform(1.0, 6.0, delta.shape).astype(np.float32) if pointwise else 3.0
    for got, want in zip(t_cubes.project_scube(torch.from_numpy(eps), E),
                         r_cubes.project_scube(jnp.asarray(eps), jnp.asarray(E, jnp.float32))):
        assert np.array_equal(_np(got), np.asarray(want))
    for got, want in zip(t_cubes.project_fcube(torch.from_numpy(delta), D),
                         r_cubes.project_fcube(jnp.asarray(delta), jnp.asarray(D, jnp.float32))):
        assert np.array_equal(_np(got), np.asarray(want))
    for relax in (1.3, 1.9):
        got = t_cubes.project_box_relaxed(torch.from_numpy(eps), E, relax)
        want = r_cubes.project_box_relaxed(jnp.asarray(eps), jnp.asarray(E, jnp.float32), relax)
        assert np.array_equal(_np(got), np.asarray(want))
        got = t_cubes.project_fcube_relaxed(torch.from_numpy(delta), D, relax)
        want = r_cubes.project_fcube_relaxed(jnp.asarray(delta), jnp.asarray(D, jnp.float32), relax)
        assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_violation_counts_identical(shape):
    rng = np.random.default_rng(2)
    eps = rng.standard_normal(shape).astype(np.float32)
    delta = np.fft.rfftn(eps).astype(np.complex64)
    w_t, w_r = t_cubes.rfft_pair_weights(shape), r_cubes.rfft_pair_weights(shape)
    for D in (2.0, 5.0):
        assert int(t_cubes.fcube_violations(torch.from_numpy(delta), D)) == int(
            r_cubes.fcube_violations(jnp.asarray(delta), D))
        assert int(t_cubes.fcube_violations(torch.from_numpy(delta), D, w_t)) == int(
            r_cubes.fcube_violations(jnp.asarray(delta), D, w_r))
    assert int(t_cubes.scube_violations(torch.from_numpy(eps), 1.0)) == int(
        r_cubes.scube_violations(jnp.asarray(eps), 1.0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bounds_without_fft_bitwise(shape):
    x = _field(shape, 3)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for kw in ({"E_abs": 0.25, "Delta_abs": 1.5}, {"E_rel": 1e-3, "Delta_abs": 2.0}):
        got, want = t_bounds.resolve_bounds(xt, **kw), r_bounds.resolve_bounds(xj, **kw)
        assert float(got.E) == float(want.E)
        assert float(got.Delta) == float(want.Delta)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_spectral_bounds_close(shape):
    x = _field(shape, 4)
    got = t_bounds.resolve_bounds(torch.from_numpy(x), E_rel=1e-3, Delta_rel=1e-3)
    want = r_bounds.resolve_bounds(jnp.asarray(x), E_rel=1e-3, Delta_rel=1e-3)
    assert float(got.E) == float(want.E)
    np.testing.assert_allclose(float(got.Delta), float(want.Delta), rtol=1e-6)
    Xt, Xj = torch.fft.rfftn(torch.from_numpy(x)), jnp.fft.rfftn(jnp.asarray(x))
    for rel in (1e-3, 1e-2):
        gt = t_bounds.power_spectrum_delta_rfft(Xt, rel)
        gj = r_bounds.power_spectrum_delta_rfft(Xj, rel)
        assert gt.dtype == torch.float32 and gt.shape == gj.shape
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-6, atol=1e-6 * float(gj.max()))


def test_roi_grid_identical():
    rng = np.random.default_rng(5)
    mask = rng.random((9, 11)) < 0.3
    grid = rng.uniform(-1, 2, (9, 11))
    for roi in (mask, grid):
        assert np.array_equal(
            t_bounds.resolve_roi_bound_grid(roi, 1.5, (9, 11), scale=0.2),
            r_bounds.resolve_roi_bound_grid(roi, 1.5, (9, 11), scale=0.2),
        )
    with pytest.raises(ValueError, match="must match"):
        t_bounds.resolve_roi_bound_grid(mask, 1.5, (9, 12))


def test_infeasible_bounds_raise_alike():
    const = np.full((8, 10), 3.0, np.float32)
    with pytest.raises(RefInfeasible, match="constant field"):
        r_bounds.resolve_bounds(jnp.asarray(const), E_rel=1e-3, Delta_abs=1.0)
    with pytest.raises(InfeasibleBound, match="constant field"):
        t_bounds.resolve_bounds(torch.from_numpy(const), E_rel=1e-3, Delta_abs=1.0)
    cases = [
        (np.zeros((8, 10), np.float32), dict(E_abs=0.1, E_rel=None, Delta_rel=None, pspec_rel=1e-3), "all-zero"),
        (_field((8, 10)), dict(E_abs=1e-12, E_rel=None, Delta_rel=1e-3), "representability"),
    ]
    for x, kw, msg in cases:
        with pytest.raises(RefInfeasible, match=msg):
            RefEngine().plan_field(x, RefConfig(**kw))
        with pytest.raises(InfeasibleBound, match=msg):
            CorrectionEngine(device="cpu").plan_field(x, FFCzConfig(**kw))


@pytest.mark.parametrize("shape", [(24, 24, 24), (40, 35)], ids=str)
def test_spectrum_metrics_close(shape):
    x = _field(shape, 6)
    xh = x + np.random.default_rng(6).standard_normal(shape).astype(np.float32) * 0.01
    k_t, p_t = t_spectrum.power_spectrum(torch.from_numpy(x))
    k_r, p_r = r_spectrum.power_spectrum(jnp.asarray(x))
    assert np.array_equal(_np(k_t), np.asarray(k_r))
    # the mean-normalized DC shell is round-off (~1e-8) in both packages
    np.testing.assert_allclose(_np(p_t), np.asarray(p_r), rtol=1e-4, atol=1e-6 * float(p_r.max()))
    for name in ("psnr", "ssnr_spatial"):
        got = float(getattr(t_spectrum, name)(torch.from_numpy(xh), torch.from_numpy(x)))
        want = float(getattr(r_spectrum, name)(jnp.asarray(xh), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    Xh, X = np.fft.fftn(xh).astype(np.complex64), np.fft.fftn(x).astype(np.complex64)
    np.testing.assert_allclose(
        _np(t_spectrum.relative_frequency_error(torch.from_numpy(Xh), torch.from_numpy(X))),
        np.asarray(r_spectrum.relative_frequency_error(jnp.asarray(Xh), jnp.asarray(X))),
        rtol=1e-5, atol=1e-8,
    )
    assert t_spectrum.shell_ratio_error(xh, x) == r_spectrum.shell_ratio_error(xh, x)
    assert t_spectrum.bitrate(1000, 64) == r_spectrum.bitrate(1000, 64)
