"""The port's POCS loop and engine stages against the reference.

The same seeded inputs go through ``repro`` (JAX, Pallas kernels in interpret
mode) and ``repro_torch`` (CPU: the kernels' plain twins).  The two packages'
float32 FFTs differ in the last bits, so loop trajectories are held
bound-class: both converge on the same cases, both land inside the bounds,
and iteration counts agree within max(3, 10%).  A reference PLAN carried over
with :func:`repro_torch.convert.plan_from_reference` feeds the port's
EXECUTE; a reference result carried over with ``result_from_reference``
feeds the port's ENCODE, which must emit the reference's bytes exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compressors import get_compressor
from repro.core.engine import CorrectionEngine as RefEngine
from repro.core.ffcz import FFCzConfig as RefConfig
from repro.core.pocs import alternating_projection as ref_ap
from repro.data.fields import make_field
from repro.configs.ffcz_fields import FieldConfig
from repro_torch.convert import plan_from_reference, result_from_reference
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.pocs import alternating_projection

IMPLS = [("xla", False), ("packed", False), ("pallas", False), ("xla", True)]
IMPL_IDS = ["xla", "packed", "pallas", "use_kernels"]
SHAPES = [(16, 16, 18), (16, 16, 17), (40, 35), (24, 24, 24)]


def _iters_close(a, b):
    return abs(a - b) <= max(3, 0.1 * max(a, b))


def _as_dict(obj):
    return {k: (None if v is None else np.asarray(v)) for k, v in dataclasses.asdict(obj).items()}


def _loop_inputs(shape, pointwise, seed=0):
    rng = np.random.default_rng(seed)
    E = 0.1
    eps0 = np.clip(rng.standard_normal(shape) * 0.05, -E, E).astype(np.float32)
    d0 = np.abs(np.fft.rfftn(eps0))
    if pointwise:
        Delta = np.maximum(0.5 * d0, 0.1 * d0.max()).astype(np.float32)
    else:
        Delta = float(0.4 * np.abs(np.fft.fftn(eps0)).max())
    return eps0, E, Delta


def _inside(eps, E, Delta, slack=0.0):
    eps = np.asarray(eps, np.float64)
    d = np.fft.rfftn(eps)
    D = np.asarray(Delta, np.float64)
    return np.abs(eps).max() <= E * (1 + 1e-6) and (
        np.maximum(np.abs(d.real), np.abs(d.imag)) <= D * (1 + 1e-4) + slack
    ).all()


@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("impl,use_kernels", IMPLS, ids=IMPL_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_loop_matches_reference(shape, impl, use_kernels, pointwise):
    eps0, E, Delta = _loop_inputs(shape, pointwise)
    kw = dict(max_iters=1000, fft_impl=impl, use_kernels=use_kernels)
    ref = ref_ap(jnp.asarray(eps0), E, jnp.asarray(Delta), **kw)
    got = alternating_projection(torch.from_numpy(eps0), E, Delta, **kw)
    assert got.converged and bool(ref.converged)
    assert _iters_close(got.iterations, int(ref.iterations)), (got.iterations, int(ref.iterations))
    assert got.final_violations == int(ref.final_violations) == 0
    assert got.freq_edits.shape == tuple(ref.freq_edits.shape)
    assert _inside(got.eps.numpy(), E, Delta)
    # the loop invariant eps == eps0 + IFFT(freq_edits) + spat_edits holds
    back = eps0 + np.fft.irfftn(got.freq_edits.numpy(), s=shape, axes=tuple(range(len(shape))))
    np.testing.assert_allclose(back + got.spat_edits.numpy(), got.eps.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.eps.numpy(), np.asarray(ref.eps), atol=1e-4)


@pytest.mark.parametrize("impl,use_kernels", IMPLS, ids=IMPL_IDS)
def test_non_convergence_accounting_matches(impl, use_kernels):
    """max_iters accounting: the cut loop reports the last check's count."""
    eps0, E, _ = _loop_inputs((16, 16, 18), False, seed=1)
    for max_iters, check_every in ((1, 1), (4, 3), (0, 1)):
        kw = dict(max_iters=max_iters, fft_impl=impl, use_kernels=use_kernels, check_every=check_every)
        ref = ref_ap(jnp.asarray(eps0), E, 1e-9, **kw)
        got = alternating_projection(torch.from_numpy(eps0), E, 1e-9, **kw)
        assert (got.iterations, got.converged) == (int(ref.iterations), bool(ref.converged))
        assert got.final_violations == int(ref.final_violations)


@pytest.mark.parametrize("check_every", [1, 3])
def test_complex_oracle_and_cadence(check_every):
    eps0, E, Delta = _loop_inputs((12, 10, 16), False, seed=2)
    kw = dict(max_iters=500, check_every=check_every)
    ref = ref_ap(jnp.asarray(eps0), E, Delta, use_rfft=False, **kw)
    got = alternating_projection(torch.from_numpy(eps0), E, Delta, use_rfft=False, **kw)
    assert got.converged and bool(ref.converged)
    assert _iters_close(got.iterations, int(ref.iterations))
    assert got.freq_edits.shape == (12, 10, 16)
    rfft = alternating_projection(torch.from_numpy(eps0), E, Delta, **kw)
    assert rfft.converged and _iters_close(rfft.iterations, got.iterations)


def test_warm_start_and_pointwise_E():
    eps0, E, Delta = _loop_inputs((16, 18), False, seed=3)
    cold = alternating_projection(torch.from_numpy(eps0), E, Delta, max_iters=500)
    warm = alternating_projection(
        torch.from_numpy(eps0), E, Delta, max_iters=500, warm_freq=cold.freq_edits
    )
    assert warm.converged and warm.iterations <= cold.iterations
    assert np.abs(warm.eps.numpy()).max() <= E
    # a pointwise E tighter than eps0 is enforced before iteration 0
    E_grid = np.full((16, 18), 0.02, np.float32)
    for impl in ("xla", "pallas"):
        ref = ref_ap(jnp.asarray(eps0), jnp.asarray(E_grid), Delta, max_iters=500, fft_impl=impl)
        got = alternating_projection(torch.from_numpy(eps0), E_grid, Delta, max_iters=500, fft_impl=impl)
        assert got.converged == bool(ref.converged)
        assert np.abs(got.eps.numpy()).max() <= 0.02


def test_loop_rejects_what_the_reference_rejects():
    eps0 = torch.zeros((8, 8))
    from repro_torch.sharding.dist_fft import DistSpec

    with pytest.raises(ValueError, match="dist mode"):
        alternating_projection(eps0, 1.0, 1.0, dist=DistSpec("data", (8, 8), 1), fft_impl="pallas")
    with pytest.raises(ValueError, match="relax"):
        alternating_projection(eps0, 1.0, 1.0, fft_impl="pallas", relax=1.5)
    with pytest.raises(ValueError, match="use_kernels"):
        alternating_projection(eps0, 1.0, 1.0, fft_impl="pallas", use_kernels=True)
    with pytest.raises(ValueError, match="rfft"):
        alternating_projection(eps0, 1.0, 1.0, fft_impl="packed", use_rfft=False)
    with pytest.raises(ValueError, match="check_every"):
        alternating_projection(eps0, 1.0, 1.0, check_every=0)


def _field(shape):
    return make_field(FieldConfig("t", shape, "lognormal", alpha=2.0, seed=3))


ENGINE_CASES = [
    ((16, 16, 18), dict(Delta_rel=1e-3)),
    ((16, 16, 17), dict(Delta_rel=1e-3)),
    ((40, 35), dict(Delta_rel=None, pspec_rel=1e-3)),
    ((16, 16, 18), dict(Delta_rel=None, pspec_rel=1e-3)),
]


@pytest.mark.parametrize("impl,use_kernels", IMPLS, ids=IMPL_IDS)
@pytest.mark.parametrize("shape,bound", ENGINE_CASES, ids=lambda v: str(v))
def test_execute_from_reference_plan(shape, bound, impl, use_kernels):
    x = _field(shape)
    cfg = RefConfig(E_rel=1e-3, fft_impl=impl, use_kernels=use_kernels, max_iters=2000, **bound)
    ref_engine = RefEngine()
    ref_plan = ref_engine.plan_field(x, cfg)
    plan = plan_from_reference(_as_dict(ref_plan))
    base = get_compressor("szlike")
    x_hat = np.asarray(base.decompress(base.compress(x, plan.E_proj)), np.float32)
    eps0 = x_hat - x
    ref = ref_engine.execute_field(eps0, ref_plan)
    got = CorrectionEngine(device="cpu").execute_field(eps0, plan)
    assert got.converged and ref.converged
    assert _iters_close(got.iterations, ref.iterations)
    for res in (got, ref):
        # after the float64 polish the shrunk bounds hold exactly
        assert _inside(res.eps, plan.E_proj, plan.Delta_proj)
        assert np.allclose(eps0 + res.spat + np.fft.irfftn(res.freq, s=shape, axes=tuple(range(len(shape)))),
                           res.eps, atol=1e-6)


@pytest.mark.parametrize("shape,bound", ENGINE_CASES, ids=lambda v: str(v))
def test_encode_from_reference_result_is_byte_identical(shape, bound):
    x = _field(shape)
    ref_engine = RefEngine()
    ref_plan = ref_engine.plan_field(x, RefConfig(E_rel=1e-3, **bound))
    base = get_compressor("szlike")
    eps0 = np.asarray(base.decompress(base.compress(x, ref_plan.E_proj)), np.float32) - x
    ref = ref_engine.execute_field(eps0, ref_plan)
    se_r, fe_r = ref_engine.encode_field(ref, ref_plan)
    se_t, fe_t = CorrectionEngine(device="cpu").encode_field(
        result_from_reference(_as_dict(ref)), plan_from_reference(_as_dict(ref_plan))
    )
    assert se_t.to_bytes() == se_r.to_bytes()
    assert fe_t.to_bytes() == fe_r.to_bytes()


def test_plan_matches_reference():
    x = _field((16, 16, 18))
    for bound in (dict(Delta_rel=None, Delta_abs=50.0), dict(E_rel=None, E_abs=0.01, Delta_rel=1e-3),
                  dict(Delta_rel=None, pspec_rel=1e-3)):
        kw = dict(E_rel=1e-3)
        kw.update(bound)
        ref = RefEngine().plan_field(x, RefConfig(**kw))
        got = CorrectionEngine(device="cpu").plan_field(x, RefConfig(**kw))
        for name in ("shape", "pointwise", "quant_bits", "max_iters", "codec", "fft_impl"):
            assert getattr(got, name) == getattr(ref, name)
        assert got.E == ref.E and got.E_proj == ref.E_proj and got.slack_f == ref.slack_f
        # spectrum-derived grids: FFT round-off is absolute, so the 1e-6 is
        # relative to the grid's largest entry
        for name in ("Delta", "Delta_proj"):
            want = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(np.asarray(getattr(got, name)), want, rtol=1e-6,
                                       atol=1e-6 * float(np.max(want)))


def test_plan_conversion_round_trips_roi():
    x = _field((12, 10))
    mask = np.zeros(x.shape, bool)
    mask[3:7, 2:5] = True
    ref = RefEngine().plan_field(x, RefConfig(E_rel=1e-3, Delta_rel=1e-3, E_roi=mask))
    plan = plan_from_reference(_as_dict(ref))
    assert plan.roi and np.array_equal(plan.E_grid, ref.E_grid)
    assert plan.roi_bytes() == ref.roi_bytes()
    with pytest.raises(ValueError, match="fields differ"):
        plan_from_reference({"shape": (3,)})


def test_unported_paths_raise():
    with pytest.raises(ValueError, match="mesh"):
        CorrectionEngine(backend="sharded", device="cpu").mesh
    for backend in ("local", "batched"):
        assert CorrectionEngine(backend=backend, device="cpu").backend == backend


def test_async_handle_is_idempotent():
    x = _field((16, 18))
    eng = CorrectionEngine(device="cpu")
    plan = eng.plan_field(x, RefConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas"))
    eps0 = np.asarray(get_compressor("szlike").decompress(
        get_compressor("szlike").compress(x, plan.E_proj)), np.float32) - x
    handle = eng.execute_field_async(eps0, plan)
    first = handle.result()
    assert handle.result() is first and first.converged
