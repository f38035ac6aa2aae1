"""The port's pencil path (``core/blockwise``, the engine's pencil stages)
against the reference.

The same seeded numpy inputs go through ``repro`` (JAX; the Pallas kernels in
interpret mode) and ``repro_torch`` (CPU: the kernels' plain twins).

* Host stages are byte-identical: ``tile_1d``, ``batch_layout``,
  ``pack_batch``, ``plan_pencils`` and ``encode_pencils`` (given the same
  edit tiles).
* The loop is held bound-class, as the whole-field loop is: the two
  packages' float32 FFTs differ in the last bits.  On these seeded inputs the
  per-block iteration counts and converged flags are equal to the
  reference's, and the corrected values agree within 1e-6 (a few float32
  ulps of the bounds).  The corrected tensors are rechecked in float64:
  every value within ``E`` exactly (the loop's last s-clip is a clip to the
  float32 ``E``), and every full pencil's FFT within ``Delta * (1 + 1e-5) +
  tau``: the loop's own float32 convergence test plus ``tau = 5 * 2^-24 *
  log2(N) * sqrt(N) * ||x||_2``, a bound on the float32 FFT's rounding error
  (Higham, Accuracy and Stability of Numerical Algorithms, 2nd ed., Thm
  24.2).  A tensor's last, zero-padded pencil is corrected with its pad,
  which unpacking discards, so its frequency bound cannot be rechecked from
  the output.
* ``local`` and ``batched`` in the port are bitwise equal: each row of the
  batched loop is computed by the same operations whatever the other rows do.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compressors import get_compressor
from repro.core import blockwise as r_bw
from repro.core.engine import CorrectionEngine as RefEngine
from repro.core.engine import default_engine as r_default_engine
from repro.core.ffcz import FFCz as RefFFCz
from repro_torch import convert
from repro_torch.core import blockwise as t_bw
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.core.ffcz import FFCz

IMPLS = ["xla", "packed", "pallas"]
SHAPES = [(3, 500), (1000,), (7, 9, 11), (64,)]
E_T, D_T = [0.03, 0.05, 0.04, 0.02], [0.2, 0.35, 0.25, 0.1]


def _tensors(seed=0, shapes=SHAPES):
    """Initial errors inside each tensor's s-cube, as a base compressor's are."""
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal(s) * 0.02, -e, e).astype(np.float32)
            for s, e in zip(shapes, E_T)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_pencils_within(corrected, E, Delta, block):
    """Float64 recheck of the output (see the module docstring)."""
    x = np.asarray(_np(corrected), np.float64).reshape(-1)
    assert np.abs(x).max() <= np.float32(E)
    x = x[: x.size // block * block].reshape(-1, block)
    d = np.fft.fft(x, axis=-1)
    tau = 5 * 2.0**-24 * np.log2(block) * np.sqrt(block) * np.sqrt((x * x).sum(axis=1, keepdims=True))
    limit = np.float32(Delta) * (1 + 1e-5) + tau
    assert np.all(np.maximum(np.abs(d.real), np.abs(d.imag)) <= limit)


def _ref_correct(tensors, block, impl, **kw):
    return RefEngine(fft_impl=impl).correct([jnp.asarray(t) for t in tensors], E_T[: len(tensors)],
                                            D_T[: len(tensors)], block=block, max_iters=40, **kw)


# -- engine defaults ----------------------------------------------------------


def test_engine_defaults_are_the_references():
    ref = inspect.signature(RefEngine.__init__).parameters
    port = inspect.signature(CorrectionEngine.__init__).parameters
    for name in ("backend", "axis", "fft_impl"):
        assert port[name].default == ref[name].default
    for bad in ({"fft_impl": "cufft"}, {"backend": "gpu"}):
        with pytest.raises(ValueError) as want:
            RefEngine(**bad)
        with pytest.raises(ValueError) as got:
            CorrectionEngine(device="cpu", **bad)
        assert str(got.value) == str(want.value)
    eng = default_engine("cpu")
    assert eng is default_engine(torch.device("cpu"))
    assert (eng.backend, eng.fft_impl, eng.axis) == (
        r_default_engine().backend, r_default_engine().fft_impl, r_default_engine().axis)
    assert FFCz(get_compressor("szlike"), device="cpu").engine is eng
    assert RefFFCz(get_compressor("szlike")).engine is r_default_engine()


def test_default_engine_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        default_engine()


# -- host staging: byte-identical ---------------------------------------------


@pytest.mark.parametrize("block", [64, 63, 4096])
def test_tiling_and_packing_are_the_references(block):
    tensors = _tensors(1)
    for t in tensors:
        got, pad = t_bw.tile_1d(torch.from_numpy(t), block)
        want, rpad = r_bw.tile_1d(jnp.asarray(t), block)
        assert pad == rpad and np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(t_bw.untile_1d(got, t.shape, pad).numpy(), t)
    sizes = [t.size for t in tensors]
    assert t_bw.batch_layout(sizes, block) == r_bw.batch_layout(sizes, block)
    got, counts, pads = t_bw.pack_batch([torch.from_numpy(t) for t in tensors], block)
    want, rcounts, rpads = r_bw.pack_batch(tensors, block)
    assert (counts, pads) == (rcounts, rpads) and got.tobytes() == want.tobytes()
    staged, _, _ = t_bw.pack_batch(tensors[::-1], block, out=np.full_like(got, np.nan))
    again, _, _ = t_bw.pack_batch(tensors, block, out=staged)
    assert again is staged and again.tobytes() == want.tobytes()


# -- the loop: bound-class against the reference --------------------------------


@pytest.mark.parametrize("block", [64, 63])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("backend", ["local", "batched"])
def test_engine_correct_holds_bounds_like_the_reference(backend, impl, block):
    tensors = _tensors(2)
    got_c, got_e, got_s = CorrectionEngine(backend=backend, fft_impl=impl, device="cpu").correct(
        [torch.from_numpy(t) for t in tensors], E_T, D_T, block=block, max_iters=40,
        return_edits=True)
    want_c, want_e, want_s = _ref_correct(tensors, block, impl, return_edits=True)
    assert np.array_equal(got_s.block_iterations.numpy(), np.asarray(want_s.block_iterations))
    assert np.array_equal(got_s.block_converged.numpy(), np.asarray(want_s.block_converged))
    assert np.array_equal(got_s.iterations.numpy(), np.asarray(want_s.iterations))
    assert np.array_equal(got_s.converged.numpy(), np.asarray(want_s.converged))
    assert bool(got_s.converged.all()) and int(got_s.block_iterations.max()) > 1
    for g, w, t, e, d, (gs, gf), (ws, wf) in zip(got_c, want_c, tensors, E_T, D_T, got_e, want_e):
        assert g.shape == t.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
        assert_pencils_within(g, e, d, block)
        assert gs.shape == ws.shape and gf.shape == wf.shape == (gs.shape[0], block // 2 + 1)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_local_and_batched_are_bitwise_equal(impl):
    tensors = [torch.from_numpy(t) for t in _tensors(3)]
    outs = [CorrectionEngine(backend=b, fft_impl=impl, device="cpu").correct(
        tensors, E_T, D_T, block=64, max_iters=40, return_edits=True) for b in ("local", "batched")]
    (lc, le, ls), (bc, be, bs) = outs
    assert all(torch.equal(a, b) for a, b in zip(lc, bc))
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(le, be))
    for f in dataclasses.fields(ls):
        assert torch.equal(getattr(ls, f.name), getattr(bs, f.name))


def test_correct_batch_scalar_bounds_dtype_and_inputs_untouched():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.clip(rng.standard_normal((5, 100)) * 0.02, -0.03, 0.03))
    keep = x.clone()
    [got], stats = t_bw.correct_batch([x], 0.03, 0.2, block=64, max_iters=30)
    [want], rstats = r_bw.correct_batch([jnp.asarray(keep.numpy(), jnp.float32)], 0.03, 0.2,
                                        block=64, max_iters=30)
    assert torch.equal(x, keep)  # not donated
    assert got.dtype == torch.float64 and got.shape == x.shape
    assert np.array_equal(stats.block_iterations.numpy(), np.asarray(rstats.block_iterations))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_warm_start_is_the_references():
    tensors = _tensors(5, shapes=[(2, 300), (500,)])
    cold = _ref_correct(tensors, 64, "xla", return_edits=True)
    warm = [np.asarray(f) * 0.5 for _, f in cold[1]]
    want = _ref_correct(tensors, 64, "xla", return_edits=True, warm_freq=warm)
    got = CorrectionEngine(device="cpu").correct(
        [torch.from_numpy(t) for t in tensors], E_T[:2], D_T[:2], block=64, max_iters=40,
        return_edits=True, warm_freq=[torch.from_numpy(w) for w in warm])
    assert np.array_equal(got[2].block_iterations.numpy(), np.asarray(want[2].block_iterations))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("backend", ["local", "batched"])
def test_correct_async_equals_correct(backend):
    tensors = _tensors(6)
    eng = CorrectionEngine(backend=backend, fft_impl="pallas", device="cpu")
    want = eng.correct([torch.from_numpy(t) for t in tensors], E_T, D_T, block=64, max_iters=40,
                       return_edits=True)
    handle = eng.correct_async(tensors, E_T, D_T, block=64, max_iters=40, return_edits=True,
                               staging=np.zeros((3, 64), np.float32))
    got = handle.result()
    assert handle.result() is got
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a[1], b[1]) for a, b in zip(got[1], want[1]))
    assert torch.equal(got[2].block_iterations, want[2].block_iterations)
    empty = eng.correct_async([], 1.0, 1.0).result()
    assert empty[0] == [] and empty[1].iterations.numel() == 0


def test_bad_inputs_raise_like_the_reference():
    t = [torch.zeros(10)]
    with pytest.raises(ValueError, match="per-tensor bounds"):
        t_bw.correct_batch(t, [1.0, 2.0], 1.0, block=8)
    with pytest.raises(ValueError, match="warm spectra"):
        t_bw.correct_batch(t, 1.0, 1.0, block=8, warm_freq=[])
    with pytest.raises(ValueError, match="mesh"):
        t_bw.correct_batch(t, 1.0, 1.0, block=8, backend="sharded")
    assert t_bw.correct_batch([], 1.0, 1.0, device="cpu")[0] == []


def test_batch_stats_convert_from_the_reference():
    _, rstats = _ref_correct(_tensors(7), 64, "xla")
    stats = convert.batch_stats_from_reference(
        {f.name: np.asarray(getattr(rstats, f.name)) for f in dataclasses.fields(rstats)})
    assert stats.iterations.dtype == torch.int32 and stats.converged.dtype == torch.bool
    assert np.array_equal(stats.block_iterations.numpy(), np.asarray(rstats.block_iterations))


# -- plan_pencils / encode_pencils: byte-identical ------------------------------


PLAN_CASES = [
    dict(E_rel=1e-3, Delta_rel=1e-3),
    dict(E_rel=1e-2, Delta_rel=1e-4, quant_bits=12),
    dict(E_abs=0.01, Delta_abs=0.5),
    dict(E_rel=1e-3, Delta_abs=0.3, E_roi="mask"),
    dict(E_rel=1e-12, Delta_rel=1e-3),  # E underflows: None
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_pencils_is_the_references(case):
    kw = dict(PLAN_CASES[case])
    x = np.random.default_rng(8).lognormal(0.0, 1.0, (6, 300)).astype(np.float32)
    if kw.get("E_roi") == "mask":
        mask = np.zeros(x.shape, bool)
        mask[2:4, 50:90] = True
        kw["E_roi"] = mask
    got = CorrectionEngine(device="cpu").plan_pencils(x, block=256, **kw)
    want = RefEngine().plan_pencils(x, block=256, **kw)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert convert.pencil_plan_from_reference(dataclasses.asdict(want)) == got


@pytest.mark.parametrize("block", [256, 255])
def test_encode_pencils_bytes_are_the_references(block):
    x = np.random.default_rng(9).lognormal(0.0, 1.0, (4, 700)).astype(np.float32)
    ref = RefEngine()
    plan = ref.plan_pencils(x, E_rel=1e-3, Delta_rel=1e-3, block=block)
    base = get_compressor("szlike")
    eps0 = np.asarray(base.decompress(base.compress(x, plan.E_proj)), np.float32) - x
    _, [(spat, freq)], _ = ref.correct([jnp.asarray(eps0)], plan.E_proj, plan.Delta_proj,
                                       block=block, return_edits=True, return_corrected=False)
    spat, freq = np.array(spat), np.array(freq)
    tiles0 = RefEngine.tile_f64(eps0, block)
    assert np.array_equal(CorrectionEngine.tile_f64(eps0, block), tiles0)
    want = ref.encode_pencils(spat, freq, tiles0, plan)
    tplan = convert.pencil_plan_from_reference(dataclasses.asdict(plan))
    got = CorrectionEngine(device="cpu").encode_pencils(
        torch.from_numpy(spat), torch.from_numpy(freq), tiles0, tplan)
    assert [g.to_bytes() for g in got] == [w.to_bytes() for w in want]
