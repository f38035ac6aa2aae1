"""The port's kernel wrappers against the reference's Pallas ops.

On the CPU each ``repro_torch`` wrapper computes its plain PyTorch twin; the
reference ``ops`` functions run their Pallas kernels in interpret mode, as
the reference's own tests run them.  Clip, displacement and violation count
must agree bitwise; the forward epilogue's ``Z`` is held at rtol 1e-6 (the
reference multiplies the twiddle planes inside its kernel, the twin rounds
each product on its own).

The CUDA kernels themselves are held against these twins on the card by
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cubes import rfft_pair_weights as r_pair_weights
from repro.kernels.fcube import ops as r_fcube
from repro.kernels.rfft import ops as r_rfft
from repro.kernels.scube import ops as r_scube
from repro_torch.kernels.fcube import ops as t_fcube
from repro_torch.kernels.rfft import ops as t_rfft
from repro_torch.kernels.scube import ops as t_scube

SHAPES = [(16, 16, 18), (16, 16, 17), (40, 35), (40, 36), (24,)]
EVEN = [s for s in SHAPES if s[-1] % 2 == 0]


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(shape).astype(np.float32)
    delta = np.fft.rfftn(eps).astype(np.complex64)
    return rng, eps, delta


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.shape == np.shape(b) and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scube_matches_reference(shape, pointwise):
    rng, eps, _ = _data(shape)
    E = rng.uniform(0.3, 1.5, shape).astype(np.float32) if pointwise else 0.8
    got = t_scube.project_scube_fused(torch.from_numpy(eps), E)
    want = r_scube.project_scube_fused(jnp.asarray(eps), E)
    assert all(_eq(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("slack", [0.0, 0.3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fcube_matches_reference(shape, pointwise, weighted, slack):
    rng, _, delta = _data(shape, 1)
    D = rng.uniform(0.5, 4.0, delta.shape).astype(np.float32) if pointwise else 2.0
    got = t_fcube.project_fcube_fused(
        torch.from_numpy(delta), D, n_last=shape[-1] if weighted else None,
        check_tol=1e-5, check_slack=slack,
    )
    want = r_fcube.project_fcube_fused(
        jnp.asarray(delta), D, weight=r_pair_weights(shape) if weighted else None,
        check_tol=1e-5, check_slack=slack,
    )
    assert _eq(got[0], want[0]) and _eq(got[1], want[1])
    assert got[2].dtype == torch.int32 and int(got[2]) == int(want[2]) > 0


def test_fcube_rejects_wrong_n_last():
    delta = torch.zeros((4, 5), dtype=torch.complex64)
    with pytest.raises(ValueError, match="n_last"):
        t_fcube.project_fcube_fused(delta, 1.0, n_last=10)


@pytest.mark.parametrize("slack", [0.0, 0.3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", EVEN, ids=str)
def test_fwd_epilogue_matches_reference(shape, pointwise, weighted, slack):
    rng, _, delta = _data(shape, 2)
    D = rng.uniform(0.5, 4.0, delta.shape).astype(np.float32) if pointwise else 2.0
    clipped, disp, Z, viol = t_rfft.fwd_epilogue_fused(
        torch.from_numpy(delta), D, weighted=weighted, check_tol=1e-5, check_slack=slack
    )
    w_clipped, w_disp, w_Z, w_viol = r_rfft.fwd_epilogue_fused(
        jnp.asarray(delta), D, weight=r_pair_weights(shape) if weighted else None,
        check_tol=1e-5, check_slack=slack,
    )
    assert _eq(clipped, w_clipped) and _eq(disp, w_disp)
    assert viol.dtype == torch.int32 and int(viol) == int(w_viol) > 0
    nh = shape[-1] // 2
    assert Z.shape == shape[:-1] + (nh,) and Z.is_contiguous()
    want_Z = np.asarray(w_Z)[..., :nh]
    np.testing.assert_allclose(Z.numpy(), want_Z, rtol=1e-6, atol=1e-6 * np.abs(want_Z).max())


@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("shape", EVEN, ids=str)
def test_unpack_sclip_matches_reference(shape, pointwise):
    rng = np.random.default_rng(3)
    zshape = shape[:-1] + (shape[-1] // 2,)
    z = (rng.standard_normal(zshape) + 1j * rng.standard_normal(zshape)).astype(np.complex64)
    E = rng.uniform(0.3, 1.5, shape).astype(np.float32) if pointwise else 0.8
    got = t_rfft.unpack_sclip_fused(torch.from_numpy(z), E, shape)
    want = r_rfft.unpack_sclip_fused(jnp.asarray(z), E, shape)
    assert all(_eq(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", EVEN, ids=str)
def test_packed_transforms(shape):
    _, eps, _ = _data(shape, 4)
    x = torch.from_numpy(eps.astype(np.float64))
    X = torch.fft.rfftn(x)
    np.testing.assert_allclose(t_rfft.packed_rfftn(x).numpy(), X.numpy(), atol=1e-10)
    np.testing.assert_allclose(t_rfft.packed_irfftn(X, shape).numpy(), eps, atol=1e-10)
    line = torch.fft.rfft(x, dim=-1)
    np.testing.assert_allclose(t_rfft.packed_irfft(line, shape[-1]).numpy(), eps, atol=1e-10)
    # float32 transforms agree with the reference's jnp versions
    x32 = jnp.asarray(eps)
    np.testing.assert_allclose(
        t_rfft.packed_irfftn(torch.fft.rfftn(torch.from_numpy(eps)), shape).numpy(),
        np.asarray(r_rfft.packed_irfftn(jnp.fft.rfftn(x32), shape)), rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("shape", [(6, 5, 4), (7, 9), (10,)], ids=str)
def test_mirror_and_twiddles_identical(shape):
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    assert _eq(t_rfft.mirror_half_spectrum(torch.from_numpy(a)), r_rfft.mirror_half_spectrum(jnp.asarray(a)))
    for n in (2, 18, 256):
        for name in ("float32", "float64"):
            for got, want in zip(t_rfft.twiddle_plan(n, name), r_rfft.twiddle_plan(n, name)):
                assert got.dtype == want.dtype and np.array_equal(got, want)
    for s in [(4,), (5,), (1,), (3, 8), (3, 7), ()]:
        assert t_rfft.supports_packed(s) == r_rfft.supports_packed(s)


# -- per-pencil modes: the batched loop's vmap of the reference kernels -------

import jax  # noqa: E402

ROWS = [(6, 18), (5, 17), (4, 64), (3, 2)]  # (rows, block): even, odd, the KV shape's kind, tiny


def _rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((rows, n)).astype(np.float32)
    return rng, eps, np.fft.rfft(eps, axis=-1).astype(np.complex64)


@pytest.mark.parametrize("rows_block", ROWS, ids=str)
def test_scube_per_row_matches_vmapped_reference(rows_block):
    rows, n = rows_block
    rng, eps, _ = _rows(rows, n, 20)
    E = rng.uniform(0.3, 1.5, rows).astype(np.float32)
    got = t_scube.project_scube_fused(torch.from_numpy(eps), torch.from_numpy(E[:, None]))
    want = jax.vmap(r_scube.project_scube_fused)(jnp.asarray(eps), jnp.asarray(E))
    assert all(_eq(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("slack", [0.0, 0.3])
@pytest.mark.parametrize("rows_block", ROWS, ids=str)
def test_fcube_per_row_matches_vmapped_reference(rows_block, slack):
    rows, n = rows_block
    rng, _, delta = _rows(rows, n, 21)
    D = rng.uniform(0.5, 4.0, rows).astype(np.float32)
    got = t_fcube.project_fcube_fused(
        torch.from_numpy(delta), torch.from_numpy(D[:, None]), n_last=n,
        check_tol=1e-5, check_slack=slack, per_row=True,
    )
    want = jax.vmap(lambda d, b: r_fcube.project_fcube_fused(
        d, b, weight=r_pair_weights((n,)), check_tol=1e-5, check_slack=slack))(
        jnp.asarray(delta), jnp.asarray(D))
    assert _eq(got[0], want[0]) and _eq(got[1], want[1])
    assert got[2].dtype == torch.int32 and _eq(got[2], want[2]) and int(got[2].sum()) > 0


@pytest.mark.parametrize("rows_block", [rb for rb in ROWS if rb[1] % 2 == 0], ids=str)
def test_fwd_epilogue_per_row_matches_vmapped_reference(rows_block):
    """Clip, displacement and per-row counts bitwise; Z at rtol 1e-6 (the
    reference's XLA CPU build contracts the twiddle products; ROADMAP Queue 3)."""
    rows, n = rows_block
    rng, _, delta = _rows(rows, n, 22)
    D = rng.uniform(0.5, 4.0, rows).astype(np.float32)
    got = t_rfft.fwd_epilogue_fused(
        torch.from_numpy(delta), torch.from_numpy(D[:, None]), weighted=True, check_tol=1e-5,
        per_row=True,
    )
    want = jax.vmap(lambda d, b: r_rfft.fwd_epilogue_fused(
        d, b, weight=r_pair_weights((n,)), check_tol=1e-5))(jnp.asarray(delta), jnp.asarray(D))
    assert _eq(got[0], want[0]) and _eq(got[1], want[1]) and _eq(got[3], want[3])
    assert got[2].shape == (rows, n // 2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2])[:, : n // 2], rtol=1e-6, atol=1e-6)
    # the mirror stays within each row: a row's Z depends on that row alone
    solo = t_rfft.fwd_epilogue_fused(torch.from_numpy(delta[1:2]), float(D[1]), weighted=True,
                                      check_tol=1e-5, per_row=True)
    assert torch.equal(solo[2][0], got[2][1])


@pytest.mark.parametrize("rows_block", [rb for rb in ROWS if rb[1] % 2 == 0], ids=str)
def test_unpack_sclip_per_row_matches_vmapped_reference(rows_block):
    rows, n = rows_block
    rng = np.random.default_rng(23)
    z = (rng.standard_normal((rows, n // 2)) + 1j * rng.standard_normal((rows, n // 2))).astype(np.complex64)
    E = rng.uniform(0.3, 1.2, rows).astype(np.float32)
    got = t_rfft.unpack_sclip_fused(torch.from_numpy(z), torch.from_numpy(E[:, None]), (rows, n))
    want = jax.vmap(lambda t, e: r_rfft.unpack_sclip_fused(t, e, (n,)))(jnp.asarray(z), jnp.asarray(E))
    assert all(_eq(g, w) for g, w in zip(got, want))


def test_per_row_bound_must_have_the_row_shape():
    from repro_torch.kernels import build

    with pytest.raises(ValueError, match="per-row bound"):
        build.bound_operand(torch.ones(4, 2), (4, 9), "cpu", rows=True)
    assert build.is_row_bound(torch.ones(4, 1), (4, 9)) and not build.is_row_bound(1.0, (4, 9))
