"""The QuantizeEdits and block-transform twins against the reference's ops.

The same seeded numpy inputs go through the reference's public ops (their
Pallas kernels in interpret mode on the CPU, as the reference's own tests run
them) and the port's wrappers (on the CPU: the plain twins).

* QuantizeEdits: bitwise.  The step ``2b / 2^m`` is exact in float32, the
  division is IEEE on both sides and both round half to even.  Values are
  drawn so that ``|v / step| < 2^31``: out of that range the reference's
  float -> int32 cast is XLA's own business, while the port saturates.
* Block transform: XLA's CPU dot sums the B products in its own order, and
  the twin sums them in order ``k = 0 .. B-1`` with a rounding after every
  multiply and add.  So a code may differ where the coefficient lies next to
  a rounding tie.  Every difference must be ±1, and there the float64
  coefficient must lie within ``B * 2^-23 * sum_k |x_k M_jk| / q`` of a
  half-integer: the bound on the float32 summation error of either order
  (B roundings, each at most one float32 ulp of the running sum's magnitude).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as t_kernels
from repro.compressors.zfplike import ZFPLikeCompressor
from repro.kernels.block_transform.ops import block_transform_quantize as r_block_transform
from repro.kernels.quantize.ops import quantize_edits as r_quantize
from repro_torch.kernels.block_transform import ops as t_bt
from repro_torch.kernels.quantize import ops as t_quantize
from repro_torch.kernels.quantize.ref import saturating_int32

SHAPES = [(1000,), (37, 29), (9, 11, 13)]  # none a multiple of the reference's 256 x 128 tile


def _values(shape, m, seed):
    rng = np.random.default_rng(seed)
    bound = 0.05
    v = (rng.standard_normal(shape) * bound).astype(np.float32)
    # exact ties v / step = k + 1/2 exercise round-half-to-even
    step = np.float32(2 * bound / 2**m)
    v.reshape(-1)[::7] = ((np.arange(v.size)[::7] % 11) - 5 + 0.5).astype(np.float32) * step
    return rng, v, bound


@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("m", [8, 16, 24])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_matches_reference(shape, m, pointwise):
    rng, v, bound = _values(shape, m, seed=m)
    if pointwise:
        b = rng.uniform(0.5, 1.5, shape).astype(np.float32) * bound
        b.reshape(-1)[::5] = 0.0  # step 0 gives code 0
    else:
        b = bound
    got_codes, got_flags = t_quantize.quantize_edits(torch.from_numpy(v), b, m=m)
    want_codes, want_flags = r_quantize(jnp.asarray(v), b, m=m)
    assert got_codes.dtype == got_flags.dtype == torch.int32
    assert np.array_equal(got_codes.numpy(), np.asarray(want_codes))
    assert np.array_equal(got_flags.numpy(), np.asarray(want_flags))
    assert got_flags.numpy().any() and not got_flags.numpy().all()


def test_quantize_zero_scalar_bound_and_signature():
    v = torch.from_numpy(np.linspace(-1, 1, 50, dtype=np.float32))
    codes, flags = t_kernels.quantize_edits(v, 0.0, 16, block_rows=8, interpret=True)
    assert not codes.any() and not flags.any()
    with pytest.raises(ValueError, match="m must be"):
        t_quantize.quantize_edits(v, 1.0, m=200)


def test_saturating_cast():
    r = torch.tensor([2.0**31, -(2.0**31), -(2.0**32), 3e9, float("nan"), float("inf"), -7.0])
    got = saturating_int32(r).tolist()
    assert got == [2**31 - 1, -(2**31), -(2**31), 2**31 - 1, 0, 2**31 - 1, -7]


def dct4_kron(B):
    """zfplike's 4-point DCT Kronecker-expanded over a 4^3 block (B = 64), or
    paired with a 2-point Haar step over two such blocks (B = 128)."""
    mat = ZFPLikeCompressor()._fwd
    out = np.kron(mat, np.kron(mat, mat))
    if B == 128:
        out = np.kron(np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0), out)
    return out.astype(np.float32)


def _random_orthonormal(B, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((B, B)))
    return q.astype(np.float32)


@pytest.mark.parametrize("matrix", ["dct4", "random"])
@pytest.mark.parametrize("B", [64, 128])
def test_block_transform_matches_reference(B, matrix):
    nb = 1000  # not a multiple of the reference's 512-row tile
    rng = np.random.default_rng(B)
    x = rng.lognormal(0.0, 1.0, (nb, B)).astype(np.float32)
    mat = dct4_kron(B) if matrix == "dct4" else _random_orthonormal(B, B + 1)
    gain = float(np.max(np.abs(ZFPLikeCompressor()._inv).sum(axis=1)))
    q = 2.0 * 1e-3 * float(np.ptp(x)) / gain**3
    got = t_bt.block_transform_quantize(torch.from_numpy(x), torch.from_numpy(mat), q).numpy()
    want = np.asarray(r_block_transform(jnp.asarray(x), jnp.asarray(mat), q))
    assert got.dtype == np.int32 and got.shape == (nb, B)
    diff = got.astype(np.int64) - want
    assert np.abs(diff).max() <= 1
    # every difference sits next to a rounding tie of the exact coefficient
    qf = float(np.float32(q))
    exact = x.astype(np.float64) @ mat.astype(np.float64).T / qf
    slack = B * 2.0**-23 * (np.abs(x).astype(np.float64) @ np.abs(mat).astype(np.float64).T) / qf
    where = diff != 0
    dist_to_tie = np.abs(np.abs(exact - np.floor(exact)) - 0.5)
    assert np.all(dist_to_tie[where] <= slack[where])
    assert (got != 0).mean() > 0.5  # the codes carry information


def test_block_transform_checks_shapes():
    with pytest.raises(ValueError, match=r"\(B, B\)"):
        t_kernels.block_transform_quantize(torch.zeros((4, 64)), torch.zeros((32, 32)), 1.0)
