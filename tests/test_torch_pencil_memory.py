"""The batched pencil loop after its memory repair: the same values as before.

``alternating_projection_batched`` releases each temporary once read and
updates its state in place on the stepping rows (``core/pocs.py``), and
``correct_batch`` hands the loop its own packed buffer (``donate``).  The
oracle here is the loop as it was written before that change, out of place:
each iteration's sums and selections made with ``torch.where`` into fresh
tensors while the old ones were still referenced.  Every case holds the
repaired loop to it bitwise (eps, both edit streams, per-row iterations,
converged flags and violation counts) on a packed batch whose rows stop at
different iterations, for each ``fft_impl`` (``"pallas"`` runs the kernels'
plain twins here: the fused epilogues for an even block, the fused fcube/
scube kernels for an odd one), cold and warm started.  The reference-parity
tests of the loop are in ``test_torch_blockwise.py`` and
``test_torch_pocs_engine.py``, unchanged.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import blockwise
from repro_torch.core.cubes import project_fcube, project_scube
from repro_torch.core.pocs import _CHECK_TOL, alternating_projection_batched
from repro_torch.kernels.fcube import ops as fcube_ops
from repro_torch.kernels.rfft import ops as rfft_ops
from repro_torch.kernels.scube import ops as scube_ops

IMPLS = ["xla", "packed", "pallas"]
BLOCKS = [64, 63]
MAX_ITERS = 6


def _loop_before_repair(eps0, E, Delta, max_iters, fft_impl, warm_freq=None):
    """The batched loop as written before the memory repair (out of place)."""
    rows, n = eps0.shape
    dev = eps0.device
    per_row = lambda b: torch.broadcast_to(  # noqa: E731
        torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(-1), (rows,)).reshape(rows, 1).contiguous()
    E, Delta = per_row(E), per_row(Delta)
    packed_ok = fft_impl != "xla" and rfft_ops.supports_packed((n,))
    pallas_fused = fft_impl == "pallas" and packed_ok
    use_kernels = fft_impl == "pallas" and not packed_ok
    h = n // 2 + 1
    fwd = lambda e: torch.fft.rfft(e, dim=-1).contiguous()  # noqa: E731
    if packed_ok:
        inv = lambda d: rfft_ops.packed_irfft(d, n).contiguous()  # noqa: E731
    else:
        inv = lambda d: torch.fft.irfft(d, n=n, dim=-1).contiguous()  # noqa: E731
    tol1, slack = fcube_ops.threshold_scalars(_CHECK_TOL, 0.0)
    dt = Delta * torch.tensor(tol1, device=dev) + torch.tensor(slack, device=dev)

    def count_violations(delta):
        vb = ((torch.abs(delta.real) > dt) | (torch.abs(delta.imag) > dt)).to(torch.int32)
        viol = 2 * torch.sum(vb, dim=-1) - vb[:, 0]
        if n % 2 == 0 and h > 1:
            viol = viol - vb[:, -1]
        return viol.to(torch.int32)

    if warm_freq is None:
        eps, spat = eps0, torch.zeros_like(eps0)
        freq = torch.zeros((rows, h), dtype=torch.complex64, device=dev)
    else:
        freq = warm_freq.clone()
        eps, spat = project_scube(eps0 + inv(freq), E)
    iterations = torch.zeros(rows, dtype=torch.int32)
    done = torch.zeros(rows, dtype=torch.bool)
    viol_state = torch.full((rows,), -1, dtype=torch.int32)
    active = torch.ones(rows, dtype=torch.bool)
    it, stepping_any = 0, rows > 0
    while stepping_any and it < max_iters:
        delta = fwd(eps)
        if pallas_fused:
            _clipped, f_disp, Z, viol = rfft_ops.fwd_epilogue_fused(
                delta, Delta, weighted=True, check_tol=_CHECK_TOL, per_row=True)
        elif use_kernels:
            clipped, f_disp, viol = fcube_ops.project_fcube_fused(
                delta, Delta, n_last=n, check_tol=_CHECK_TOL, per_row=True)
        else:
            clipped, f_disp = project_fcube(delta, Delta)
            viol = count_violations(delta)
        done_now = viol == 0
        stepping = active & ~done_now
        stepping_any = bool(stepping.any())
        if stepping_any:
            if pallas_fused:
                z = torch.fft.ifft(Z, dim=-1).contiguous()
                eps_s, s_disp = rfft_ops.unpack_sclip_fused(z, E, (rows, n))
            elif use_kernels:
                eps_s, s_disp = scube_ops.project_scube_fused(inv(clipped), E)
            else:
                eps_s, s_disp = project_scube(inv(clipped), E)
            col = stepping[:, None]
            freq = torch.where(col, freq + f_disp, freq)
            spat = torch.where(col, spat + s_disp, spat)
            eps = torch.where(col, eps_s, eps)
        viol_state = torch.where(active, viol, viol_state)
        done = done | (active & done_now)
        iterations += active.to(torch.int32)
        active = stepping
        it += 1
    return (eps, spat, freq, iterations, done,
            torch.where(done, torch.zeros_like(viol_state), viol_state))


def _batch(n, rows=24, seed=0):
    """Rows of spatial errors near the s-cube's faces (as a quantizer's
    errors are) against f-bounds from 0.3 to 3 times ``E * sqrt(n)``: the
    rows stop after 1 to 9 iterations, so a cap of 6 leaves some unconverged."""
    rng = np.random.default_rng(seed)
    E = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    eps0 = np.sign(rng.standard_normal((rows, n))) * rng.uniform(0.8, 1.0, (rows, n)) * E[:, None]
    Delta = E * np.sqrt(n) * np.geomspace(0.3, 3.0, rows)
    return (torch.from_numpy(eps0.astype(np.float32)), torch.from_numpy(E),
            torch.from_numpy(Delta.astype(np.float32)))


def _warm(eps0, E, Delta):
    """A warm-start spectrum: a few iterations' freq edits of a nearby batch."""
    return alternating_projection_batched(eps0 * 0.9, E, Delta, max_iters=3).freq_edits


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.view_as_real(a) if a.is_complex() else a, torch.view_as_real(b) if b.is_complex() else b)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("impl", IMPLS)
def test_batched_loop_is_bitwise_what_it_was(impl, block, warm):
    eps0, E, Delta = _batch(block)
    warm_freq = _warm(eps0, E, Delta) if warm else None
    before = eps0.clone()
    want = _loop_before_repair(eps0, E, Delta, MAX_ITERS, impl, warm_freq)
    got = alternating_projection_batched(eps0, E, Delta, max_iters=MAX_ITERS, fft_impl=impl, warm_freq=warm_freq)
    assert torch.equal(eps0, before)  # not donated: the input is not written
    assert len(set(want[3].tolist())) > 3 and not bool(want[4].all())  # rows stop apart; some not at all
    fields = (got.eps, got.spat_edits, got.freq_edits, got.iterations, got.converged, got.final_violations)
    for name, w, g in zip(("eps", "spat", "freq", "iterations", "converged", "violations"), want, fields):
        assert _bitwise(g, w), name


@pytest.mark.parametrize("impl", IMPLS)
def test_donated_loop_writes_its_eps_into_the_buffer(impl):
    eps0, E, Delta = _batch(64, seed=1)
    want = _loop_before_repair(eps0.clone(), E, Delta, MAX_ITERS, impl)
    buf = eps0.clone()
    got = alternating_projection_batched(buf, E, Delta, max_iters=MAX_ITERS, fft_impl=impl, donate=True)
    assert got.eps.data_ptr() == buf.data_ptr()
    assert _bitwise(got.eps, want[0]) and _bitwise(got.spat_edits, want[1]) and _bitwise(got.freq_edits, want[2])


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("impl", IMPLS)
def test_correct_batch_is_bitwise_what_it_was(impl, block):
    """``correct_batch`` (the packed buffer donated, the tilings released,
    the outputs made after the edit streams are dropped) against the old
    loop run on the same packed buffer and unpacked per tensor."""
    rng = np.random.default_rng(3)
    shapes = [(5, 40), (block * 3,), (7,), (2, 3, block)]
    E = [1.0, 0.5, 2.0, 1.5]
    tensors = [torch.from_numpy((np.sign(rng.standard_normal(s)) * rng.uniform(0.8, 1.0, s) * e).astype(np.float32))
               for s, e in zip(shapes, E)]
    copies = [t.clone() for t in tensors]
    Delta = [e * block ** 0.5 * f for e, f in zip(E, (0.5, 0.8, 3.0, 1.2))]
    corrected, edits, stats = blockwise.correct_batch(tensors, E, Delta, block=block, max_iters=MAX_ITERS,
                                                      return_edits=True, fft_impl=impl, device="cpu")
    only, _ = blockwise.correct_batch(tensors, E, Delta, block=block, max_iters=MAX_ITERS, fft_impl=impl, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tensors, copies))
    tiles = [blockwise.tile_1d(t, block) for t in tensors]
    counts = [x.shape[0] for x, _ in tiles]
    seg = torch.repeat_interleave(torch.arange(len(tensors)), torch.tensor(counts))
    eps, spat, freq, iters, conv, _ = _loop_before_repair(
        torch.cat([x for x, _ in tiles]), torch.tensor(E)[seg], torch.tensor(Delta)[seg], MAX_ITERS, impl)
    assert len(set(iters.tolist())) > 1
    offsets = np.cumsum([0] + counts)
    for i, (t, (_, pad)) in enumerate(zip(tensors, tiles)):
        a, b = offsets[i], offsets[i + 1]
        want = blockwise.untile_1d(eps[a:b], t.shape, pad)
        assert _bitwise(corrected[i], want) and _bitwise(only[i], want)
        assert _bitwise(edits[i][0], spat[a:b]) and _bitwise(edits[i][1], freq[a:b])
    assert torch.equal(stats.block_iterations, iters) and torch.equal(stats.block_converged, conv)
