"""Pack-trick C2R/R2C transforms + the fused projection epilogues of the loop.

The pack trick computes an N-point real transform through an N/2-point
*complex* one plus O(N) twiddle work:

  forward (R2C):  pack ``z[n] = x[2n] + i x[2n+1]``, take the complex FFT
    ``Z`` over all axes, and recombine ``X[k] = E[k] + w_fwd[k] O[k]`` with
    ``E = (Z + conj(Z~))/2``, ``O = (Z - conj(Z~))/(2i)``, where ``Z~`` is the
    Hermitian mirror ``Z[-k0, .., Nh-k]`` and ``w_fwd[k] = exp(-2 pi i k / N)``.
  inverse (C2R):  ``E = (X + conj(X~))/2``, ``O = w_inv (X - conj(X~))/2``
    with ``w_inv[k] = exp(+2 pi i k / N)``, then ``z = ifftn(E + iO)`` over
    all axes at half the last-axis length; ``x[2n] = Re z[n]``,
    ``x[2n+1] = Im z[n]``.

``fft_impl="packed"`` uses :func:`packed_irfftn` as the loop's inverse.
``fft_impl="pallas"`` (the name is kept from the reference package) runs two
fused epilogues around cuFFT instead:

* :func:`fwd_epilogue_fused` — one pass over the forward half-spectrum: f-cube
  clip, edit displacement, pair-weighted violation count, and the inverse pack
  twiddle, emitting ``Z`` (``(..., N/2)``, contiguous) for the half-length
  ``ifftn``.  Kernel: ``csrc/rfft.cu``; it replaces the reference's
  ``_rfft_fwd_epilogue_kernel``.
* :func:`unpack_sclip_fused` — the s-cube clip of the ``ifftn`` output.  The
  complex output ``z`` is stored as interleaved ``(Re, Im) = (even, odd)``
  samples, so ``view_as_real(z).reshape(shape)`` *is* the de-interleaved
  field; the clip runs on that view with ``E`` in natural layout.  It
  launches the s-cube kernel (``csrc/scube.cu``) and counts under its own
  name; it replaces the reference's ``_unpack_sclip_kernel``.

Per-pencil mode (the batched pencil loop's vmap of the reference kernels):
every leading index is an independent row whose last axis is one 1-D signal.
:func:`fwd_epilogue_fused` with ``per_row=True`` mirrors within the row only
(the leading axis is a batch, not a frequency axis), takes a scalar or
per-row ``Delta`` (shape ``delta.shape[:-1] + (1,)``) and counts per row;
:func:`unpack_sclip_fused` given a per-row ``E`` launches the s-cube kernel's
per-row mode.  The half-length inverse between them is ``torch.fft.ifft``
over the last axis.  They count under ``rfft_fwd_epilogue_rows`` and
``unpack_sclip_rows``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.cubes import rfft_pair_weights
from repro_torch.kernels import build
from repro_torch.kernels.fcube.ops import threshold_scalars
from repro_torch.kernels.scube.ops import project_scube_plain, scube_launch

#: kernel launches by wrapper (reset them to 0 to count a run's launches)
launches = {
    "rfft_fwd_epilogue": 0, "rfft_fwd_epilogue_rows": 0, "unpack_sclip": 0, "unpack_sclip_rows": 0,
}


# ---------------------------------------------------------------------------
# twiddles and layout helpers


@functools.lru_cache(maxsize=None)
def twiddle_plan(n: int, dtype_name: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """Pack-trick twiddles for an even last-axis length ``n``.

    Returns ``(w_fwd, w_inv)``, each of shape ``(n // 2 + 1,)``:
    ``w_fwd[k] = exp(-2 pi i k / n)`` and its conjugate.  Built in float64
    and rounded once to the working precision.
    """
    if n % 2:
        raise ValueError(f"pack-trick transforms need an even last axis, got {n}")
    k = np.arange(n // 2 + 1)
    w = np.exp((-2j * np.pi / n) * k)
    cdtype = np.complex64 if dtype_name == "float32" else np.complex128
    return w.astype(cdtype), np.conj(w).astype(cdtype)


@functools.lru_cache(maxsize=None)
def _w_inv_tensor(n: int, device: str) -> torch.Tensor:
    """``twiddle_plan(n)[1]`` as a complex64 tensor on ``device``."""
    return torch.from_numpy(twiddle_plan(n, "float32")[1]).to(device)


def supports_packed(shape: Tuple[int, ...]) -> bool:
    """True when the pack trick applies: even last axis of at least 2."""
    return len(shape) >= 1 and shape[-1] >= 2 and shape[-1] % 2 == 0


def mirror_half_spectrum(a: torch.Tensor) -> torch.Tensor:
    """Hermitian mirror index map ``a[k0, .., k] -> a[-k0, .., Nh-k]``.

    Leading axes are negated modulo their extent (flip + roll); the last
    (half-spectrum, ``Nh + 1``-long) axis is reflected in place.
    """
    for ax in range(a.ndim - 1):
        a = torch.roll(torch.flip(a, dims=(ax,)), 1, dims=ax)
    return torch.flip(a, dims=(a.ndim - 1,))


def _dtype_name(t: torch.Tensor) -> str:
    return "float32" if t.dtype in (torch.float32, torch.complex64) else "float64"


def _interleave_last(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Riffle two (..., Nh) planes into (..., 2*Nh): out[2n]=even, out[2n+1]=odd."""
    out = torch.stack([even, odd], dim=-1)
    return out.reshape(*even.shape[:-1], even.shape[-1] * 2)


# ---------------------------------------------------------------------------
# plain packed transforms (fft_impl="packed")


def packed_rfftn(x: torch.Tensor) -> torch.Tensor:
    """``torch.fft.rfftn`` via the pack trick (complex FFT at half the last axis)."""
    n = x.shape[-1]
    w_fwd = torch.from_numpy(twiddle_plan(n, _dtype_name(x))[0]).to(x.device)
    Z = torch.fft.fftn(torch.complex(x[..., 0::2], x[..., 1::2]))
    Zf = torch.cat([Z, Z[..., :1]], dim=-1)  # periodic extension to k=Nh
    Zm = torch.conj(mirror_half_spectrum(Zf))
    E = 0.5 * (Zf + Zm)
    O = -0.5j * (Zf - Zm)
    return E + w_fwd * O


def packed_irfftn(X: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``torch.fft.irfftn(X, s=shape)`` via the pack trick.

    One Hermitian-mirror gather, one twiddle recombination, one complex
    ``ifftn`` at half the last-axis length, one de-interleave.
    """
    n = shape[-1]
    w = torch.from_numpy(twiddle_plan(n, _dtype_name(X))[1][: n // 2]).to(X.device)
    Xm = torch.conj(mirror_half_spectrum(X))[..., : n // 2]
    Xs = X[..., : n // 2]
    z = torch.fft.ifftn(0.5 * ((Xs + Xm) + 1j * (w * (Xs - Xm))))
    return _interleave_last(z.real, z.imag)


def packed_irfft(X: torch.Tensor, n: int) -> torch.Tensor:
    """Last-axis-only pack-trick C2R: ``torch.fft.irfft(X, n, dim=-1)``."""
    w = torch.from_numpy(twiddle_plan(n, _dtype_name(X))[1][: n // 2]).to(X.device)
    Xm = torch.conj(torch.flip(X, dims=(X.ndim - 1,)))[..., : n // 2]
    Xs = X[..., : n // 2]
    z = torch.fft.ifft(0.5 * ((Xs + Xm) + 1j * (w * (Xs - Xm))), dim=-1)
    return _interleave_last(z.real, z.imag)


# ---------------------------------------------------------------------------
# fused epilogues (fft_impl="pallas")


def fwd_epilogue_plain(
    delta: torch.Tensor, Delta, weighted: bool = False, check_tol: float = 0.0, check_slack=0.0,
    per_row: bool = False,
):
    """Plain twin of :func:`fwd_epilogue_fused`, on real float32 tensors.

    The mirror is explicit (``mirror_half_spectrum`` of the spectrum and of
    a pointwise bound, or a flip of the last axis only with ``per_row``) and
    every product and sum of the twiddle step is its own rounded operation,
    in the kernel's order.
    """
    h = delta.shape[-1]
    nh = h - 1
    xr = delta.real.to(torch.float32)
    xi = delta.imag.to(torch.float32)
    d = torch.as_tensor(Delta, dtype=torch.float32, device=delta.device)
    cr = torch.clamp(xr, -d, d)
    ci = torch.clamp(xi, -d, d)
    tol1, slack = threshold_scalars(check_tol, check_slack)
    dt = d * torch.tensor(tol1, device=d.device) + torch.tensor(slack, device=d.device)
    vb = ((torch.abs(xr) > dt) | (torch.abs(xi) > dt)).to(torch.int32)
    if weighted:
        vb = vb * rfft_pair_weights((2 * nh,), device=delta.device).reshape(-1)
    viol = (torch.sum(vb, dim=-1) if per_row else torch.sum(vb)).to(torch.int32)
    mirror = _flip_last if per_row else mirror_half_spectrum
    m = mirror(delta)
    dm = mirror(torch.broadcast_to(d, delta.shape)) if d.ndim else d
    cmr = torch.clamp(m.real.to(torch.float32), -dm, dm)[..., :nh]
    cmi = torch.clamp(m.imag.to(torch.float32), -dm, dm)[..., :nh]
    w = _w_inv_tensor(2 * nh, str(delta.device))[:nh]
    wr, wi = w.real, w.imag
    c_r, c_i = cr[..., :nh], ci[..., :nh]
    er = 0.5 * (c_r + cmr)
    ei = 0.5 * (c_i - cmi)
    tr = c_r - cmr
    ti = c_i + cmi
    o_r = 0.5 * (wr * tr - wi * ti)
    o_i = 0.5 * (wr * ti + wi * tr)
    Z = torch.complex(er - o_i, ei + o_r)
    clipped = torch.complex(cr, ci).to(delta.dtype)
    edits = torch.complex(cr - xr, ci - xi).to(delta.dtype)
    return clipped, edits, Z.to(delta.dtype), viol


def _flip_last(a: torch.Tensor) -> torch.Tensor:
    """The per-row Hermitian mirror ``a[r, k] -> a[r, Nh - k]``."""
    return torch.flip(a, dims=(a.ndim - 1,))


def fwd_epilogue_fused(
    delta: torch.Tensor, Delta, weighted: bool = False, check_tol: float = 0.0, check_slack=0.0,
    per_row: bool = False,
):
    """Fused forward epilogue: f-clip + pair-weighted count + inverse twiddle.

    ``delta`` is the ``rfftn`` half-spectrum of a real field with an even
    last axis ``N`` (so its last axis is ``N/2 + 1``); ``weighted`` applies
    the conjugate-pair weights to the count (None-weight semantics when
    False).

    Returns ``(clipped, displacement, Z, violations)``: ``Z`` has shape
    ``(..., N/2)``, contiguous, ready for ``torch.fft.ifftn`` (``ifft`` over
    the last axis with ``per_row``); ``violations`` is an int32 0-d tensor,
    or one count per row with ``per_row`` (see the module docstring).  CPU
    tensors take :func:`fwd_epilogue_plain`; CUDA tensors launch
    ``csrc/rfft.cu`` (complex64; rank 1 to 4 for the whole-field mode).
    """
    if delta.shape[-1] < 2:
        raise ValueError("the pack trick needs a half-spectrum of at least 2 columns")
    if delta.device.type == "cpu":
        return fwd_epilogue_plain(delta, Delta, weighted, check_tol, check_slack, per_row)
    build.check_cuda(delta, "delta", torch.complex64)
    if per_row:
        return _fwd_epilogue_rows(delta, Delta, weighted, check_tol, check_slack)
    if not 1 <= delta.ndim <= 4:
        raise ValueError(f"the CUDA forward epilogue takes rank 1 to 4, got {delta.ndim}")
    lead = (1,) * (4 - delta.ndim) + tuple(delta.shape[:-1])  # (d0, d1, d2)
    h = delta.shape[-1]
    grid, scalar, pointwise = build.bound_operand(Delta, delta.shape, delta.device)
    tol1, slack = threshold_scalars(check_tol, check_slack)
    clipped = torch.empty_like(delta)
    edits = torch.empty_like(delta)
    Z = torch.empty(tuple(delta.shape[:-1]) + (h - 1,), dtype=delta.dtype, device=delta.device)
    viol = torch.zeros((), dtype=torch.int32, device=delta.device)
    w_inv = _w_inv_tensor(2 * (h - 1), str(delta.device))
    err = build.library("rfft").rfft_fwd_epilogue_launch(
        delta.data_ptr(), grid.data_ptr() if pointwise else None, scalar, pointwise,
        w_inv.data_ptr(), tol1, slack, int(weighted), lead[0], lead[1], lead[2], h,
        clipped.data_ptr(), edits.data_ptr(), Z.data_ptr(), viol.data_ptr(),
        torch.cuda.current_stream(delta.device).cuda_stream,
    )
    build.check(err, "rfft_fwd_epilogue")
    launches["rfft_fwd_epilogue"] += 1
    return clipped, edits, Z, viol


def _fwd_epilogue_rows(delta: torch.Tensor, Delta, weighted: bool, check_tol: float, check_slack):
    """The per-pencil launch of :func:`fwd_epilogue_fused` (CUDA tensors)."""
    h = delta.shape[-1]
    operand, scalar, mode = build.bound_operand(Delta, delta.shape, delta.device, rows=True)
    tol1, slack = threshold_scalars(check_tol, check_slack)
    clipped = torch.empty_like(delta)
    edits = torch.empty_like(delta)
    Z = torch.empty(tuple(delta.shape[:-1]) + (h - 1,), dtype=delta.dtype, device=delta.device)
    viol = torch.zeros(delta.shape[:-1], dtype=torch.int32, device=delta.device)
    w_inv = _w_inv_tensor(2 * (h - 1), str(delta.device))
    err = build.library("rfft").rfft_fwd_epilogue_rows_launch(
        delta.data_ptr(), operand.data_ptr() if mode else None, scalar, int(mode == 2),
        w_inv.data_ptr(), tol1, slack, int(weighted), viol.numel(), h,
        clipped.data_ptr(), edits.data_ptr(), Z.data_ptr(), viol.data_ptr(),
        torch.cuda.current_stream(delta.device).cuda_stream,
    )
    build.check(err, "rfft_fwd_epilogue_rows")
    launches["rfft_fwd_epilogue_rows"] += 1
    return clipped, edits, Z, viol


def unpack_sclip_plain(z: torch.Tensor, E, shape: Tuple[int, ...]):
    """Plain twin of :func:`unpack_sclip_fused`: de-interleave, then clip."""
    x = _interleave_last(z.real, z.imag).reshape(shape)
    return project_scube_plain(x, E)


def unpack_sclip_fused(z: torch.Tensor, E, shape: Tuple[int, ...]):
    """Fused inverse epilogue: s-cube clip of the half-length ``ifftn`` output.

    ``z`` (complex64, ``(..., N/2)``, contiguous) holds the even/odd spatial
    samples of the ``shape``-sized field as its Re/Im parts, so its real view
    is the field itself.  ``E`` is a scalar or a field-shaped grid in natural
    layout, or one value per row (shape ``shape[:-1] + (1,)``, the per-pencil
    mode).  Returns ``(eps_clipped, displacement)``, real float32 of
    ``shape``.
    """
    if z.device.type == "cpu":
        return unpack_sclip_plain(z, E, shape)
    build.check_cuda(z, "z", torch.complex64)
    x = torch.view_as_real(z).reshape(shape)
    out, edit = scube_launch(x, E)
    launches["unpack_sclip_rows" if build.is_row_bound(E, x.shape) else "unpack_sclip"] += 1
    return out, edit
