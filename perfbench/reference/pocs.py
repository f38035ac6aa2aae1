"""Alternating projection on independent pencils, in float64.

Each pencil's error ``eps`` is checked against the f-cube (every ``|Re|``
and ``|Im|`` of its real FFT within ``Delta * (1 + 1e-5)``); while it lies
outside, its spectrum is clipped to the cube, transformed back and clipped
to ``[-E, E]``, at most ``max_iters`` times.  That is Algorithm 1 of the
FFCz paper as the pencil clients run it, one pencil at a time: a pencil that
passes a check stops there.
"""

from __future__ import annotations

import torch

CHECK_TOL = 1e-5


def project(eps: torch.Tensor, E: torch.Tensor, Delta: torch.Tensor, max_iters: int,
            rounding=None):
    """Correct the pencils ``eps`` ``(P, n)``; ``E``, ``Delta`` ``(P,)``.

    Returns ``(corrected, iterations, converged)``.  Computed in ``eps``'s
    dtype; ``rounding``, where given, rounds the state after every step
    (the control's lower precision)."""
    P, n = eps.shape
    eps = eps.clone() if rounding is None else rounding(eps)
    E, Delta = E.reshape(P, 1).to(eps.dtype), Delta.reshape(P, 1).to(eps.dtype)
    limit = Delta * (1.0 + CHECK_TOL)
    iterations = torch.zeros(P, dtype=torch.int32, device=eps.device)
    converged = torch.zeros(P, dtype=torch.bool, device=eps.device)
    rows = torch.arange(P, device=eps.device)
    for _ in range(max_iters):
        if rows.numel() == 0:
            break
        spec = torch.fft.rfft(eps[rows], dim=-1)
        lim = limit[rows]
        outside = ((spec.real.abs() > lim) | (spec.imag.abs() > lim)).any(dim=-1)
        iterations[rows] += 1
        converged[rows[~outside]] = True
        rows, spec = rows[outside], spec[outside]
        if rows.numel() == 0:
            break
        d = Delta[rows]
        clipped = torch.complex(torch.maximum(torch.minimum(spec.real, d), -d),
                                torch.maximum(torch.minimum(spec.imag, d), -d))
        x = torch.fft.irfft(clipped, n=n, dim=-1)
        e = E[rows]
        x = torch.maximum(torch.minimum(x, e), -e)
        eps[rows] = x if rounding is None else rounding(x)
    return eps, iterations, converged
