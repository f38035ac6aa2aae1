"""The clients' quantizers as their contracts state them, in float32.

The program rounds in float32 and divides by a tensor (IEEE division), so
these are bitwise the errors it corrects: a difference here would be a
fault of the program's quantizer, and it shows as a gap.
"""

from __future__ import annotations

import torch


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def kv_errors(sub: torch.Tensor, bits: int, E_rel: float, Delta_rel: float, block: int):
    """One KV leaf cut into sub-tensors ``(n, b, hkv, S, hd)``: each
    sub-tensor's pencils over the sequence axis ``(n, b, hkv, hd, S)``
    (float32), its quantization error there, ``E = E_rel * max |x|`` and
    ``Delta = Delta_rel * block * E`` (``(n,)`` each)."""
    xt = sub.to(torch.float32).transpose(-2, -1)
    amax = torch.amax(torch.abs(xt), dim=tuple(range(1, xt.ndim)))
    E = _f32(E_rel, xt) * torch.clamp_min(amax, 1e-30)
    step = (2.0 * E / _f32(2.0**bits, xt)).reshape((-1,) + (1,) * (xt.ndim - 1))
    err = torch.round(xt / step) * step - xt
    return xt, err, E, _f32(Delta_rel * block, xt) * E


def grad_bounds(g: torch.Tensor, E_rel: float, Delta_rel: float, block: int):
    """One gradient leaf's ``E = E_rel * max |g|`` and ``Delta = Delta_rel *
    block * E`` (``block`` the call's, also for a leaf shorter than it)."""
    E = _f32(E_rel, g) * torch.max(torch.abs(g.to(torch.float32)))
    return E, _f32(Delta_rel * block, g) * E


def grad_error(g: torch.Tensor, E: torch.Tensor, bits: int) -> torch.Tensor:
    """The quantization error (float32, ``g``'s shape) of values of a leaf
    whose bound is ``E``: the grid's step is ``2 E / 2^bits`` (at least
    1e-30), the dequantized value is cast back to ``g``'s dtype before the
    error is taken."""
    g32 = g.to(torch.float32)
    step = torch.clamp_min(2.0 * E / _f32(2.0**bits, g32), 1e-30)
    gq = (torch.round(g32 / step) * step).to(g.dtype)
    return (gq - g).to(torch.float32)


def pencils(flat: torch.Tensor, block: int) -> torch.Tensor:
    """``flat`` (1-D) cut every ``block`` values, the last pencil zero padded."""
    pad = (-flat.numel()) % block
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
