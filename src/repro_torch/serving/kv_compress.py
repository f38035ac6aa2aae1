"""FFCz KV-cache compression.

After prefill, the resident K/V tensors are quantized to ``bits`` and the
quantization error is FFCz-corrected blockwise along the sequence dimension:
the spatial bound E keeps each cached activation within E of the exact value
(in float32, before the cache's own dtype rounds it); the frequency bound
keeps the *spectrum over positions* within Delta.  The cache stores the
quantize+correct round trip.

``compress_cache`` quantizes every K/V sub-tensor of the cache and corrects
ALL the quantization errors in ONE :meth:`CorrectionEngine.correct` call
(per-sub-tensor bounds, per-pencil convergence), as the reference does.  The
port's cache is a dict whose ``k`` and ``v`` are ``(n_layers, b, hkv, S,
hd)``: each splits into ``n_layers`` sub-tensors (the reference's
``ndim > 4`` branch); ``pos`` is left alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import CorrectionEngine, default_engine


def _f32(v: float, device) -> torch.Tensor:
    """A Python float as a float32 tensor, as JAX rounds a weak scalar."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _quantize_pencils(kv: torch.Tensor, bits: int, E_rel: float, batched: bool = False):
    """Swap to (..., hd, S) pencils and quantize; returns (xt, err, E).

    With ``batched`` the leading axis indexes independent sub-tensors, each
    quantized against its own amax (``E`` is then a vector).  The frequency
    bound is the caller's: Delta = Delta_rel * block * E.  All float32, in
    the reference's order of operations.
    """
    x = kv.to(torch.float32)
    xt = x.transpose(-2, -1)  # pencils over the sequence dim
    if batched:
        amax = torch.amax(torch.abs(xt), dim=tuple(range(1, xt.ndim)))
    else:
        amax = torch.max(torch.abs(xt))
    E = _f32(E_rel, x.device) * torch.clamp_min(amax, 1e-30)
    step = 2.0 * E / _f32(2.0**bits, x.device)
    if batched:
        step = step.reshape((-1,) + (1,) * (xt.ndim - 1))
    q = torch.round(xt / step) * step
    return xt, q - xt, E


def compress_kv_tensor(
    kv: torch.Tensor,  # (b, hkv, S, hd)
    *,
    bits: int = 8,
    E_rel: float = 1e-2,
    Delta_rel: float = 1e-2,
    block: int = 1024,
    max_iters: int = 8,
    engine: Optional[CorrectionEngine] = None,
) -> torch.Tensor:
    """Quantize + FFCz-correct one KV tensor; returns the lossy round trip
    in ``kv``'s dtype.  ``engine`` defaults to :func:`default_engine` of
    ``kv``'s device."""
    xt, err, E = _quantize_pencils(kv, bits, E_rel)
    Delta = _f32(Delta_rel * block, kv.device) * E
    [corrected_err], _stats = (engine or default_engine(kv.device)).correct(
        [err], E, Delta, block=block, max_iters=max_iters
    )
    return (xt + corrected_err).transpose(-2, -1).to(kv.dtype)


def compress_cache(
    cache: dict,
    comp,
    *,
    bits: int = 8,
    block: int = 1024,
    max_iters: int = 8,
    engine: Optional[CorrectionEngine] = None,
) -> dict:
    """Apply KV compression to the ``k``/``v`` leaves of a cache dict.

    Returns a new dict (the input's tensors are not written).  All layers'
    quantization errors are corrected by ONE ``engine.correct`` call with
    per-sub-tensor ``E``/``Delta``; ``engine`` defaults to
    :func:`default_engine` of the cache's device.
    """
    kv_names = [k for k in ("k", "v") if getattr(cache.get(k), "ndim", 0) >= 4]
    if not kv_names:
        return cache
    device = cache[kv_names[0]].device
    engine = engine or default_engine(device)
    delta_scale = _f32(comp.kv_Delta_rel * block, device)

    prepped = []  # (name, n_sub, start in errs)
    errs, Es, Ds = [], [], []
    for name in kv_names:
        leaf = cache[name]
        sub = leaf.reshape((-1,) + tuple(leaf.shape[-4:])) if leaf.ndim > 4 else leaf[None]
        start = len(errs)
        _xt, err, E = _quantize_pencils(sub, bits, comp.kv_E_rel, batched=True)
        errs.extend(err[j] for j in range(err.shape[0]))
        Es.extend(E[j] for j in range(E.shape[0]))
        Ds.extend(delta_scale * E[j] for j in range(E.shape[0]))
        prepped.append((name, sub.shape[0], start))
    del _xt, err

    corrected, _stats = engine.correct(errs, Es, Ds, block=block, max_iters=max_iters)
    del errs

    out = dict(cache)
    for name, n_sub, start in prepped:
        leaf = cache[name]
        sub = leaf.reshape((-1,) + tuple(leaf.shape[-4:])) if leaf.ndim > 4 else leaf[None]
        xt = sub.to(torch.float32).transpose(-2, -1)
        corr = torch.stack([corrected[start + j] for j in range(n_sub)])
        out[name] = (xt + corr).transpose(-2, -1).reshape(leaf.shape).to(leaf.dtype)
    return out
