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
cache is a nested dict (``models/model.py`` gives each family's layout);
every leaf named ``k`` or ``v`` with at least 4 dimensions is compressed,
wherever it sits, as the reference's walk of the cache pytree finds them.
A leaf ``(..., b, hkv, S, hd)`` with leading layer or group axes splits into
one sub-tensor per ``(b, hkv, S, hd)`` (the reference's ``ndim > 4``
branch); leaves are taken in the reference's order (sorted keys, depth
first).  Every other leaf (``pos``, the mamba ``conv`` and ``state``) is
passed through untouched.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
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


def _kv_leaves(cache: dict, path=()):
    """(path, leaf) of each ``k``/``v`` leaf with ndim >= 4, in the
    order ``jax.tree_util`` flattens a dict (sorted keys, depth first)."""
    for name in sorted(cache):
        v = cache[name]
        if isinstance(v, dict):
            yield from _kv_leaves(v, path + (name,))
        elif name in ("k", "v") and getattr(v, "ndim", 0) >= 4:
            yield path + (name,), v


def _replaced(tree: dict, path, value) -> dict:
    """A copy of ``tree`` (the dicts along ``path`` copied) with ``value`` at ``path``."""
    out = dict(tree)
    out[path[0]] = value if len(path) == 1 else _replaced(tree[path[0]], path[1:], value)
    return out


@tracing.traced("ffcz.kv.compress_cache")
def compress_cache(
    cache: dict,
    comp,
    *,
    bits: int = 8,
    block: int = 1024,
    max_iters: int = 8,
    engine: Optional[CorrectionEngine] = None,
) -> dict:
    """Apply KV compression to every ``k``/``v`` leaf of a (nested) cache dict.

    Returns a new dict (the input's tensors are not written; leaves that
    are not compressed are the input's).  All leaves' and layers'
    quantization errors are corrected by ONE ``engine.correct`` call with
    per-sub-tensor ``E``/``Delta``; ``engine`` defaults to
    :func:`default_engine` of the cache's device.
    """
    kv = list(_kv_leaves(cache))
    if not kv:
        return cache
    device = kv[0][1].device
    engine = engine or default_engine(device)
    delta_scale = _f32(comp.kv_Delta_rel * block, device)

    def subs(leaf):
        return leaf.reshape((-1,) + tuple(leaf.shape[-4:])) if leaf.ndim > 4 else leaf[None]

    starts = []  # each leaf's first index in errs
    errs, Es, Ds = [], [], []
    for _path, leaf in kv:
        starts.append(len(errs))
        _xt, err, E = _quantize_pencils(subs(leaf), bits, comp.kv_E_rel, batched=True)
        errs.extend(err[j] for j in range(err.shape[0]))
        Es.extend(E[j] for j in range(E.shape[0]))
        Ds.extend(delta_scale * E[j] for j in range(E.shape[0]))
        del _xt, err

    corrected, _stats = engine.correct(errs, Es, Ds, block=block, max_iters=max_iters)
    del errs

    out = cache
    for (path, leaf), start in zip(kv, starts):
        sub = subs(leaf)
        xt = sub.to(torch.float32).transpose(-2, -1)
        corr = torch.stack([corrected[start + j] for j in range(sub.shape[0])])
        out = _replaced(out, path, (xt + corr).transpose(-2, -1).reshape(leaf.shape).to(leaf.dtype))
    return out
