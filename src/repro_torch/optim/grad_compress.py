"""FFCz-compressed gradients.

``compress_gradients`` is the transform the train step applies to the
gradient tree: per-tensor int-quantization to ``bits`` with error bound
E = E_rel * ||g||_inf, followed by FFCz blockwise dual-domain correction so
the *spectrum* of the quantized gradient stays within Delta = Delta_rel *
block * E of each block.  The correction runs through
:meth:`repro_torch.core.engine.CorrectionEngine.correct`, one call per
effective pencil length, as in the reference; this module owns only the
quantizer and the bound derivation.

The quantizer rounds onto a grid of step 2E / 2^bits, so every error is at
most E * 2^-bits and every component of a length-N error spectrum at most
N * E * 2^-bits.  The correction can therefore act only when
``Delta_rel < 2^-bits`` (at the defaults, bits = 8 and Delta_rel = 1e-2, it
never does: ROADMAP.md Queue 3).

``compressed_psum`` is the explicit collective form: every rank of a mesh
axis quantizes its tensor to int32 codes on one shared grid, the *codes* are
all-reduced (an integer sum is exact, so no quantization noise accumulates
across ranks beyond the single quantizer's bound), and every rank gets the
dequantized mean.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.optim.adamw import _f32


def _quantize_dequantize(g: torch.Tensor, bits: int, E_rel: float):
    """Uniform symmetric quantizer with bound E = E_rel * max|g| (per tensor).

    Returns ``(dequantized in g's dtype, float32 codes, step)``, in the
    reference's float32 order of operations (the division is by a tensor,
    so it is IEEE division on the card as well)."""
    g32 = g.to(torch.float32)
    gmax = torch.max(torch.abs(g32))
    E = _f32(E_rel, g.device) * gmax
    # round-to-nearest on a grid of step 2E/2^bits => |dequant - g| <= E*2^-bits;
    # the *bound* guaranteed downstream is E (coarse grid = fewer wire bits)
    step = torch.clamp_min(2.0 * E / _f32(2.0**bits, g.device), 1e-30)
    codes = torch.round(g32 / step)
    return (codes * step).to(g.dtype), codes, step


def compress_gradients(
    grads: Any,
    *,
    bits: int = 8,
    E_rel: float = 1e-2,
    Delta_rel: float = 1e-2,
    block: int = 4096,
    max_iters: int = 8,
    engine: Optional[CorrectionEngine] = None,
) -> Any:
    """Quantize + FFCz-correct every gradient tensor (dual-domain bounded).

    The correction bounds the *error spectrum* of each ``block``-length
    pencil: spatial |err| <= E and |Re/Im FFT(err)| <= Delta, with
    E = E_rel * max|g| and Delta = Delta_rel * block * E.  Tensors of the
    tree are corrected by batched ``engine.correct`` calls, one per distinct
    effective pencil length (a tensor smaller than ``block`` keeps its own
    ``size``-length pencil); tensors of fewer than 2 values pass through.
    ``engine`` defaults to :func:`default_engine` of the gradients' device.
    """
    leaves, treedef = tree.flatten(grads)
    work = []  # (leaf index, err, E, Delta, effective block)
    for i, g in enumerate(leaves):
        if g.numel() < 2:
            continue
        gq, _codes, _step = _quantize_dequantize(g, bits, E_rel)
        err = (gq - g).to(torch.float32)
        gmax = torch.max(torch.abs(g.to(torch.float32)))
        E = _f32(E_rel, g.device) * gmax
        Delta = _f32(Delta_rel * block, g.device) * E
        work.append((i, err, E, Delta, min(block, max(g.numel(), 2))))

    out = list(leaves)
    if work:
        engine = engine or default_engine(work[0][1].device)
    for blk in sorted({w[4] for w in work}):
        group = [w for w in work if w[4] == blk]
        corrected, _stats = engine.correct(
            [w[1] for w in group],
            [w[2] for w in group],
            [w[3] for w in group],
            block=blk,
            max_iters=max_iters,
        )
        for (i, _err, _E, _D, _b), corr in zip(group, corrected):
            g = leaves[i]
            out[i] = (g.to(torch.float32) + corr).to(g.dtype)
    return tree.unflatten(treedef, out)


def compressed_psum(x: torch.Tensor, mesh=None, axis: str = "data", *, bits: int = 8, E_rel: float = 1e-2):
    """Integer-code all-reduce over ``mesh[axis]``: the dequantized mean.

    ``x`` is this rank's tensor (every rank passes one of the same shape).
    The grid's step comes from the largest ``|x|`` over the ranks (an
    all-reduce MAX), ``2 E_rel max|x| / 2^bits``; the int32 codes are summed
    by an all-reduce and the mean dequantized, in the reference's float32
    order of operations.  ``mesh=None`` takes a 1-D mesh over the default
    process group (``ValueError`` when none is initialized).
    """
    from repro_torch.sharding import dist_fft

    group, n_dev, _ = dist_fft.mesh_axis(dist_fft.default_mesh(axis) if mesh is None else mesh, axis)
    v32 = x.to(torch.float32)
    gmax = dist_fft.all_reduce_(torch.max(torch.abs(v32)).reshape(1), group, dist.ReduceOp.MAX)[0]
    step = torch.clamp_min(_f32(2.0 * E_rel, x.device) * gmax / _f32(2.0**bits, x.device), 1e-30)
    codes = torch.round(v32 / step).to(torch.int32)
    total = dist_fft.all_reduce_(codes, group)
    return (total.to(torch.float32) * step / _f32(float(n_dev), x.device)).to(x.dtype)
