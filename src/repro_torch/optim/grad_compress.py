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

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing, tree
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.optim.adamw import _f32


def _quantize_dequantize(g: torch.Tensor, bits: int, E_rel: float, gmax: Optional[torch.Tensor] = None):
    """Uniform symmetric quantizer with bound E = E_rel * max|g| (per tensor).

    Returns ``(dequantized in g's dtype, float32 codes, step)``, in the
    reference's float32 order of operations (the division is by a tensor,
    so it is IEEE division on the card as well).  ``gmax`` is the tensor's
    max |g| when ``g`` is a slice of it (elementwise, the slice's values are
    the whole tensor's)."""
    g32 = g.to(torch.float32)
    if gmax is None:
        gmax = torch.max(torch.abs(g32))
    E = _f32(E_rel, g.device) * gmax
    # round-to-nearest on a grid of step 2E/2^bits => |dequant - g| <= E*2^-bits;
    # the *bound* guaranteed downstream is E (coarse grid = fewer wire bits)
    step = torch.clamp_min(2.0 * E / _f32(2.0**bits, g.device), 1e-30)
    codes = torch.round(g32 / step)
    return (codes * step).to(g.dtype), codes, step


@tracing.traced("ffcz.grad.compress_gradients")
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


# ---------------------------------------------------------------------------
# over a mesh


def _level(shape, dim: int, n: int):
    """``(run, period)`` of one split: block ``i`` of ``n`` along ``dim``
    holds, of a tensor of ``shape``'s row-major flat index, every ``[o *
    period + i * run, o * period + (i + 1) * run)``."""
    inner = math.prod(shape[dim + 1:])
    return shape[dim] // n * inner, shape[dim] * inner


def _below1(run: int, period: int, i: int, x: int) -> int:
    """How many of block ``i``'s elements lie below flat index ``x``."""
    o, rem = divmod(x, period)
    return o * run + min(max(rem - i * run, 0), run)


def _below(layout, name: str, s: int, x: int) -> int:
    """How many of holder ``s``'s elements of ``name`` lie below flat index
    ``x``: where ``[0, x)`` starts in its local flat block.  A (data, model)
    block is a split of a split: the outer dim's block, then the inner's
    within it (a block's row-major order keeps the whole's order)."""
    shape, at = list(layout.shapes[name]), layout.coords(s)
    for dim, axis, n in layout.splits(name):
        x = _below1(*_level(shape, dim, n), at[axis], x)
        shape[dim] //= n
    return x


def _interleave(pieces, lo: int, hi: int, run: int, period: int):
    """The flat range ``[lo, hi)`` of a tensor split ``n = len(pieces)``
    ways (``(run, period)``) from each block's elements of it, in order."""
    n = len(pieces)
    o_lo, o_hi = lo // period, (hi - 1) // period + 1
    ext = torch.zeros((n, (o_hi - o_lo) * run), dtype=pieces[0].dtype, device=pieces[0].device)
    for i, piece in enumerate(pieces):
        a = _below1(run, period, i, lo) - o_lo * run
        ext[i, a : a + piece.numel()] = piece
    flat = ext.view(n, o_hi - o_lo, run).transpose(0, 1).reshape(-1)
    return flat[lo - o_lo * period : hi - o_lo * period]


def _place(layout, name: str, lo: int, hi: int, part_of):
    """The flat range ``[lo, hi)`` of split ``name`` from each block's
    elements of it (``part_of(coords)``: the block at those coordinates of
    the splitting axes, in flat order), split level by split level."""
    levels = layout.splits(name)

    def rec(k, shape, lo, hi, at):
        if k == len(levels):
            return part_of(at)
        dim, axis, n = levels[k]
        run, period = _level(shape, dim, n)
        inner = list(shape)
        inner[dim] //= n
        pieces = [rec(k + 1, inner, _below1(run, period, i, lo), _below1(run, period, i, hi), {**at, axis: i})
                  for i in range(n)]
        return _interleave(pieces, lo, hi, run, period)

    return rec(0, list(layout.shapes[name]), lo, hi, {})


def _pick(layout, name: str, lo: int, hi: int, values: torch.Tensor, s: int) -> torch.Tensor:
    """Of the flat range ``[lo, hi)`` of ``name`` (``values``), the elements
    holder ``s`` holds, in its flat order (the inverse of :func:`_place`)."""
    shape, at = list(layout.shapes[name]), layout.coords(s)
    for dim, axis, n in layout.splits(name):
        run, period = _level(shape, dim, n)
        i = at[axis]
        o_lo, o_hi = lo // period, (hi - 1) // period + 1
        flat = values.new_zeros((o_hi - o_lo) * period)
        flat[lo - o_lo * period : hi - o_lo * period] = values
        mine = flat.view(o_hi - o_lo, n, run)[:, i].reshape(-1)
        a = _below1(run, period, i, lo) - o_lo * run
        lo, hi = _below1(run, period, i, lo), _below1(run, period, i, hi)
        values = mine[a : a + hi - lo]
        shape[dim] //= n
    return values


def _sends(layout, name: str, s: int, d: int) -> bool:
    """Whether holder ``s`` sends its values of ``name`` to holder ``d``:
    along every axis that does not split it, the one with ``d``'s
    coordinate does (so a block held by several ranks is sent once, and a
    whole tensor is never sent)."""
    split = {axis for _dim, axis, _n in layout.splits(name)}
    a, b = layout.coords(s), layout.coords(d)
    return all(a[x] == b[x] for x in ("data", "model") if x not in split)


#: float32 bytes of pencils a rank corrects in one ``engine.correct`` call:
#: the batched loop's state is a few times its input, so a rank's share of a
#: large model's pencils is corrected in calls of at most this much (32768
#: pencils at block 4096).  The rows are independent, so the cut changes no
#: value.
_CALL_BYTES = 512 << 20


def _exchange(send_parts, recv_sizes, layout):
    """One all-to-all over the (data, model) ranks: ``send_parts[d]`` (a list of
    float32 tensors) to rank ``d``; returns what each rank sent here, split
    by source."""
    send = torch.cat([t for parts in send_parts for t in parts]) if any(send_parts) else None
    in_sizes = [sum(t.numel() for t in parts) for parts in send_parts]
    if layout.n == 1:
        recv = send if send is not None else torch.zeros(0)
    else:
        dev = layout.device
        send = send if send is not None else torch.zeros(0, device=dev)
        recv = torch.empty(sum(recv_sizes), dtype=torch.float32, device=dev)
        dist.all_to_all_single(recv, send, recv_sizes, in_sizes, group=layout.group)
    return list(torch.split(recv, list(recv_sizes)))


@tracing.traced("ffcz.grad.compress_sharded_gradients")
def compress_sharded_gradients(
    grads: Dict[str, torch.Tensor],
    layout,
    leaves: Sequence[Sequence[str]],
    *,
    bits: int = 8,
    E_rel: float = 1e-2,
    Delta_rel: float = 1e-2,
    block: int = 4096,
    max_iters: int = 8,
    engine: Optional[CorrectionEngine] = None,
) -> Dict[str, torch.Tensor]:
    """:func:`compress_gradients` of the gathered, reduced gradient, over a
    mesh, without gathering a leaf.

    ``grads``: this rank's gradient blocks by state dict name, lying as
    ``layout`` (a :class:`repro_torch.sharding.fsdp.MeshLayout`) says
    (split over "data", "model" or both);
    ``leaves``: the reference tree's leaves in its leaf order, each the
    port names stacked into it, in stack order (``MeshTrainStep.
    reference_leaves``).  The result is what the one-device call gives on
    the reference-layout tree, cut to this rank's blocks:

    - each leaf's ``E = E_rel * max|g|`` over the whole leaf (an all-reduce
      of the max), ``Delta = Delta_rel * block * E``;
    - the reference's pencils: the leaf flattened (its stack axes leading)
      and cut every ``min(block, max(size, 2))`` values, the last zero
      padded; leaves of fewer than 2 values pass through;
    - per effective block, the pencils of every leaf in leaf order are cut
      into contiguous ranges, one a (data, model) rank of the pod, and each
      rank corrects its
      range through ``engine.correct`` (the batched loop; kernels 3p/4p
      with a ``pallas`` engine), at most :data:`_CALL_BYTES` of pencils a
      call (at a small model's size one call: the one-device call).
      A rank's values reach it by one all-to-all a call (each value from
      one of the ranks that hold it), and the corrections go back by
      another (to every rank that holds it); a rank left with one pencil of a
      larger batch corrects it beside a zero line (the CPU's FFTs are
      batch-invariant only for two lines or more).

    The pencils' rows are independent, so the result is bitwise the same
    at every mesh shape and equal to the one-device call's.
    """
    n, rank = layout.n, layout.rank
    work = []  # (names, numel of one, total, block, E, Delta)
    maxima = []
    for names in leaves:
        size = math.prod(layout.shapes[names[0]])
        if size * len(names) < 2:
            continue
        local = torch.stack([torch.max(torch.abs(grads[k].to(torch.float32))) for k in names])
        maxima.append(torch.max(local))
        work.append([list(names), size, size * len(names), min(block, max(size * len(names), 2))])
    out = dict(grads)
    if not work:
        return out
    gmax = torch.stack(maxima)
    if n > 1:
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=layout.group)
    dev = gmax.device
    for w, m in zip(work, gmax.unbind()):
        E = _f32(E_rel, dev) * m
        w += [m, E, _f32(Delta_rel * block, dev) * E]
    engine = engine or default_engine(dev)
    for names, *_ in work:
        for k in names:
            out[k] = torch.empty_like(grads[k])

    def err_of(name, a, b, m):
        g = grads[name].reshape(-1)[a:b]
        return (_quantize_dequantize(g, bits, E_rel, gmax=m)[0] - g).to(torch.float32)

    for blk in sorted({w[3] for w in work}):
        group = [w for w in work if w[3] == blk]
        rows = [-(-w[2] // blk) for w in group]
        starts = np.cumsum([0] + rows)
        total_rows = int(starts[-1])
        base, extra = divmod(total_rows, n)
        first = [d * base + min(d, extra) for d in range(n)]
        count = [base + (d < extra) for d in range(n)]
        per_call = max(_CALL_BYTES // (4 * blk), 2)
        n_calls = -(-max(count) // per_call)

        def plan(d, c):
            """Rank ``d``'s pieces in call ``c``: ``(leaf, layer, lo, hi)``."""
            lo_row = first[d] + c * per_call
            hi_row = first[d] + min(count[d], (c + 1) * per_call)
            pieces = []
            for f, w in enumerate(group):
                a, b = max(lo_row, starts[f]), min(hi_row, starts[f + 1])
                if a >= b:
                    continue
                flo, fhi = (a - starts[f]) * blk, min((b - starts[f]) * blk, w[2])
                for j in range(flo // w[1], (fhi - 1) // w[1] + 1):
                    pieces.append((f, j, max(flo, j * w[1]) - j * w[1], min(fhi, (j + 1) * w[1]) - j * w[1]))
            return pieces

        for c in range(n_calls):
            plans = [plan(d, c) for d in range(n)]

            def held(s, name, lo, hi, d):
                """How many values of piece (name, lo, hi) rank s sends rank d."""
                return _below(layout, name, s, hi) - _below(layout, name, s, lo) if _sends(layout, name, s, d) else 0

            # forward: each rank's values of every rank's pieces
            send = []
            for d in range(n):
                parts = []
                for f, j, lo, hi in plans[d]:
                    name, m = group[f][0][j], group[f][4]
                    if _sends(layout, name, rank, d):
                        parts.append(err_of(name, _below(layout, name, rank, lo), _below(layout, name, rank, hi), m))
                send.append(parts)
            mine = plans[rank]
            recv = _exchange(send, [sum(held(s, group[f][0][j], lo, hi, rank) for f, j, lo, hi in mine)
                                    for s in range(n)], layout)
            del send
            at = [0] * n
            tensors, leaf_of = [], []
            for f, j, lo, hi in mine:
                name = group[f][0][j]
                parts = []
                for s in range(n):
                    k = held(s, name, lo, hi, rank)
                    parts.append(recv[s][at[s] : at[s] + k])
                    at[s] += k
                here = layout.coords(rank)
                piece = _place(layout, name, lo, hi,
                               lambda pos, parts=parts: parts[layout.holder({**here, **pos})])
                if leaf_of and leaf_of[-1] == f:
                    tensors[-1].append(piece)
                else:
                    tensors.append([piece])
                    leaf_of.append(f)
            del recv
            if tensors:
                batch = [torch.cat(t) for t in tensors]
                Es = [group[f][5] for f in leaf_of]
                Ds = [group[f][6] for f in leaf_of]
                if sum(-(-t.numel() // blk) for t in batch) == 1 and total_rows > 1:
                    one = torch.ones((), dtype=torch.float32, device=dev)
                    batch, Es, Ds = batch + [batch[0].new_zeros(blk)], Es + [one], Ds + [one]
                corrected, _stats = engine.correct(batch, Es, Ds, block=blk, max_iters=max_iters)
                corrected = corrected[: len(tensors)]
                del batch
            # back: each rank's corrections of what it holds
            back = [[] for _ in range(n)]
            pos = {}
            for (f, j, lo, hi) in mine:
                k = leaf_of.index(f)
                start = pos.get(f, 0)
                values = corrected[k][start : start + hi - lo]
                pos[f] = start + hi - lo
                name = group[f][0][j]
                for s in range(n):
                    back[s].append(_pick(layout, name, lo, hi, values, s))
            recv = _exchange(back, [sum(_below(layout, group[f][0][j], rank, hi) - _below(layout, group[f][0][j], rank, lo)
                                        for f, j, lo, hi in plans[d]) for d in range(n)], layout)
            del back
            for d in range(n):
                at = 0
                for f, j, lo, hi in plans[d]:
                    name = group[f][0][j]
                    a, b = _below(layout, name, rank, lo), _below(layout, name, rank, hi)
                    corr = recv[d][at : at + b - a]
                    at += b - a
                    g = grads[name].reshape(-1)[a:b]
                    out[name].view(-1)[a:b] = (g.to(torch.float32) + corr).to(g.dtype)
            del recv
    return out

