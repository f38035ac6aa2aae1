"""GPipe pipeline parallelism over a mesh axis.

The reference (``src/repro/sharding/pipeline.py``) splits a layer stack into
S stages along a mesh axis and streams M microbatches through the classic
GPipe schedule: T = M + S - 1 ticks, bubble fraction (S - 1) / T.  At tick
t, stage ``idx`` (its coordinate on the axis) works on microbatch
m = t - idx when 0 <= m < M; stage 0 reads the microbatch stream, every
other stage what its predecessor sent at the tick before, and the last
stage keeps each finished microbatch.

The port runs the same schedule on each rank of the axis's process group.
The reference's ``ppermute`` ring ``[(i, (i + 1) % S)]`` becomes
point-to-point sends over that group (``dist.batch_isend_irecv``), posted
only where a real microbatch crosses (the ring's wrap-around to stage 0
carries nothing stage 0 reads), inside an autograd ``Function`` whose
backward sends the gradient the other way.  The last stage's outputs reach
every rank by a broadcast, whose backward hands the last stage its own
copy's gradient (the convention of ``tp.reduce_from_model``: a replicated
output's loss, computed alike on every rank, counts once), so
``pipeline_apply`` is differentiable as the reference's is.  A
stage skips ``stage_fn`` on a tick with no real microbatch (the reference
computes on garbage there and drops it): the outputs are the same.  At
S = 1 no send is posted and the broadcast is the identity.

Each tick's exchange takes the previous tick's result on its rank as an
input, so on every rank the exchanges form one chain that ends in the
broadcast: a backward through the outputs runs every rank's exchanges in
reverse tick order, and each send meets its receive.  Every rank of the
axis calls ``pipeline_apply`` and, if any does, a backward through its
result.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from repro_torch import tree
from repro_torch.sharding import dist_fft


def _p2p(sends, recvs, group):
    """Post ``sends`` (``(tensor, group rank)``) and ``recvs`` together, wait."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group) for t, r in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class _Shift(torch.autograd.Function):
    """One tick's exchange on one rank: send ``y`` to stage ``idx + 1`` when
    ``send``, and return what stage ``idx - 1`` sends when ``recv`` (else
    zeros shaped like ``link``, the previous tick's result, which only
    orders the chain).  Backward: the output's gradient goes back to
    ``idx - 1`` and ``y``'s comes from ``idx + 1``."""

    @staticmethod
    def forward(ctx, y, link, group, idx, send, recv):
        ctx.group, ctx.idx, ctx.send, ctx.recv = group, idx, send, recv
        out = torch.empty_like(link) if recv else torch.zeros_like(link)
        _p2p([(y, idx + 1)] if send else [], [(out, idx - 1)] if recv else [], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g_y = torch.empty_like(grad) if ctx.send else None
        _p2p([(grad, ctx.idx - 1)] if ctx.recv else [], [(g_y, ctx.idx + 1)] if ctx.send else [], ctx.group)
        return g_y, torch.zeros_like(grad), None, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``outs`` on every rank of the axis (a broadcast);
    ``link`` ties the rank's exchange chain to the result.  Backward: the
    last stage keeps its own copy's gradient; no rank sums (every rank's
    copy carries the same gradient of the same replicated loss)."""

    @staticmethod
    def forward(ctx, outs, link, shape, dtype, group, idx, n):
        ctx.idx, ctx.n, ctx.link_shape = idx, n, link.shape
        if n == 1:
            return outs.clone()
        buf = outs.contiguous().clone() if idx == n - 1 else torch.empty(shape, dtype=dtype, device=link.device)
        dist.broadcast(buf, src=dist.get_global_rank(group, n - 1), group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        g_outs = grad if ctx.idx == ctx.n - 1 else None
        return g_outs, torch.zeros(ctx.link_shape, dtype=grad.dtype, device=grad.device), None, None, None, None, None


def _stage_params(stage_params, n: int, idx: int):
    """This stage's slice of every leaf: leading axis ``n`` (index ``idx``)
    or 1 (the rank's own stage)."""

    def pick(a):
        if a.shape[0] == n:
            return a[idx]
        if a.shape[0] == 1:
            return a[0]
        raise ValueError(f"a stage_params leaf has leading axis {a.shape[0]}: want {n} (one a stage) or 1 "
                         "(this rank's stage)")

    return tree.map_leaves(pick, stage_params)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor, mesh, axis: str = "pipe"):
    """Run ``y_m = stage_{S-1}(...stage_0(x_m))`` for every microbatch m with
    the GPipe schedule over ``mesh``'s ``axis`` (a ``DeviceMesh`` from
    :func:`repro_torch.launch.mesh.make_mesh`).

    ``stage_fn(params, h)`` maps one microbatch ``h`` (``microbatches[m]``)
    to a tensor of its shape and dtype.  ``stage_params`` is a tree of
    tensors whose leaves carry a leading stage axis of S (this rank takes
    its index) or 1 (the rank's own stage: a model need never be whole on
    every rank).  ``microbatches`` is (M, mb, ...), the same on every rank
    of the axis; so are the returned outputs, on every rank.  As the
    reference's one loss of its global result, the loss is replicated: every
    rank computes it alike on its copy, and a backward through them counts
    it once (the last stage's copy carries the gradient, the others' are
    dropped)."""
    group, n, idx = dist_fft.mesh_axis(mesh, axis)
    params = _stage_params(stage_params, n, idx)
    M = int(microbatches.shape[0])
    mb_shape, dtype = tuple(microbatches.shape[1:]), microbatches.dtype
    if n > 1:
        # every rank of the axis must agree on the stream, and every rank
        # learns of a disagreement (the largest and the smallest shapes, in
        # one reduction); this is also the group's first collective, before
        # any point-to-point op
        seen = torch.tensor([M, *mb_shape], dtype=torch.int64, device=microbatches.device)
        bounds = torch.cat([seen, -seen])
        dist.all_reduce(bounds, op=dist.ReduceOp.MAX, group=group)
        top, bottom = bounds[: seen.numel()], -bounds[seen.numel():]
        if not torch.equal(top, bottom):
            raise ValueError(f"the stages' microbatches differ: shapes from {tuple(bottom.tolist())} to "
                             f"{tuple(top.tolist())}; stage {idx} has {tuple(microbatches.shape)}")
    grad = torch.is_grad_enabled()
    # the chain's first link: a leaf that needs a gradient records every
    # tick's exchange in the graph, on every rank alike
    carry = torch.zeros(mb_shape, dtype=dtype, device=microbatches.device,
                        requires_grad=grad and dtype.is_floating_point)
    outs = [None] * M
    for t in range(M + n - 1):
        m = t - idx
        valid = 0 <= m < M
        if valid:
            y = stage_fn(params, microbatches[m] if idx == 0 else carry)
            if tuple(y.shape) != mb_shape or y.dtype != dtype:
                raise ValueError(f"stage_fn gave {tuple(y.shape)} {y.dtype} for a microbatch of {mb_shape} {dtype}")
            if idx == n - 1:
                outs[m] = y
        send = valid and idx < n - 1
        recv = idx > 0 and 0 <= m + 1 < M
        carry = _Shift.apply(y if send else None, carry, group, idx, send, recv)
    stacked = torch.stack(outs) if idx == n - 1 else None
    return _FromLast.apply(stacked, carry, (M,) + mb_shape, dtype, group, idx, n)


class _Stack(nn.Module):
    def __init__(self, blocks, cfg):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.cfg = cfg

    def forward(self, h):
        for block in self.blocks:
            h = block(h, self.cfg)[0]
        return h


def block_stage(blocks, cfg):
    """``(stage_fn, stage_params)`` of a stage that runs ``blocks`` in order:
    the model's layer modules (``DenseBlock``s: ``block(h, cfg)[0]``), its
    parameters this rank's stage's (a leading axis of 1)."""
    stack = _Stack(blocks, cfg)
    params = {k: v[None] for k, v in stack.state_dict().items()}

    def stage_fn(p, h):
        return functional_call(stack, p, (h,))

    return stage_fn, params


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
