"""The gradient client's contract (``compress_gradients``), judged.

Every leaf of the tree (dicts in sorted key order, depth first) of two
values or more is quantized against its own absolute maximum and cut into
pencils of ``min(block, max(size, 2))`` values, the last zero padded; the
new leaf is the leaf plus its corrected error, in the leaf's dtype.  The
program's corrected error is read back from that float32 output, so each
value's rounding there is the judge's ``slack``.  A leaf of fewer than two
values passes through.
"""

from __future__ import annotations

import torch

from . import judge, quantize


def leaves(tree: dict, path=()):
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, dict):
            yield from leaves(v, path + (name,))
        else:
            yield path + (name,), v


def _at(tree: dict, path):
    for p in path:
        tree = tree[p]
    return tree


def judge_tree(tally: judge.Tally, grads: dict, out: dict, *, bits: int, E_rel: float, Delta_rel: float,
               block: int, max_iters: int) -> None:
    """Judge one ``compress_gradients`` call: ``grads`` its input, ``out``
    its result.  Pencils are judged in blocks of rows, so a leaf of a
    billion values fits beside the program's buffers."""
    for path, g in leaves(grads):
        o = _at(out, path)
        if o.shape != g.shape or o.dtype != g.dtype:
            tally.misplaced += g.numel()
            continue
        if g.numel() < 2:
            tally.misplaced += 0 if torch.equal(o, g) else 1
            continue
        E, Delta = quantize.grad_bounds(g, E_rel, Delta_rel, block)
        blk = min(block, max(g.numel(), 2))
        flat_g, flat_o = g.reshape(-1), o.reshape(-1)
        rows = -(-g.numel() // blk)
        step = max(1, judge._BLOCK_VALUES // blk)
        for a in range(0, rows, step):
            lo, hi = a * blk, min(g.numel(), (a + step) * blk)
            gs, os_ = flat_g[lo:hi], flat_o[lo:hi]
            err = quantize.pencils(quantize.grad_error(gs, E, bits), blk)
            c = quantize.pencils(os_.to(torch.float64) - gs.to(torch.float64), blk)
            slack = quantize.pencils(judge.half_ulp(os_), blk)
            r = err.shape[0]
            judge.judge(tally, err, c, E.expand(r), Delta.expand(r), max_iters, hi - lo, slack=slack)
