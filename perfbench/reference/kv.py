"""The KV client's contract (``compress_cache``), judged.

Every leaf named ``k`` or ``v`` with four dimensions or more, found in
sorted key order depth first, is cut into ``(b, hkv, S, hd)`` sub-tensors;
each is quantized against its own absolute maximum over pencils along the
sequence axis, ``(b, hkv, hd, S)`` flattened and cut every ``block`` values;
its corrected error comes back in the same order, and the new leaf is the
float32 value plus that error, in the leaf's layout and dtype.  Every
other leaf passes through untouched.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import judge, quantize


def kv_leaves(cache: dict, path=()):
    """``(path, leaf)`` of each ``k``/``v`` leaf of four dimensions or more."""
    for name in sorted(cache):
        v = cache[name]
        if isinstance(v, dict):
            yield from kv_leaves(v, path + (name,))
        elif name in ("k", "v") and getattr(v, "ndim", 0) >= 4:
            yield path + (name,), v


def _at(tree: dict, path):
    for p in path:
        tree = tree[p]
    return tree


def _other_leaves(cache: dict, path=()):
    for name in sorted(cache):
        v = cache[name]
        if isinstance(v, dict):
            yield from _other_leaves(v, path + (name,))
        elif not (name in ("k", "v") and getattr(v, "ndim", 0) >= 4):
            yield path + (name,), v


def judge_cache(tally: judge.Tally, cache: dict, out: dict, corrected: Sequence[torch.Tensor], *, bits: int,
                E_rel: float, Delta_rel: float, block: int, max_iters: int) -> None:
    """Judge one ``compress_cache`` call: ``cache`` its input, ``out`` its
    result, ``corrected`` the corrected errors its correction returned, one a
    sub-tensor in the contract's order.  Misplaced values (a leaf not equal,
    bit for bit, to its value plus its corrected error) are counted."""
    j = 0
    for path, leaf in kv_leaves(cache):
        sub = leaf.reshape((-1,) + tuple(leaf.shape[-4:])) if leaf.ndim > 4 else leaf[None]
        xt, err, E, Delta = quantize.kv_errors(sub, bits, E_rel, Delta_rel, block)
        n = sub.shape[0]
        got = list(corrected[j : j + n])
        j += n
        if len(got) != n or any(tuple(c.shape) != tuple(err.shape[1:]) for c in got):
            tally.misplaced += leaf.numel()
            continue
        for k in range(n):
            p_err = quantize.pencils(err[k].reshape(-1), block)
            p_c = quantize.pencils(got[k].reshape(-1).to(torch.float32), block)
            rows = p_err.shape[0]
            judge.judge(tally, p_err, p_c, E[k].expand(rows), Delta[k].expand(rows), max_iters, err[k].numel())
        want = (xt + torch.stack([c.to(torch.float32) for c in got])).transpose(-2, -1)
        want = want.reshape(leaf.shape).to(leaf.dtype)
        have = _at(out, path)
        if have.shape != want.shape or have.dtype != want.dtype:
            tally.misplaced += leaf.numel()
            continue
        bits_of = {2: torch.int16, 4: torch.int32}[want.element_size()]
        tally.misplaced += int((have.view(bits_of) != want.view(bits_of)).sum())
    if j != len(corrected):
        tally.misplaced += 1
    for path, v in _other_leaves(cache):
        w = _at(out, path)
        same = (torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w)
        tally.misplaced += 0 if same else 1
