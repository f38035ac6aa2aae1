"""The control: the reference's correction put in the program's engine's
place, its state rounded to bfloat16, the precision below the float32 that
the configurations state.  Passed as the clients' ``engine=``; the
comparison has to refuse what it returns."""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from . import pocs
from .quantize import pencils


@dataclasses.dataclass
class Stats:
    iterations: Any  # (n_tensors,) int32: the most iterations over a tensor's pencils
    converged: Any  # (n_tensors,) bool
    block_iterations: Any  # (pencils,) int32
    block_converged: Any  # (pencils,) bool


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Bfloat16Engine:
    """``correct`` of a list of error tensors with per-tensor bounds, each
    tensor cut into ``block`` pencils, in float32 arithmetic on a bfloat16
    state."""

    def correct(self, tensors: Sequence[torch.Tensor], E, Delta, block: int = 4096, max_iters: int = 50,
                **_unused):
        out, its, convs, block_its, block_convs = [], [], [], [], []
        for t, e, d in zip(tensors, E, Delta):
            p = pencils(t.to(torch.float32).reshape(-1), block)
            rows = p.shape[0]
            eb = torch.as_tensor(e, dtype=torch.float32, device=p.device).reshape(1).expand(rows)
            db = torch.as_tensor(d, dtype=torch.float32, device=p.device).reshape(1).expand(rows)
            c, it, conv = pocs.project(p, eb, db, max_iters, rounding=_bf16)
            out.append(c.reshape(-1)[: t.numel()].reshape(t.shape).to(t.dtype))
            its.append(it.max())
            convs.append(conv.all())
            block_its.append(it)
            block_convs.append(conv)
        return out, Stats(torch.stack(its), torch.stack(convs), torch.cat(block_its), torch.cat(block_convs))
