"""Plain PyTorch oracle for causal GQA attention (materialised scores).

The twin of the CUDA kernel in ``csrc/flash_attention.cu``: the kernel's
wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the kernel
against it on the card.  A copy of ``repro/kernels/flash_attention/ref.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (b, hq, sq, d)
    k: torch.Tensor,  # (b, hkv, sk, d)
    v: torch.Tensor,  # (b, hkv, sk, d)
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention in float32, output in q's dtype.

    Query head h reads kv head h // (hq // hkv).  Causality follows the
    suffix convention: the queries are the last sq of the sk kv positions
    (offset sk - sq), which serves both prefill (sq == sk) and decode.
    """
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(group, dim=1).to(torch.float32)
    vq = v.repeat_interleave(group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kq) * scale
    if causal:
        row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        col = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(col > row, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
