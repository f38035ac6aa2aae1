"""Common layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, initializers.

The reference's pure functions ``f(params, x)`` become small ``nn.Module``s
whose parameters carry the reference's names (``scale``, ``w_gu``,
``w_down``), so a reference parameter tree maps onto a ``state_dict`` key
for key.  The casts are the reference's: RMSNorm and RoPE compute in float32
and return the input's dtype, the cross-entropy runs in float32.
Initializers draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``(normal(float32) * scale).astype(dtype)``, on the generator's device."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, h, s, d); positions: (b, s) or (s,) integers."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (d/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].to(torch.float32) * freqs  # (b,1,s,d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs


class SwiGLU(nn.Module):
    """Fused gate+up projection ``w_gu (d, 2, f)`` and ``w_down (f, d)``."""

    def __init__(self, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_gu = nn.Parameter(torch.empty((d, 2, f), dtype=dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((f, d), dtype=dtype, device=device))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        d, _, f = self.w_gu.shape
        self.w_gu.copy_(normal(gen, (d, 2, f), 1.0 / math.sqrt(d), self.w_gu.dtype))
        self.w_down.copy_(dense_init(gen, f, d, self.w_down.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self.w_gu, self.w_down, x)


def swiglu(w_gu: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    gu = torch.einsum("...d,dcf->...cf", x, w_gu)
    return (F.silu(gu[..., 0, :]) * gu[..., 1, :]) @ w_down


# ---------------------------------------------------------------------------
# losses


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level CE in float32; logits (..., V), labels (...) integers.

    The gold logit is gathered (the reference selects it with an iota
    comparison so a vocab-sharded tensor is never gathered; on one device
    both pick the same value exactly).
    """
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
