"""Common layers: RMSNorm, RoPE, sinusoidal positions, SwiGLU and GELU
MLPs, embeddings, initializers.

The reference's pure functions ``f(params, x)`` become small ``nn.Module``s
whose parameters carry the reference's names (``scale``, ``w_gu``,
``w_up``, ``w_down``), so a reference parameter tree maps onto a
``state_dict`` key for key.  The casts are the reference's: RMSNorm and
RoPE compute in float32 and return the input's dtype, sinusoidal
embeddings are float32, the cross-entropy runs in float32.  The GELU is
``jax.nn.gelu``'s default, the tanh approximation.  Initializers draw from
an explicit ``torch.Generator``.

Under tensor parallelism (:mod:`repro_torch.sharding.tp`, a context the
mesh layer sets) the MLP modules are Megatron's pair: their parameters are
the rank's f columns of the up projection and f rows of the down
projection, the input enters through ``copy_to_model`` and the partial
product is summed by ``reduce_from_model``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import tp


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


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings of integer ``positions`` (s,) -> (s, d) float32,
    sin and cos interleaved, computed at run time (decode positions move)."""
    pos = positions.to(torch.float32)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)[None, :]
    # the float32 power rounded from float64: XLA's is correctly rounded
    # where torch's float32 pow is one ulp off at some exponents
    angle = pos / torch.pow(10000.0, (2.0 * i / d).to(torch.float64)).to(torch.float32)
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(positions.shape[0], d)


def sinusoidal_positions(seq: int, d: int) -> torch.Tensor:
    """The table of :func:`sinusoidal_embed` for positions 0..seq-1, made on
    the host in numpy (float64 angles, float32 out), as the reference's."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((seq, d), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out)


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
        return parallel_mlp(swiglu, self.w_gu, self.w_down, x)


def parallel_mlp(fn, w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``fn(w_up, w_down, x)``; column- then row-parallel when the TP
    context splits the MLP hidden dim (the weights are then the rank's)."""
    ctx = tp.active()
    if ctx is None or not ctx.mlp:
        return fn(w_up, w_down, x)
    return tp.reduce_from_model(fn(w_up, w_down, tp.copy_to_model(x)))


def swiglu(w_gu: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    gu = torch.einsum("...d,dcf->...cf", x, w_gu)
    return (F.silu(gu[..., 0, :]) * gu[..., 1, :]) @ w_down


class GeluMLP(nn.Module):
    """``w_up (d, f)`` and ``w_down (f, d)`` around a tanh-approximated GELU
    (the reference's ``gelu_mlp_init`` / ``gelu_mlp``)."""

    def __init__(self, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_up = nn.Parameter(torch.empty((d, f), dtype=dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((f, d), dtype=dtype, device=device))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        p = gelu_mlp_init(gen, *self.w_up.shape, self.w_up.dtype)
        self.w_up.copy_(p["w_up"])
        self.w_down.copy_(p["w_down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return parallel_mlp(gelu_mlp, self.w_up, self.w_down, x)


def gelu_mlp_init(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {"w_up": dense_init(gen, d, f, dtype), "w_down": dense_init(gen, f, d, dtype)}


def gelu_mlp(w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to approximate=True; torch's default is the exact erf
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


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
