"""The dense decoder block (qwen2 / granite / minitron / mistral backbone).

The reference stacks each layer's parameters on a leading axis and
``lax.scan``s the block over them; the port keeps one :class:`DenseBlock`
per layer in an ``nn.ModuleList`` (``models/model.py``).  ``remat_wrap``
applies ``cfg.remat`` to a block under autograd, with the reference's names:
``"none"`` saves every activation, ``"full"`` recomputes the block in the
backward from its inputs (``nothing_saveable``), ``"dots"`` saves only the
matrix products' outputs and recomputes the rest (``dots_saveable``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.layers import RMSNorm, SwiGLU, dtype_of


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, remat: str) -> Callable:
    """``fn`` checkpointed per ``remat`` while autograd records; as is
    without grad (scoring and serving keep no graph to recompute)."""
    if remat == "none":
        return fn
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
    elif remat == "full":
        context_fn = None
    else:
        raise ValueError(f"unknown remat {remat!r}")

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)

    return wrapped


class DenseBlock(nn.Module):
    """Pre-norm attention + SwiGLU MLP with residuals; parameters in
    ``cfg.dtype`` (the reference's ``dense_block_init``).  As the reference's
    ``dense_block_apply``, ``forward`` takes the config, so one set of
    parameters runs under any ``attention_impl``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.ln_attn = RMSNorm(cfg.d_model, dtype, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                              cfg.qkv_bias, dtype, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.mlp.init_(gen)

    def forward(self, x: torch.Tensor, cfg: ArchConfig, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None, from_zero: bool = False):
        h, new_cache = attention_apply(
            self.attn.params(),
            self.ln_attn(x, cfg.norm_eps),
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            impl=cfg.attention_impl,
            pos_type=cfg.pos_type,
            rope_theta=cfg.rope_theta,
            positions=positions,
            cache=cache,
            causal_scheduling=cfg.causal_scheduling,
            mesh_axes=cfg.mesh_axes if cfg.shard_attn_activations else (),
            from_zero=from_zero,
        )
        x = x + h
        x = x + self.mlp(self.ln_mlp(x, cfg.norm_eps))
        return x, new_cache
