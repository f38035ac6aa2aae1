"""The dense decoder block (qwen2 / granite / minitron / mistral backbone).

The reference stacks each layer's parameters on a leading axis and
``lax.scan``s the block over them; the port keeps one :class:`DenseBlock`
per layer in an ``nn.ModuleList`` (``models/model.py``).  ``cfg.remat`` is a
training knob and does nothing in this forward-only port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.layers import RMSNorm, SwiGLU, dtype_of


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
