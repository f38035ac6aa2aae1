"""Block compositions: the dense decoder block (qwen2 / granite / minitron /
mistral backbone), the MoE layer group, the Zamba2 hybrid group, and
Whisper's encoder block and cross-attending decoder block.

The reference stacks each layer's (or layer group's) parameters on a
leading axis and ``lax.scan``s the block over them; the port keeps one
module per layer or group in an ``nn.ModuleList`` (``models/model.py``),
and a group's inner stack (the MoE group's dense blocks, the hybrid group's
mamba blocks) is a ``ModuleList`` too.  The reference's ``*_init``/``*_apply``
pairs are modules here (``init_`` draws from a generator, ``forward`` is
``apply``): ``moe_group_*`` is :class:`MoEGroup`, ``zamba_shared_init``
:class:`ZambaShared`, ``zamba_group_*`` :class:`ZambaGroup`,
``encoder_block_*`` :class:`EncoderBlock`, ``decoder_xblock_*``
:class:`DecoderXBlock`.  Caches are the
model's, sliced per layer by the caller (``models/model.py`` documents the
layouts).  ``remat_wrap`` applies ``cfg.remat`` to a block under autograd,
with the reference's names:
``"none"`` saves every activation, ``"full"`` recomputes the block in the
backward from its inputs (``nothing_saveable``), ``"dots"`` saves only the
matrix products' outputs and recomputes the rest (``dots_saveable``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import Attention, attention_apply, qkv_slices
from repro_torch.models.layers import GeluMLP, RMSNorm, SwiGLU, dtype_of, normal, rmsnorm
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.ssm import Mamba2
from repro_torch.sharding import tp


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
        h, new_cache = self_attention(self.attn, self.ln_attn(x, cfg.norm_eps), cfg, cache, positions, from_zero)
        x = x + h
        x = x + self.mlp(self.ln_mlp(x, cfg.norm_eps))
        return x, new_cache


def self_attention(attn: Attention, x: torch.Tensor, cfg: ArchConfig, cache: Optional[dict],
                   positions: Optional[torch.Tensor], from_zero: bool):
    """``attention_apply`` with the config's heads, impl and positions."""
    return attention_apply(
        attn.params(),
        x,
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


def _attention_module(cfg: ArchConfig, device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.qkv_bias,
                     dtype_of(cfg.dtype), device)


def _layer_cache(cache: Optional[dict], i: int) -> Optional[dict]:
    """Layer ``i``'s K/V cache from one stacked on a leading layer axis."""
    if cache is None:
        return None
    return {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}


# ---------------------------------------------------------------------------
# MoE layer group (moe_every layers: moe_every - 1 dense blocks, then one MoE block)


class MoEBlock(nn.Module):
    """Pre-norm attention + MoE FFN with residuals (the group's last layer)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.ln_attn = RMSNorm(cfg.d_model, dtype, device)
        self.attn = _attention_module(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype, device)
        self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.shared_expert, dtype,
                       cfg.n_experts_padded, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.moe.init_(gen)

    def forward(self, x: torch.Tensor, cfg: ArchConfig, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None, from_zero: bool = False):
        h, new_cache = self_attention(self.attn, self.ln_attn(x, cfg.norm_eps), cfg, cache, positions, from_zero)
        x = x + h
        x = x + moe_apply(self.moe.params(), self.ln_mlp(x, cfg.norm_eps), top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor,
                          mesh_axes=cfg.mesh_axes if cfg.shard_attn_activations else ())
        return x, new_cache


class MoEGroup(nn.Module):
    """``dense_blocks`` (``moe_every - 1`` :class:`DenseBlock`, absent when
    ``moe_every == 1``) then ``moe_block`` (:class:`MoEBlock`)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.moe_every > 1:
            self.dense_blocks = nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.moe_every - 1))
        self.moe_block = MoEBlock(cfg, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "MoEGroup":
        for block in getattr(self, "dense_blocks", ()):
            block.init_(gen)
        self.moe_block.init_(gen)
        return self

    def forward(self, x: torch.Tensor, cfg: ArchConfig, caches: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None, from_zero: bool = False):
        """``caches``: ``{"moe": kv, "dense": kv stacked on a leading
        (moe_every - 1) axis}`` (``"dense"`` only when the group has dense
        blocks), each kv ``{"k", "v", "pos"}``; written in place."""
        for i, block in enumerate(getattr(self, "dense_blocks", ())):
            c = _layer_cache(caches["dense"], i) if caches is not None else None
            x, _ = block(x, cfg, cache=c, positions=positions, from_zero=from_zero)
        c = caches["moe"] if caches is not None else None
        x, _ = self.moe_block(x, cfg, cache=c, positions=positions, from_zero=from_zero)
        return x, caches


# ---------------------------------------------------------------------------
# Zamba2-style hybrid group: the weight-shared attention block, then
# attn_every mamba blocks


class ZambaShared(nn.Module):
    """The one attention block every group reuses, fed ``concat(x, embed0)``
    through ``ln_in`` and ``in_proj (2 d, d)``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.ln_in = RMSNorm(2 * cfg.d_model, dtype, device)
        self.in_proj = nn.Parameter(torch.empty((2 * cfg.d_model, cfg.d_model), dtype=dtype, device=device))
        self.attn = _attention_module(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "ZambaShared":
        d2 = self.in_proj.shape[0]
        self.in_proj.copy_(normal(gen, self.in_proj.shape, 1.0 / math.sqrt(d2), self.in_proj.dtype))
        self.attn.init_(gen)
        self.mlp.init_(gen)
        return self


class ZambaGroup(nn.Module):
    """``mamba``: ``attn_every`` :class:`Mamba2` blocks, run after the shared block."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.mamba = nn.ModuleList(Mamba2(cfg, device) for _ in range(cfg.attn_every))

    @torch.no_grad()
    def init_(self, gen: torch.Generator, cfg: ArchConfig) -> "ZambaGroup":
        for block in self.mamba:
            block.init_(gen, cfg)
        return self

    def forward(self, x: torch.Tensor, shared: ZambaShared, embed0: torch.Tensor, cfg: ArchConfig,
                caches: Optional[dict] = None, positions: Optional[torch.Tensor] = None,
                from_zero: bool = False):
        """``caches``: ``{"attn": kv {"k", "v", "pos"}, "mamba": {"conv",
        "state"} stacked on a leading attn_every axis}``; written in place."""
        concat = torch.cat([x, embed0], dim=-1)
        h = rmsnorm(shared.ln_in.scale, concat, cfg.norm_eps) @ shared.in_proj
        c_attn = caches["attn"] if caches is not None else None
        a, _ = self_attention(shared.attn, h, cfg, c_attn, positions, from_zero)
        x = x + a
        x = x + shared.mlp(shared.ln_mlp(x, cfg.norm_eps))
        for i, block in enumerate(self.mamba):
            c = None if caches is None else {k: t[i] for k, t in caches["mamba"].items()}
            out, nc = block(x, cfg, cache=c)
            x = x + out
            if c is not None:
                for k, t in nc.items():
                    caches["mamba"][k][i].copy_(t)
        return x, caches


# ---------------------------------------------------------------------------
# Whisper blocks: parameters in cfg.dtype, attention without QKV bias


def _whisper_attention(cfg: ArchConfig, device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, False,
                     dtype_of(cfg.dtype), device)


class EncoderBlock(nn.Module):
    """Pre-norm bidirectional self-attention + GELU MLP with residuals.  Its
    attention is always ``naive`` (the reference's encoder never runs the
    flash kernel, which is causal only) and takes no positions (the
    encoder's sinusoidal positions are added to its input)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.ln_attn = RMSNorm(cfg.d_model, dtype, device)
        self.attn = _whisper_attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.mlp.init_(gen)

    def forward(self, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        h, _ = attention_apply(
            self.attn.params(),
            self.ln_attn(x, cfg.norm_eps),
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            impl="naive",
            causal=False,
            pos_type="none",
        )
        x = x + h
        return x + self.mlp(self.ln_mlp(x, cfg.norm_eps))


class DecoderXBlock(nn.Module):
    """Pre-norm causal self-attention (``cfg.attention_impl``, with a cache
    when serving), cross-attention over the encoder's precomputed K/V
    (``naive``), then a GELU MLP, each with a residual."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.ln_self = RMSNorm(cfg.d_model, dtype, device)
        self.self_attn = _whisper_attention(cfg, device)
        self.ln_cross = RMSNorm(cfg.d_model, dtype, device)
        self.cross_attn = _whisper_attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.self_attn.init_(gen)
        self.cross_attn.init_(gen)
        self.mlp.init_(gen)

    def forward(self, x: torch.Tensor, enc_kv, cfg: ArchConfig, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None, from_zero: bool = False):
        """``enc_kv``: this layer's (k, v) from :func:`cross_kv_from_encoder`."""
        h, new_cache = attention_apply(
            self.self_attn.params(),
            self.ln_self(x, cfg.norm_eps),
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            impl=cfg.attention_impl,
            pos_type="none",  # whisper's positions are sinusoidal, added to the embeddings
            positions=positions,
            cache=cache,
            causal_scheduling=cfg.causal_scheduling,
            mesh_axes=cfg.mesh_axes if cfg.shard_attn_activations else (),
            from_zero=from_zero,
        )
        x = x + h
        c, _ = attention_apply(
            self.cross_attn.params(),
            self.ln_cross(x, cfg.norm_eps),
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            impl="naive",
            cross_kv=enc_kv,
            pos_type="none",
        )
        x = x + c
        x = x + self.mlp(self.ln_mlp(x, cfg.norm_eps))
        return x, new_cache


def cross_kv_from_encoder(block: DecoderXBlock, enc_out: torch.Tensor, cfg: ArchConfig):
    """One decoder layer's cross-attention (k, v), each (b, hkv, s_enc, hd),
    from the encoder's output (computed once, at prefill); under a
    head-split TP context this rank's kv heads, the encoder output entering
    through ``copy_to_model``."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    ctx = tp.active()
    if ctx is not None and ctx.heads:
        hq, hkv = hq // ctx.size, hkv // ctx.size
        enc_out = tp.copy_to_model(enc_out)
    _, wk, wv = qkv_slices(block.cross_attn.params(), hq, hkv, hd)
    k = (enc_out @ wk).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (enc_out @ wv).reshape(b, s, hkv, hd).transpose(1, 2)
    return k, v
