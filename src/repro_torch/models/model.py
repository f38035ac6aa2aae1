"""Top-level model builder: one bundle of functions per architecture family.

``build_model(cfg, device=None)`` returns a :class:`ModelBundle`:

  init(generator)                    -> params (an :class:`LM`)
  load(state_dict)                   -> params from a state dict (port only;
                                        see ``convert.lm_params_from_reference``)
  loss(params, batch)                -> scalar CE loss (teacher-forced scoring)
  prefill(params, batch, cache)      -> (last logits, cache)
  decode(params, tokens, cache)      -> (logits, cache)
  init_cache(batch_size, max_len)    -> cache

A batch is a dict: ``tokens`` (b, s) integers, and for the vlm family
``patches`` (b, vision_tokens, vision_dim), for audio ``frames`` (b,
encoder_seq, d_model), both float32 (the stub frontends' outputs).

The reference ``lax.scan``s one block over parameters stacked on a layer
(or layer-group) axis; here the layers and groups are ``nn.ModuleList``s
run by a Python loop.  Families: ``dense`` (:class:`DenseLM`), ``moe``
(:class:`MoELM`, groups of ``moe_every`` layers), ``ssm`` (:class:`SSMLM`,
mamba2), ``hybrid`` (:class:`ZambaLM`, zamba2), ``vlm`` (:class:`VLMLM`:
the dense backbone behind a patch projector, llava) and ``audio``
(:class:`WhisperLM`: an encoder and a cross-attending decoder, whisper).

Caches keep the reference's leaves, each stacked on its leading layer (and
group) axes as the reference's scan stacks them, with one Python-int
``pos`` for the whole model instead of a per-layer array:

  dense   {"k", "v": (n_layers, b, hkv, S, hd), "pos"}
  moe     {"moe": {"k", "v": (n_groups, b, hkv, S, hd)},
           "dense": {"k", "v": (n_groups, moe_every - 1, b, hkv, S, hd)}
                    (only when moe_every > 1), "pos"}
  ssm     {"conv": (n_layers, b, k - 1, conv_dim), "state": (n_layers, b, h, p, n)}
          (O(1) in max_len; no pos: the blocks are attention-free)
  hybrid  {"groups": {"attn": {"k", "v": (n_groups, b, hkv, S, hd)},
                      "mamba": {"conv": (n_groups, attn_every, b, k - 1, conv_dim),
                                "state": (n_groups, attn_every, b, h, p, n)}},
           "tail": {"conv", "state"} stacked on the tail's layers (when
                   n_layers % attn_every), "pos"}
  vlm     as dense; a prefill writes vision_tokens + the prompt's entries
  audio   {"self": {"k", "v": (n_layers, b, hkv, S, hd), "pos"},
           "cross": (k, v), each (n_layers, b, hkv, encoder_seq, hd)}
          (the reference's two subtrees; ``pos`` sits in ``self``, and
          ``cross`` is the encoder's K/V, replaced at each prefill)

K/V are in ``cfg.dtype``, mamba ``conv`` too, ``state`` in float32.  The
cache is updated in place and returned with ``pos`` advanced.  ``loss`` is
differentiable (``launch/steps.make_train_step`` runs autograd through it,
each block or group checkpointed per ``cfg.remat``); callers that only
score call it under ``torch.no_grad()``.  The flash-attention kernel has
no backward, nor has the reference's Pallas kernel: with
``attention_impl="pallas"`` a loss that autograd records raises on the
card, and training runs the default ``"xla_flash"``.  ``prefill`` and
``decode`` run under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.layers import (
    RMSNorm,
    cross_entropy_loss,
    dense_init,
    dtype_of,
    embed_init,
    gelu_mlp,
    rmsnorm,
    sinusoidal_embed,
)
from repro_torch.models.ssm import Mamba2, init_mamba_cache
from repro_torch.sharding import tp
from repro_torch.models.transformer import (
    DecoderXBlock,
    DenseBlock,
    EncoderBlock,
    MoEGroup,
    ZambaGroup,
    ZambaShared,
    cross_kv_from_encoder,
    remat_wrap,
)

#: the batch key of each family's stub frontend output
STUB_INPUTS = {"vlm": "patches", "audio": "frames"}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    load: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def build_model(cfg: ArchConfig, device=None) -> ModelBundle:
    """The bundle for ``cfg`` on ``device`` (``None`` means ``"cuda"``;
    ``"meta"`` gives shapes without memory: its ``init_cache`` and ``load``
    work, and ``launch/specs.py`` builds its stand-ins so)."""
    builders = {"dense": _build_dense, "vlm": _build_dense, "moe": _build_moe, "ssm": _build_ssm,
                "hybrid": _build_zamba, "audio": _build_whisper}
    if cfg.family not in builders:
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    return builders[cfg.family](cfg, dev)


def lm_class(cfg: ArchConfig) -> type:
    """The :class:`LM` subclass that :func:`build_model` builds for ``cfg``'s
    family; ``lm_class(cfg)(cfg, device="meta")`` is a model's skeleton
    (shapes and dtypes, no memory)."""
    classes = {"dense": DenseLM, "vlm": VLMLM, "moe": MoELM, "ssm": SSMLM, "hybrid": ZambaLM,
               "audio": WhisperLM}
    if cfg.family not in classes:
        raise ValueError(f"unknown family {cfg.family!r}")
    return classes[cfg.family]


# ---------------------------------------------------------------------------
# shared pieces


class LM(nn.Module):
    """Embedding, final norm and LM head around a family's blocks.

    ``state_dict`` keys follow the reference's parameter tree: ``embed``,
    ``ln_f.scale``, ``lm_head`` (untied only), then the family's blocks with
    one ``<stack>.<i>.`` prefix per entry of a stacked axis (``layers``,
    ``groups``, a group's ``dense_blocks`` or ``mamba``, ``tail``,
    ``encoder``, ``decoder``).  Head parameters (and the vlm projector)
    are in ``cfg.param_dtype``, the blocks in ``cfg.dtype``.
    """

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        pd = dtype_of(cfg.param_dtype)
        v = cfg.vocab_padded  # padded vocab; logits of padded ids are masked
        self.embed = nn.Parameter(torch.empty((v, cfg.d_model), dtype=pd, device=device))
        self.ln_f = RMSNorm(cfg.d_model, pd, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((cfg.d_model, v), dtype=pd, device=device))

    @torch.no_grad()
    def init_(self, gen: torch.Generator, cfg: ArchConfig) -> "LM":
        v, d = self.embed.shape
        self.embed.copy_(embed_init(gen, v, d, self.embed.dtype))
        if hasattr(self, "lm_head"):
            self.lm_head.copy_(dense_init(gen, d, v, self.lm_head.dtype))
        self.init_blocks_(gen, cfg)
        return self

    def forward(self, tokens: torch.Tensor, cfg: ArchConfig, cache: Optional[dict] = None,
                from_zero: bool = False):
        """Final hidden states (b, s, d) and the cache (None without one).
        ``cfg`` is the config the bundle was built with, as the reference's
        backbone takes it."""
        return self.backbone(self.embed_inputs(tokens, cfg), cfg, cache, from_zero)

    def embed_inputs(self, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        """The sequence the backbone reads: the token embeddings."""
        return _embed(self, tokens, cfg)


class DenseLM(LM):
    """``layers``: a stack of :class:`DenseBlock`."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.n_layers))

    def init_blocks_(self, gen, cfg):
        for layer in self.layers:
            layer.init_(gen)

    def backbone(self, x, cfg, cache, from_zero):
        if cache is None:
            for layer in self.layers:
                x, _ = remat_wrap(layer, cfg.remat)(x, cfg)
            return x, None
        for i, layer in enumerate(self.layers):
            c = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
            x, _ = layer(x, cfg, cache=c, from_zero=from_zero)
        return x, {**cache, "pos": cache["pos"] + x.shape[1]}


class Projector(nn.Module):
    """The vlm's patch projector: ``w1 (vision_dim, d)``, ``w2 (d, d)``."""

    def __init__(self, vision_dim: int, d: int, dtype, device=None):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty((vision_dim, d), dtype=dtype, device=device))
        self.w2 = nn.Parameter(torch.empty((d, d), dtype=dtype, device=device))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.w1.copy_(dense_init(gen, *self.w1.shape, self.w1.dtype))
        self.w2.copy_(dense_init(gen, *self.w2.shape, self.w2.dtype))

    def forward(self, patches: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``gelu(patches @ w1) @ w2``, the patches rounded to ``dtype`` first
        and the products in the promoted type, as the reference's
        (float32 with float32 weights); the result is cast to ``dtype``."""
        ct = torch.promote_types(dtype, self.w1.dtype)
        pe = patches.to(dtype).to(ct)
        return gelu_mlp(self.w1.to(ct), self.w2.to(ct), pe).to(dtype)


class VLMLM(DenseLM):
    """A :class:`DenseLM` with a ``projector`` (:class:`Projector`): the
    projected patches go before the token embeddings."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.projector = Projector(cfg.vision_dim, cfg.d_model, dtype_of(cfg.param_dtype), device)

    def init_blocks_(self, gen, cfg):
        super().init_blocks_(gen, cfg)
        self.projector.init_(gen)

    def embed_inputs(self, tokens: torch.Tensor, cfg: ArchConfig,
                     patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sequence the backbone reads: with ``patches`` (scoring and
        prefill) the projected patches, then the token embeddings."""
        x = _embed(self, tokens, cfg)
        if patches is not None:
            x = torch.cat([self.projector(patches, x.dtype), x], dim=1)
        return x

    def forward(self, tokens: torch.Tensor, cfg: ArchConfig, cache: Optional[dict] = None,
                from_zero: bool = False, patches: Optional[torch.Tensor] = None):
        """As :meth:`LM.forward`, the sequence from :meth:`embed_inputs`."""
        return self.backbone(self.embed_inputs(tokens, cfg, patches), cfg, cache, from_zero)


class MoELM(LM):
    """``groups``: ``n_layers // moe_every`` :class:`MoEGroup`."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.groups = nn.ModuleList(MoEGroup(cfg, device) for _ in range(_moe_groups(cfg)))

    def init_blocks_(self, gen, cfg):
        for group in self.groups:
            group.init_(gen)

    def backbone(self, x, cfg, cache, from_zero):
        if cache is None:
            for group in self.groups:
                x, _ = remat_wrap(group, cfg.remat)(x, cfg)
            return x, None
        pos = cache["pos"]
        for g, group in enumerate(self.groups):
            caches = {name: {"k": kv["k"][g], "v": kv["v"][g], "pos": pos}
                      for name, kv in cache.items() if name != "pos"}
            x, _ = group(x, cfg, caches=caches, from_zero=from_zero)
        return x, {**cache, "pos": pos + x.shape[1]}


class SSMLM(LM):
    """``layers``: a stack of :class:`Mamba2` blocks with residuals."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(Mamba2(cfg, device) for _ in range(cfg.n_layers))

    def init_blocks_(self, gen, cfg):
        for layer in self.layers:
            layer.init_(gen, cfg)

    def backbone(self, x, cfg, cache, from_zero):
        del from_zero  # attention-free
        return _mamba_stack(self.layers, x, cfg, cache)


class ZambaLM(LM):
    """``shared`` (:class:`ZambaShared`), ``groups`` (``n_layers //
    attn_every`` :class:`ZambaGroup`) and ``tail`` (the remaining
    :class:`Mamba2` blocks, absent when ``attn_every`` divides
    ``n_layers``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        n_groups, tail = _zamba_groups(cfg)
        self.shared = ZambaShared(cfg, device)
        self.groups = nn.ModuleList(ZambaGroup(cfg, device) for _ in range(n_groups))
        if tail:
            self.tail = nn.ModuleList(Mamba2(cfg, device) for _ in range(tail))

    def init_blocks_(self, gen, cfg):
        self.shared.init_(gen)
        for group in self.groups:
            group.init_(gen, cfg)
        for layer in getattr(self, "tail", ()):
            layer.init_(gen, cfg)

    def backbone(self, x, cfg, cache, from_zero):
        embed0 = x  # the embeddings, fed to every call of the shared block
        if cache is None:
            for group in self.groups:
                x, _ = remat_wrap(group, cfg.remat)(x, self.shared, embed0, cfg)
        else:
            pos, gc = cache["pos"], cache["groups"]
            for g, group in enumerate(self.groups):
                caches = {"attn": {"k": gc["attn"]["k"][g], "v": gc["attn"]["v"][g], "pos": pos},
                          "mamba": {k: t[g] for k, t in gc["mamba"].items()}}
                x, _ = group(x, self.shared, embed0, cfg, caches=caches, from_zero=from_zero)
        if hasattr(self, "tail"):
            x, _ = _mamba_stack(self.tail, x, cfg, None if cache is None else cache["tail"])
        if cache is None:
            return x, None
        return x, {**cache, "pos": cache["pos"] + x.shape[1]}


class WhisperLM(LM):
    """``encoder`` (``encoder_layers`` :class:`EncoderBlock`) and ``decoder``
    (``n_layers`` :class:`DecoderXBlock`) around the shared head (whisper
    ties it to the embedding)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecoderXBlock(cfg, device) for _ in range(cfg.n_layers))

    def init_blocks_(self, gen, cfg):
        for block in (*self.encoder, *self.decoder):
            block.init_(gen)

    def encode(self, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        """The encoder's output (b, s_enc, d) from the frames plus their
        sinusoidal positions."""
        x = encoder_input(frames, cfg)
        for block in self.encoder:
            x = remat_wrap(block, cfg.remat)(x, cfg)
        return x

    def cross_kvs(self, enc_out: torch.Tensor, cfg: ArchConfig):
        """Every decoder layer's cross-attention (k, v), stacked on a
        leading layer axis."""
        kvs = [cross_kv_from_encoder(block, enc_out, cfg) for block in self.decoder]
        return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])

    def dec_embed(self, tokens: torch.Tensor, pos0: int, cfg: ArchConfig) -> torch.Tensor:
        x = _embed(self, tokens, cfg)
        positions = pos0 + torch.arange(x.shape[1], device=x.device)
        return x + sinusoidal_embed(positions, cfg.d_model).to(x.dtype)[None]

    def run_decoder(self, x, kvs, cfg: ArchConfig, cache: Optional[dict] = None, from_zero: bool = False):
        """The decoder over ``x`` against the stacked cross (k, v); ``cache``
        is the ``self`` subtree, updated in place and returned with ``pos``
        advanced."""
        for i, block in enumerate(self.decoder):
            kv = (kvs[0][i], kvs[1][i])
            if cache is None:
                x, _ = remat_wrap(block, cfg.remat)(x, kv, cfg)
            else:
                c = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
                x, _ = block(x, kv, cfg, cache=c, from_zero=from_zero)
        if cache is None:
            return x, None
        return x, {**cache, "pos": cache["pos"] + x.shape[1]}

    def forward(self, tokens: torch.Tensor, cfg: ArchConfig, cache: Optional[dict] = None,
                from_zero: bool = False, frames: Optional[torch.Tensor] = None):
        """Scoring (no cache) and prefill (``from_zero``) encode ``frames``;
        a prefill puts their K/V in the cache's ``cross``, and decode steps
        read them from there."""
        if cache is None or from_zero:
            kvs, pos0 = self.cross_kvs(self.encode(frames, cfg), cfg), 0
            if cache is not None:  # kept as the cache holds them (a mesh may split them)
                kvs = tuple(tp.to_layout(t, like) for t, like in zip(kvs, cache["cross"]))
        else:
            kvs, pos0 = cache["cross"], cache["self"]["pos"]
        x = self.dec_embed(tokens, pos0, cfg)
        x, self_cache = self.run_decoder(x, kvs, cfg, None if cache is None else cache["self"], from_zero)
        return x, None if cache is None else {"self": self_cache, "cross": kvs}


def encoder_input(frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Whisper's encoder input: the frames in ``cfg.dtype`` plus their
    sinusoidal positions."""
    x = frames.to(dtype_of(cfg.dtype))
    return x + sinusoidal_embed(torch.arange(x.shape[1], device=x.device), cfg.d_model).to(x.dtype)[None]


def mamba_residual(layer, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A cache-less mamba2 block with its residual."""
    return x + layer(x, cfg)[0]


def _mamba_stack(layers, x, cfg, cache):
    """Residual mamba2 blocks; ``cache`` (``conv``/``state`` stacked on the
    layer axis) is updated in place and returned."""
    for i, layer in enumerate(layers):
        if cache is None:
            x = remat_wrap(lambda h, blk=layer: mamba_residual(blk, h, cfg), cfg.remat)(x)
            continue
        out, nc = layer(x, cfg, cache={k: t[i] for k, t in cache.items()})
        x = x + out
        for k, t in nc.items():
            cache[k][i].copy_(t)
    return x, cache


def _moe_groups(cfg: ArchConfig) -> int:
    n_groups = cfg.n_layers // cfg.moe_every
    if n_groups * cfg.moe_every != cfg.n_layers:
        raise ValueError(f"moe_every={cfg.moe_every} must divide n_layers={cfg.n_layers}")
    return n_groups


def _zamba_groups(cfg: ArchConfig):
    """(groups, tail layers): 81 layers at attn_every 6 are 13 groups and 3."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


def _vocab_split() -> bool:
    ctx = tp.active()
    return ctx is not None and ctx.vocab


def _logits(params: LM, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The logits of ``h``; under a vocab-split TP context this rank's
    vocab block of them (``embed``/``lm_head`` are then its rows/columns)."""
    h = rmsnorm(params.ln_f.scale, h, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    start = 0
    if _vocab_split():
        h = tp.copy_to_model(h)
        start = tp.active().rank * w.shape[1]
    logits = h @ w.to(h.dtype)
    if cfg.vocab_padded != cfg.vocab:
        pad = start + torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits


def _embed(params: LM, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # gather then cast: the same values as the reference's cast-then-gather
    if _vocab_split():
        return tp.vocab_embed(params.embed, tokens).to(dtype_of(cfg.dtype))
    return params.embed[tokens].to(dtype_of(cfg.dtype))


def head_loss(params: LM, h: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The scoring loss from the backbone's final hidden states ``h`` (over
    vocab-split logits under a vocab-split TP context: never gathered)."""
    if cfg.family == "vlm":
        # the logits that predict the tokens: from the last patch on (the
        # reference slices the full logits; a head over the rows it keeps
        # gives the same values)
        v = cfg.vision_tokens
        logits, labels = _logits(params, h[:, v - 1 : -1], cfg), tokens
    else:
        logits, labels = _logits(params, h, cfg)[:, :-1], tokens[:, 1:]
    if _vocab_split():
        return tp.vocab_cross_entropy(logits, labels)
    return cross_entropy_loss(logits, labels)


def _bundle(cfg: ArchConfig, device: torch.device, init_cache: Callable) -> ModelBundle:
    """The family-independent functions around the family's :func:`lm_class`
    and its cache."""
    model_class = lm_class(cfg)

    def tokens_of(batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], device=device).to(torch.int64)

    def stubs_of(batch) -> dict:
        """The family's stub input (``patches`` or ``frames``) as a tensor."""
        key = STUB_INPUTS.get(cfg.family)
        return {key: torch.as_tensor(batch[key], device=device)} if key else {}

    def init(gen: torch.Generator) -> LM:
        if gen.device.type != device.type:
            raise ValueError(f"generator is on {gen.device}, the model on {device}")
        return model_class(cfg, device).init_(gen, cfg)

    def load(state_dict: Mapping[str, torch.Tensor]) -> LM:
        params = model_class(cfg, device="meta")
        want = params.state_dict()
        sd = {k: torch.as_tensor(v).to(device, want[k].dtype if k in want else None)
              for k, v in state_dict.items()}
        params.load_state_dict(sd, strict=True, assign=True)
        return params

    def loss(params: LM, batch) -> torch.Tensor:
        tokens = tokens_of(batch)
        h, _ = params(tokens, cfg, **stubs_of(batch))
        return head_loss(params, h, tokens, cfg)

    @torch.no_grad()
    def prefill(params: LM, batch, cache: dict):
        h, cache = params(tokens_of(batch), cfg, cache=cache, from_zero=True, **stubs_of(batch))
        return _logits(params, h[:, -1:], cfg), cache

    @torch.no_grad()
    def decode(params: LM, tokens, cache: dict):
        h, cache = params(tokens_of({"tokens": tokens}), cfg, cache=cache)
        return _logits(params, h, cfg), cache

    return ModelBundle(cfg, device, init, load, loss, prefill, decode, init_cache)


def _stacked(make: Callable, *lead: int) -> dict:
    """``make()``'s tensors with zeros stacked on leading axes ``lead``."""
    return {k: t.new_zeros(lead + tuple(t.shape)) for k, t in make().items() if isinstance(t, torch.Tensor)}


# ---------------------------------------------------------------------------
# families


def _build_dense(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    """The dense family, and the vlm (the dense backbone behind its projector)."""
    def init_cache(batch_size: int, max_len: int) -> dict:
        return {**_stacked(_kv(cfg, device, batch_size, max_len), cfg.n_layers), "pos": 0}

    return _bundle(cfg, device, init_cache)


def _kv(cfg: ArchConfig, device, batch_size: int, max_len: int) -> Callable:
    return lambda: init_kv_cache(batch_size, cfg.n_kv_heads, max_len, cfg.resolved_head_dim,
                                 dtype_of(cfg.dtype), device)


def _build_moe(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    n_groups = _moe_groups(cfg)

    def init_cache(batch_size: int, max_len: int) -> dict:
        kv = _kv(cfg, device, batch_size, max_len)
        c = {"moe": _stacked(kv, n_groups), "pos": 0}
        if cfg.moe_every > 1:
            c["dense"] = _stacked(kv, n_groups, cfg.moe_every - 1)
        return c

    return _bundle(cfg, device, init_cache)


def _build_ssm(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def init_cache(batch_size: int, max_len: int) -> dict:
        del max_len  # O(1) state: what lets the ssm family decode the long cells
        return _stacked(lambda: init_mamba_cache(batch_size, cfg, dtype_of(cfg.dtype), device), cfg.n_layers)

    return _bundle(cfg, device, init_cache)


def _build_zamba(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    n_groups, tail = _zamba_groups(cfg)

    def init_cache(batch_size: int, max_len: int) -> dict:
        mc = lambda: init_mamba_cache(batch_size, cfg, dtype_of(cfg.dtype), device)  # noqa: E731
        c = {"groups": {"attn": _stacked(_kv(cfg, device, batch_size, max_len), n_groups),
                        "mamba": _stacked(mc, n_groups, cfg.attn_every)}, "pos": 0}
        if tail:
            c["tail"] = _stacked(mc, tail)
        return c

    return _bundle(cfg, device, init_cache)


def _build_whisper(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def init_cache(batch_size: int, max_len: int) -> dict:
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, cfg.encoder_seq, cfg.resolved_head_dim)
        cross = tuple(torch.zeros(shape, dtype=dtype_of(cfg.dtype), device=device) for _ in range(2))
        return {"self": {**_stacked(_kv(cfg, device, batch_size, max_len), cfg.n_layers), "pos": 0},
                "cross": cross}

    return _bundle(cfg, device, init_cache)
