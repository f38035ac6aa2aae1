"""Top-level model builder: one bundle of functions per architecture family.

``build_model(cfg, device=None)`` returns a :class:`ModelBundle`:

  init(generator)                    -> params (a :class:`DenseLM`)
  load(state_dict)                   -> params from a state dict (port only;
                                        see ``convert.lm_params_from_reference``)
  loss(params, batch)                -> scalar CE loss (teacher-forced scoring)
  prefill(params, batch, cache)      -> (last logits, cache)
  decode(params, tokens, cache)      -> (logits, cache)
  init_cache(batch_size, max_len)    -> cache

The reference ``lax.scan``s one block over parameters stacked on a layer
axis; here the layers are an ``nn.ModuleList`` run by a Python loop, and the
cache holds each layer's K and V stacked on a leading layer axis.  ``loss``
is differentiable (``launch/steps.make_train_step`` runs autograd through
it, each block checkpointed per ``cfg.remat``); callers that only score call
it under ``torch.no_grad()``.  The flash-attention kernel has no backward,
nor has the reference's Pallas kernel: with ``attention_impl="pallas"`` a
loss that autograd records raises on the card, and training runs the
default ``"xla_flash"``.  ``prefill`` and ``decode`` run under
``torch.no_grad()``.  Only ``family="dense"`` is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import RMSNorm, cross_entropy_loss, dense_init, dtype_of, embed_init, rmsnorm
from repro_torch.models.transformer import DenseBlock, remat_wrap

_UNPORTED_FAMILIES = ("moe", "ssm", "hybrid", "vlm", "audio")


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
    """The bundle for ``cfg`` on ``device`` (``None`` means ``"cuda"``)."""
    if cfg.family == "dense":
        return _build_dense(cfg, resolve_device(device))
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1, slice 6)"
        )
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# shared pieces


class DenseLM(nn.Module):
    """Embedding, a stack of :class:`DenseBlock`, final norm and LM head.

    ``state_dict`` keys follow the reference's parameter tree: ``embed``,
    ``ln_f.scale``, ``lm_head`` (untied only) and ``layers.<i>.<path>``.
    Head parameters are in ``cfg.param_dtype``, the blocks in ``cfg.dtype``.
    """

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        pd = dtype_of(cfg.param_dtype)
        v = cfg.vocab_padded  # padded vocab; logits of padded ids are masked
        self.embed = nn.Parameter(torch.empty((v, cfg.d_model), dtype=pd, device=device))
        self.ln_f = RMSNorm(cfg.d_model, pd, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((cfg.d_model, v), dtype=pd, device=device))
        self.layers = nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "DenseLM":
        v, d = self.embed.shape
        self.embed.copy_(embed_init(gen, v, d, self.embed.dtype))
        if hasattr(self, "lm_head"):
            self.lm_head.copy_(dense_init(gen, d, v, self.lm_head.dtype))
        for layer in self.layers:
            layer.init_(gen)
        return self

    def forward(self, tokens: torch.Tensor, cfg: ArchConfig, cache: Optional[dict] = None,
                from_zero: bool = False):
        """Final hidden states (b, s, d) and the cache (None without one).
        ``cfg`` is the config the bundle was built with, as the reference's
        backbone takes it."""
        x = _embed(self, tokens, cfg)
        if cache is None:
            for layer in self.layers:
                x, _ = remat_wrap(layer, cfg.remat)(x, cfg)
            return x, None
        for i, layer in enumerate(self.layers):
            c = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
            x, _ = layer(x, cfg, cache=c, from_zero=from_zero)
        return x, {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + tokens.shape[1]}


def _logits(params: DenseLM, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(params.ln_f.scale, h, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = h @ w.to(h.dtype)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits


def _embed(params: DenseLM, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # gather then cast: the same values as the reference's cast-then-gather
    return params.embed[tokens].to(dtype_of(cfg.dtype))


def _lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


# ---------------------------------------------------------------------------
# dense


def _build_dense(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def tokens_of(batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], device=device).to(torch.int64)

    def init(gen: torch.Generator) -> DenseLM:
        if gen.device.type != device.type:
            raise ValueError(f"generator is on {gen.device}, the model on {device}")
        return DenseLM(cfg, device).init_(gen)

    def load(state_dict: Mapping[str, torch.Tensor]) -> DenseLM:
        params = DenseLM(cfg, device="meta")
        want = params.state_dict()
        sd = {k: torch.as_tensor(v).to(device, want[k].dtype if k in want else None)
              for k, v in state_dict.items()}
        params.load_state_dict(sd, strict=True, assign=True)
        return params

    def loss(params: DenseLM, batch) -> torch.Tensor:
        tokens = tokens_of(batch)
        h, _ = params(tokens, cfg)
        return _lm_loss(_logits(params, h, cfg), tokens)

    def init_cache(batch_size: int, max_len: int) -> dict:
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
        dtype = dtype_of(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}

    @torch.no_grad()
    def prefill(params: DenseLM, batch, cache: dict):
        h, cache = params(tokens_of(batch), cfg, cache=cache, from_zero=True)
        return _logits(params, h[:, -1:], cfg), cache

    @torch.no_grad()
    def decode(params: DenseLM, tokens, cache: dict):
        h, cache = params(tokens_of({"tokens": tokens}), cfg, cache=cache)
        return _logits(params, h, cfg), cache

    return ModelBundle(cfg, device, init, load, loss, prefill, decode, init_cache)
