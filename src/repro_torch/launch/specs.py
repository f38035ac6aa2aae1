"""Stand-ins for every model input on the ``meta`` device (no allocation).

``input_specs(cfg, shape_id)`` returns the arguments of the step function of
that cell kind, as meta tensors of their global shapes:

  train:   {"batch": {...}}                               -> train step
  prefill: {"batch": {...}, "cache": fresh-cache specs}   -> prefill step
  decode:  {"tokens": (B, 1), "cache": full-length specs} -> serve step

The reference returns ``jax.ShapeDtypeStruct``s from ``jax.eval_shape``;
meta tensors carry the same shapes and dtypes and allocate nothing.
Parameters are the port's state dict (one entry a layer), caches the
port's layout (``models/model.py``: one Python-int ``pos``).  Modality
frontends are stubs: audio takes precomputed frame embeddings, vlm
precomputed patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import SHAPES, ArchConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import build_model, lm_class


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, seq: int, batch: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    act = dtype_of(cfg.dtype)
    if cfg.family == "vlm":
        text = seq - cfg.vision_tokens
        if text <= 0:
            raise ValueError("vlm sequence must exceed vision token count")
        out["tokens"] = _meta((batch, text), torch.int32)
        out["patches"] = _meta((batch, cfg.vision_tokens, cfg.vision_dim), act)
    elif cfg.family == "audio":
        out["tokens"] = _meta((batch, seq), torch.int32)
        out["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model), act)
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    return out


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> Any:
    return build_model(cfg, device="meta").init_cache(batch, max_len)


def param_specs(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The model's state dict on the meta device (port names)."""
    return lm_class(cfg)(cfg, device="meta").state_dict()


def input_specs(cfg: ArchConfig, shape_id: str) -> Dict[str, Any]:
    seq, batch, kind = SHAPES[shape_id]
    if kind == "train":
        return {"batch": batch_specs(cfg, seq, batch)}
    if kind == "prefill":
        return {"batch": batch_specs(cfg, seq, batch), "cache": cache_specs(cfg, batch, seq)}
    if kind == "decode":
        return {"tokens": _meta((batch, 1), torch.int32), "cache": cache_specs(cfg, batch, seq)}
    raise ValueError(shape_id)
