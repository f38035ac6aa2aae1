"""Batched decode engine over a request queue.

Flow per admitted batch: front-pad the prompts to a common length ->
prefill (one call over the whole prompt) -> optional FFCz KV-cache
compression (``cfg.compression.kv_cache_compression``, through the shared
:func:`repro_torch.core.engine.default_engine` of the model's device) ->
greedy decode steps, one token per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.engine import default_engine
from repro_torch.models.model import build_model
from repro_torch.serving.kv_compress import compress_cache


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    max_new_tokens: int = 32


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16


class ServingEngine:
    """``params``: a model from ``build_model(cfg).init``/``load``, a state dict
    (see ``convert.lm_params_from_reference``), or None to initialise one
    from ``rng_seed``.  ``device=None`` means ``"cuda"``."""

    def __init__(self, cfg: ArchConfig, serve: ServeConfig, params=None, rng_seed: int = 0, device=None):
        self.cfg = cfg
        self.serve = serve
        self.bundle = build_model(cfg, device)
        self.device = self.bundle.device
        if params is None:
            params = self.bundle.init(torch.Generator(device=self.device).manual_seed(rng_seed))
        elif isinstance(params, Mapping):
            params = self.bundle.load(params)
        self.params = params
        self._prefill = self.bundle.prefill
        self._decode = self.bundle.decode
        self.queue: List[Request] = []
        self._uid = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        """Validate and queue one request (validation at submission, so an
        invalid prompt never reaches a batch shared with valid ones)."""
        prompt = np.asarray(prompt, dtype=np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, got shape {prompt.shape}")
        if prompt.size > self.serve.max_len:
            raise ValueError(f"prompt length {prompt.size} exceeds max_len={self.serve.max_len}")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab:
            raise ValueError(f"prompt ids must be in [0, {self.cfg.vocab}), got range [{lo}, {hi}]")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self._uid += 1
        self.queue.append(Request(self._uid, prompt, max_new_tokens))
        return self._uid

    def _make_batch(self, reqs: List[Request]) -> Dict[str, Any]:
        """Front-pad prompts to a common length (pad tokens come causally
        before every real token and logits are taken at the last position).
        The vlm and audio families get zero ``patches`` or ``frames`` (their
        stub frontends' outputs), as the reference's engine gives them."""
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), plen), dtype=np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt) :] = r.prompt
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.cfg.family == "vlm":
            batch["patches"] = torch.zeros((len(reqs), self.cfg.vision_tokens, self.cfg.vision_dim),
                                           dtype=torch.float32, device=self.device)
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros((len(reqs), self.cfg.encoder_seq, self.cfg.d_model),
                                          dtype=torch.float32, device=self.device)
        return batch

    def cache_len(self, batch: Dict[str, Any], n_new: int) -> int:
        """The cache entries a batch needs: its prompt and ``n_new`` tokens,
        and for the vlm the ``vision_tokens`` its prefill writes first.  (The
        reference's engine sizes a vlm cache without them, and its prefill
        raises on the shorter cache: ROADMAP.md Queue 3, reference caveat (c).)"""
        vision = self.cfg.vision_tokens if self.cfg.family == "vlm" else 0
        return vision + batch["tokens"].shape[1] + n_new

    def step(self) -> List[Dict[str, Any]]:
        """Serve one admitted batch from the queue; returns completions."""
        if not self.queue:
            return []
        reqs, self.queue = self.queue[: self.serve.max_batch], self.queue[self.serve.max_batch :]
        batch = self._make_batch(reqs)
        n_new = max(r.max_new_tokens for r in reqs)
        cache = self.bundle.init_cache(len(reqs), self.cache_len(batch, n_new))
        logits, cache = self._prefill(self.params, batch, cache)
        if self.cfg.compression.kv_cache_compression and self.cfg.family != "ssm":
            cache = compress_cache(cache, self.cfg.compression, engine=default_engine(self.device))
        outs = [torch.argmax(logits[:, -1], dim=-1)]
        for _ in range(n_new - 1):
            logits, cache = self._decode(self.params, outs[-1][:, None], cache)
            outs.append(torch.argmax(logits[:, -1], dim=-1))
        gen = torch.stack(outs, dim=1).cpu().numpy()  # (b, n_new)
        return [
            {"uid": r.uid, "tokens": gen[i, : r.max_new_tokens].tolist()}
            for i, r in enumerate(reqs)
        ]
