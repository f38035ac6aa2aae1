"""Inputs ``kv_cache``: requests' KV caches, laid out as the port's serving
cache is (``build_model(cfg, "meta").init_cache``), one request a call, at
the mix's context lengths (``generate.context_lengths``) in a seed-drawn
order: ``k``/``v`` standard normal times a lognormal scale per (layer,
head, channel), cast to the cache's dtype."""

from __future__ import annotations

import torch

from perfbench import generate


def _cache(cfg, config: dict, length: int, gen, device) -> dict:
    from repro_torch.models.model import build_model

    values = config["assumed"]["values"]
    layout = build_model(cfg, device="meta").init_cache(config["batch"], length)

    def fill(node):
        out = {}
        for name, v in node.items():
            if isinstance(v, dict):
                out[name] = fill(v)
            elif isinstance(v, torch.Tensor) and name in ("k", "v") and v.ndim >= 4:
                scale_shape = tuple(v.shape[:-3]) + (v.shape[-3], 1, v.shape[-1])
                x = torch.randn(tuple(v.shape), generator=gen, device=device)
                x *= generate.lognormal(scale_shape, values[f"{name}_channel_log_sigma"], gen, device)
                out[name] = x.to(v.dtype)
            elif isinstance(v, torch.Tensor):
                out[name] = torch.zeros(tuple(v.shape), dtype=v.dtype, device=device)
            else:
                out[name] = length if name == "pos" else v
        return out

    return fill(layout)


def make(config: dict, traffic: dict, seed: int, device) -> generate.Inputs:
    cfg = generate.arch_config(config)
    rng, gen = generate.generators(seed, device)
    lengths = generate.context_lengths(traffic)
    items = [_cache(cfg, config, n, gen, device) for n in lengths]
    order = [int(j) for j in rng.permutation(len(items))]
    return generate.Inputs(items, order, lengths)
