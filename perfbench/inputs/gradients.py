"""Inputs ``gradients``: one gradient set in the reference layout that the
trainer hands the client (``lm_params_to_reference`` of the port's model
built on the meta device, less the configuration's ``"leaves_elsewhere"``):
standard normal times a lognormal scale per leaf and per row (all axes but
the last).  Every call takes the same set."""

from __future__ import annotations

import torch

from perfbench import generate


def make(config: dict, traffic: dict, seed: int, device) -> generate.Inputs:
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.models.model import lm_class

    cfg = generate.arch_config(config)
    _, gen = generate.generators(seed, device)
    values = config["assumed"]["values"]
    skip = tuple(config.get("leaves_elsewhere", ()))
    named = {k: v for k, v in lm_class(cfg)(cfg, device="meta").named_parameters()
             if not skip or not k.startswith(skip)}
    # the reference layout of one-value stand-ins: each leaf's stack shape
    # and its first member's name (stacking meta tensors loads much of torch)
    names = list(named)
    index = lm_params_to_reference({k: torch.tensor([float(i)]) for i, k in enumerate(names)}, cfg)

    def fill(node):
        out = {}
        for name in sorted(node):
            v = node[name]
            if isinstance(v, dict):
                out[name] = fill(v)
                continue
            first = named[names[int(v.reshape(-1)[0])]]
            shape = tuple(v.shape[:-1]) + tuple(first.shape)
            x = torch.randn(shape, generator=gen, device=device)
            x *= generate.lognormal((), values["leaf_log_sigma"], gen, device)
            if len(shape) >= 2:
                x *= generate.lognormal(shape[:-1] + (1,), values["row_log_sigma"], gen, device)
            out[name] = x.to(first.dtype)
        return out

    grads = fill(index)
    return generate.Inputs([grads], [0], [sum(t.numel() for t in generate.tensors(grads))])
