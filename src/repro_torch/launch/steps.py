"""Step functions (train / prefill / serve) of one device.

``make_train_step(bundle, optimizer)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, loss)``: the loss and its gradients
by autograd, FFCz gradient compression when the config asks for it, then
the AdamW update written into the model's parameters.  ``params`` is the
bundle's ``DenseLM``, ``opt_state`` AdamW's state over its ``state_dict``
names.  The gradients are compressed in the reference's tree layout (each
layer tensor stacked on a layer axis), so every tensor's E and Delta and its
pencils are the reference's.

``make_step`` (step functions with their shardings over a mesh) needs a
mesh and is not ported (ROADMAP.md Queue 1, slice 6).
"""

from __future__ import annotations

import torch

from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.models.model import ModelBundle
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad_compress import compress_gradients


def make_train_step(bundle: ModelBundle, optimizer: AdamW):
    cfg = bundle.cfg
    comp = cfg.compression

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        with torch.enable_grad():
            loss = bundle.loss(params, batch)
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        if comp.grad_compression:
            grads = lm_params_from_reference(compress_gradients(
                lm_params_to_reference(grads, cfg),
                bits=comp.grad_bits,
                E_rel=comp.grad_E_rel,
                Delta_rel=comp.grad_Delta_rel,
                block=comp.grad_block,
            ), cfg)
        new_params, opt_state = optimizer.update(grads, opt_state, {k: p.detach() for k, p in named.items()})
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new_params[k])
        return params, opt_state, loss.detach()

    return train_step


def make_prefill_step(bundle: ModelBundle):
    def prefill_step(params, batch, cache):
        return bundle.prefill(params, batch, cache)

    return prefill_step


def make_serve_step(bundle: ModelBundle):
    def serve_step(params, tokens, cache):
        return bundle.decode(params, tokens, cache)

    return serve_step


def make_step(cfg, shape_id: str, mesh, optimizer=None):
    raise NotImplementedError(
        "make_step builds step functions over a device mesh, which is not ported to repro_torch yet "
        "(ROADMAP.md Queue 1, slice 6)"
    )
