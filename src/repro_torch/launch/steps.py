"""Step functions (train / prefill / serve) of one device.

``make_train_step(bundle, optimizer)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, loss)``: the loss and its gradients
by autograd, FFCz gradient compression when the config asks for it, then
the AdamW update written into the model's parameters.  ``params`` is the
bundle's model (any family's :class:`~repro_torch.models.model.LM`),
``opt_state`` AdamW's state over its ``state_dict`` names.  Autograd runs
over every parameter the loss reaches: zamba2's shared block sums the
gradients of its calls, the vlm's projector trains (its patches are inputs),
whisper's encoder and decoder train, and the MoE router trains through the
combine weights (a pair dropped at capacity contributes nothing, so it gets
no gradient).  The gradients are compressed in the reference's tree layout
(each stacked subtree stacked on its leading axes), so every tensor's E and
Delta and its pencils are the reference's; ``engine`` is the
:class:`~repro_torch.core.engine.CorrectionEngine` that corrects them
(``None``: the device's default engine, whose ``fft_impl`` is the
reference's ``"xla"``; pass ``CorrectionEngine(fft_impl="pallas")`` for the
per-pencil kernels).

``make_step`` (step functions with their shardings over a mesh) needs a
mesh and is not ported (ROADMAP.md Queue 1, item 5d).
"""

from __future__ import annotations

import torch

from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.models.model import ModelBundle
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad_compress import compress_gradients


def make_train_step(bundle: ModelBundle, optimizer: AdamW, engine=None):
    cfg = bundle.cfg
    comp = cfg.compression

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        with torch.enable_grad():
            loss = bundle.loss(params, batch)
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        if comp.grad_compression:
            # the reference's layout stacks copies: the port's go first
            stacked = lm_params_to_reference(grads, cfg)
            del grads
            grads = lm_params_from_reference(compress_gradients(
                stacked,
                bits=comp.grad_bits,
                E_rel=comp.grad_E_rel,
                Delta_rel=comp.grad_Delta_rel,
                block=comp.grad_block,
                engine=engine,
            ), cfg)
            del stacked
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
        "(ROADMAP.md Queue 1, item 5d)"
    )
