"""Step functions (train / prefill / serve), on one device and over a mesh.

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

``make_step(cfg, shape_id, mesh)`` returns ``(step, args, in_shardings,
out_shardings)`` as the reference's does, over a ``DeviceMesh`` of
("data", "model") or ("pod", "data", "model") axes: ``args`` are the meta
tensors of ``launch/specs.input_specs`` (global shapes; parameters as the
port's state dict), the shardings the rules' DTensor placements of each
argument and result, and ``step`` runs on each rank's local state
(:mod:`repro_torch.sharding.fsdp`): train steps FSDP on the rules' "data"
placements and tensor and expert parallelism on their "model" ones, the
batch split by ``batch_pspec``; prefill and decode steps split the batch
and the cache by ``cache_pspecs`` and return each rank's rows and vocab
block of the logits (``_logits_spec``).
"""

from __future__ import annotations

import dataclasses

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


def make_step(cfg, shape_id: str, mesh, optimizer: AdamW | None = None, engine=None):
    """Build ``(step, args, in_shardings, out_shardings)`` for the cell
    ``shape_id`` of ``SHAPES`` over ``mesh``.

    train:   ``step(params, opt_state, batch) -> (params, opt_state, loss)``
             (:class:`~repro_torch.sharding.fsdp.MeshTrainStep`; its
             ``init_state(generator)`` gives this rank's initial shards)
    prefill: ``step(params, batch, cache) -> (logits, cache)``
    decode:  ``step(params, tokens, cache) -> (logits, cache)``
             (:class:`~repro_torch.sharding.fsdp.MeshServe`)

    ``params`` and ``opt_state`` are this rank's shards, ``batch`` and
    ``tokens`` the global batch, ``cache`` this rank's.  ``engine`` is
    the train step's gradient compression's."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import input_specs, param_specs
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.rules import P, batch_pspec, cache_pspecs, mesh_sizes, placements, to_shardings

    fsdp.require_device_mesh(mesh, "make_step")
    # the mesh's axes on the config: the models' layout hints read them
    cfg = dataclasses.replace(cfg, mesh_axes=tuple(mesh_sizes(mesh).items()))
    seq, batch, kind = SHAPES[shape_id]
    optimizer = optimizer or AdamW()
    layout = fsdp.MeshLayout(cfg, mesh)
    p_abs = param_specs(cfg)
    p_shard = layout.placements
    specs = input_specs(cfg, shape_id)

    if kind == "train":
        step = fsdp.MeshTrainStep(layout, optimizer, engine)
        opt_abs = optimizer.init(p_abs)
        opt_shard = to_shardings(optimizer.state_pspecs(layout.specs), mesh)
        b_shard = to_shardings(batch_pspec(specs["batch"], mesh), mesh)
        args = (p_abs, opt_abs, specs["batch"])
        return step, args, (p_shard, opt_shard, b_shard), (p_shard, opt_shard, placements(P(), mesh))

    c_shard = to_shardings(cache_pspecs(specs["cache"], mesh), mesh)
    if kind == "prefill":
        b_shard = to_shardings(batch_pspec(specs["batch"], mesh), mesh)
        args = (p_abs, specs["batch"], specs["cache"])
        logits = placements(_logits_spec(specs["batch"], mesh), mesh)
        return fsdp.MeshServe(layout, "prefill"), args, (p_shard, b_shard, c_shard), (logits, c_shard)
    if kind == "decode":
        t_shard = to_shardings(batch_pspec({"tokens": specs["tokens"]}, mesh), mesh)["tokens"]
        args = (p_abs, specs["tokens"], specs["cache"])
        logits = placements(_logits_spec({"tokens": specs["tokens"]}, mesh), mesh)
        return fsdp.MeshServe(layout, "decode"), args, (p_shard, t_shard, c_shard), (logits, c_shard)
    raise ValueError(kind)


def _logits_spec(batch_specs_dict, mesh):
    """Logits (b, s, V): batch over the DP axes when divisible, vocab on model."""
    from repro_torch.sharding.rules import P, batch_pspec

    spec = batch_pspec(batch_specs_dict, mesh)["tokens"]
    return P(spec[0] if len(spec) else None, None, "model")
