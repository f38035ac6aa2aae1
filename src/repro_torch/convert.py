"""Carry the reference package's state into the port.

For the codec, the state that crosses between the two packages is the
whole-field plan and the loop result, and for pencil batches the pencil plan
and the per-instance stats.  ``plan_from_reference``,
``result_from_reference``, ``pencil_plan_from_reference`` and
``batch_stats_from_reference`` take the reference dataclass's fields as
plain numpy arrays and Python scalars (for example
``{k: np.asarray(v) for k, v in dataclasses.asdict(ref_plan).items()}``,
with ``None`` kept as ``None``) and build the port's dataclass, so one
package's PLAN can feed the other's EXECUTE and one's result the other's
ENCODE.  For the LM framework, ``lm_params_from_reference`` turns a
reference parameter tree (dense, moe, ssm or hybrid) into the port model's
``state_dict`` and ``lm_params_to_reference`` goes back; ``opt_state_from_reference`` /
``opt_state_to_reference`` do the same for AdamW's ``{"m", "v", "step"}``.
The trainer checkpoints ``(params, opt_state)`` in the reference's layout,
so a checkpoint directory restores in either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.blockwise import BatchCorrectionStats
from repro_torch.core.engine import FieldPlan, FieldResult, PencilPlan


def _scalar_or_grid(v, dtype):
    a = np.asarray(v)
    return float(a) if a.ndim == 0 else np.array(a, dtype=dtype)


def plan_from_reference(d: dict) -> FieldPlan:
    """A :class:`FieldPlan` from the reference ``FieldPlan``'s fields."""
    names = {f.name for f in dataclasses.fields(FieldPlan)}
    if set(d) != names:
        raise ValueError(f"plan fields differ: extra {set(d) - names}, missing {names - set(d)}")
    grid = lambda v: None if v is None else np.array(v, dtype=np.float32)  # noqa: E731
    return FieldPlan(
        shape=tuple(int(n) for n in np.asarray(d["shape"]).reshape(-1)),
        E=float(d["E"]),
        Delta=_scalar_or_grid(d["Delta"], np.float32),
        E_proj=float(d["E_proj"]),
        Delta_proj=_scalar_or_grid(d["Delta_proj"], np.float32),
        slack_f=float(d["slack_f"]),
        pointwise=bool(d["pointwise"]),
        quant_bits=int(d["quant_bits"]),
        max_iters=int(d["max_iters"]),
        relax=float(d["relax"]),
        use_kernels=bool(d["use_kernels"]),
        codec=str(d["codec"]),
        fft_impl=str(d["fft_impl"]),
        check_every=int(d["check_every"]),
        warm_start=bool(d["warm_start"]),
        E_grid=grid(d["E_grid"]),
        E_grid_proj=grid(d["E_grid_proj"]),
    )


def result_from_reference(d: dict) -> FieldResult:
    """A :class:`FieldResult` from the reference ``FieldResult``'s fields."""
    names = {f.name for f in dataclasses.fields(FieldResult)}
    if set(d) != names:
        raise ValueError(f"result fields differ: extra {set(d) - names}, missing {names - set(d)}")
    return FieldResult(
        eps=np.array(d["eps"], dtype=np.float64),
        spat=np.array(d["spat"], dtype=np.float64),
        freq=np.array(d["freq"], dtype=np.complex128),
        iterations=int(d["iterations"]),
        converged=bool(d["converged"]),
        final_violations=int(d["final_violations"]),
    )


def _check_fields(cls, d: dict, what: str) -> None:
    names = {f.name for f in dataclasses.fields(cls)}
    if set(d) != names:
        raise ValueError(f"{what} fields differ: extra {set(d) - names}, missing {names - set(d)}")


def pencil_plan_from_reference(d: dict) -> PencilPlan:
    """A :class:`PencilPlan` from the reference ``PencilPlan``'s fields."""
    _check_fields(PencilPlan, d, "pencil plan")
    return PencilPlan(
        block=int(d["block"]),
        quant_bits=int(d["quant_bits"]),
        E=float(d["E"]),
        Delta=float(d["Delta"]),
        E_proj=float(d["E_proj"]),
        Delta_proj=float(d["Delta_proj"]),
    )


def batch_stats_from_reference(d: dict, device="cpu") -> BatchCorrectionStats:
    """A :class:`BatchCorrectionStats` (tensors on ``device``) from the
    reference's fields."""
    _check_fields(BatchCorrectionStats, d, "batch stats")
    ints = lambda k: torch.tensor(np.asarray(d[k], dtype=np.int32), device=device)  # noqa: E731
    bools = lambda k: torch.tensor(np.asarray(d[k], dtype=bool), device=device)  # noqa: E731
    return BatchCorrectionStats(
        iterations=ints("iterations"),
        converged=bools("converged"),
        block_iterations=ints("block_iterations"),
        block_converged=bools("block_converged"),
    )


def _tensor(a) -> torch.Tensor:
    """A torch tensor with ``a``'s values and dtype (bfloat16 kept bitwise)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch.from_numpy
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


#: subtrees of the reference's LM parameter tree whose leaves carry a leading
#: stacked axis, one entry a layer or group (``stack_init``): the dense, vlm
#: and ssm ``layers``, the moe and hybrid ``groups``, inside a moe group its
#: ``dense_blocks`` and inside a hybrid group its ``mamba`` blocks, the
#: hybrid's mamba ``tail``, and whisper's ``encoder`` and ``decoder``
_STACKED = ("layers", "groups", "dense_blocks", "mamba", "tail", "encoder", "decoder")


def _stack_sizes(cfg) -> dict:
    """The length of each stacked axis of ``cfg``'s parameter tree."""
    if cfg.family in ("dense", "vlm", "ssm"):
        return {"layers": cfg.n_layers}
    if cfg.family == "moe":
        return {"groups": cfg.n_layers // cfg.moe_every, "dense_blocks": cfg.moe_every - 1}
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        return {"groups": n_groups, "mamba": cfg.attn_every, "tail": cfg.n_layers - n_groups * cfg.attn_every}
    if cfg.family == "audio":
        return {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
    raise ValueError(f"unknown family {cfg.family!r}")


def lm_params_from_reference(params_np: dict, cfg) -> dict:
    """The port model's state dict from a reference LM parameter tree.

    ``params_np`` is the tree ``repro.models.model.build_model(cfg).init``
    returns, with numpy leaves (``jax.tree.map(np.asarray, params)``) or
    torch tensors.  Each stacked subtree (:data:`_STACKED`: ``layers``,
    ``groups``, a group's ``dense_blocks`` or ``mamba``, ``tail``,
    ``encoder``, ``decoder``) is split
    along its leading axis into one ``<name>.<i>.`` prefix an entry, nested
    as the stacks nest (``groups.<g>.mamba.<j>.in_proj``); the vlm's
    ``projector`` is not stacked (``projector.w1``).  Values and dtypes
    are kept exactly (the moe experts stay padded to ``n_experts_padded``,
    the router not); a tensor leaf's entries are views of it.
    """
    sizes = _stack_sizes(cfg)
    out = {}

    def walk(tree, prefix, index):
        for name, v in tree.items():
            key = f"{prefix}{name}"
            if isinstance(v, dict) and name in _STACKED:
                n = {tuple(leaf.shape)[len(index)] for leaf in _leaves(v)}
                if n != {sizes.get(name)}:
                    raise ValueError(f"stacked axis of {key!r} is {sorted(n)}, want {sizes.get(name)} for {cfg.name}")
                for i in range(sizes[name]):
                    walk(v, f"{key}.{i}.", index + (i,))
            elif isinstance(v, dict):
                walk(v, key + ".", index)
            elif isinstance(v, torch.Tensor):
                out[key] = v[index] if index else v
            else:
                out[key] = _tensor(np.asarray(v)[index] if index else v)

    walk(params_np, "", ())
    return out


def lm_params_to_reference(state_dict, cfg) -> dict:
    """The reference's LM parameter tree from a mapping with the port's
    ``state_dict`` keys (parameters, gradients or AdamW moments): nested
    dicts, the entries of each stacked subtree stacked on its leading axis
    (inner stacks first, so a moe group's dense blocks are ``(n_groups,
    moe_every - 1, ...)``).  Tensors stay on their device and dtype."""
    sizes = _stack_sizes(cfg)
    tree: dict = {}
    for key, t in state_dict.items():
        path, node, i = key.split("."), tree, 0
        while i < len(path) - 1:
            node = node.setdefault(path[i], {})
            if path[i] in _STACKED:
                node = node.setdefault(int(path[i + 1]), {})
                i += 1
            i += 1
        node[path[-1]] = t

    def finish(node):
        out = {}
        for name, v in node.items():
            if not isinstance(v, dict):
                out[name] = v
            elif name in _STACKED:
                if sorted(v) != list(range(sizes.get(name, -1))):
                    raise ValueError(f"{name} entries {sorted(v)} do not match {sizes.get(name)} for {cfg.name}")
                out[name] = _stack_trees([finish(v[i]) for i in range(sizes[name])])
            else:
                out[name] = finish(v)
        return out

    return finish(tree)


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def opt_state_to_reference(state: dict, cfg) -> dict:
    """AdamW's ``{"m", "v", "step"}`` with the moments in the reference's tree."""
    return {"m": lm_params_to_reference(state["m"], cfg), "v": lm_params_to_reference(state["v"], cfg),
            "step": state["step"]}


def opt_state_from_reference(state: dict, cfg) -> dict:
    """The inverse of :func:`opt_state_to_reference`."""
    return {"m": lm_params_from_reference(state["m"], cfg), "v": lm_params_from_reference(state["v"], cfg),
            "step": state["step"]}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))
