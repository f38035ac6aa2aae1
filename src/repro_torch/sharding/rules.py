"""Path-based partition rules for params, caches and batches.

The reference's strategy (MaxText-style GSPMD), rule for rule:

  * TP  - "model" axis: attention head projections, MLP hidden dim, vocab.
  * EP  - "model" axis on the expert dim of MoE tensors.
  * FSDP- "data" axis on the other large dim of every weight (ZeRO-3).
  * DP  - batch over ("pod", "data") when divisible (greedy prefix).

A spec is a :class:`PartitionSpec`, a tuple with one entry a tensor dim:
``None`` (not split), a mesh axis name, or a tuple of names, as the
reference's ``jax.sharding.PartitionSpec``.  The rules match on the
reference's tree paths.  The port keeps one block a layer (``layers.<i>.attn.wqkv`` where the reference stacks
``layers/attn/wqkv`` on a leading axis), so a port parameter's rule is its
reference path's, and the reference's leading stack axes (``None`` there)
are simply absent: :func:`param_pspecs` of a port state dict gives each
tensor the reference spec with the stack axes dropped, and of a nested
reference-layout tree the reference spec itself.

Meshes are read through their axis names and shape only, as the
reference's rules read them: a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``, ``shape``) or any stand-in with ``axis_names`` and a
``devices`` array (``tests/test_sharding.py``'s ``_FakeMesh``).
:func:`to_shardings` turns specs into DTensor placements over the mesh's
dims (``Shard(d)`` / ``Replicate()``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class PartitionSpec(tuple):
    """A spec: a tuple of per-dim entries (``None``, an axis name or a tuple
    of names).  Compares equal to the plain tuple of its entries; its own
    type tells it from a tuple container in a spec tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a shape-only stand-in."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    shape = mesh.devices.shape if hasattr(mesh, "devices") else tuple(mesh.shape)
    return dict(zip(tuple(names), (int(n) for n in shape)))


def _axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))


def _names(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# parameter rules: (path suffix match) -> spec for the trailing dims


_RULES = [
    # vlm projector (small, replicate)
    (("projector", "w1"), P(None, None)),
    (("projector", "w2"), P(None, None)),
    # embeddings / head: vocab on model (TP), d_model on data (FSDP)
    (("embed",), P("model", "data")),
    (("lm_head",), P("data", "model")),
    # attention: head-major fused QKV (d, H, hd) / wo (hq, hd, d); the head
    # axis gets "model" only when divisible (the guard below)
    (("attn", "wqkv"), P("data", "model", None)),
    (("attn", "wo"), P("model", None, "data")),
    (("attn", "bqkv"), P("model", None)),
    (("self_attn", "wqkv"), P("data", "model", None)),
    (("self_attn", "wo"), P("model", None, "data")),
    (("cross_attn", "wqkv"), P("data", "model", None)),
    (("cross_attn", "wo"), P("model", None, "data")),
    # dense MLPs: fused gate+up (d, 2, f)
    (("mlp", "w_gu"), P("data", None, "model")),
    (("mlp", "w_down"), P("model", "data")),
    (("shared", "w_gu"), P("data", None, "model")),
    (("shared", "w_down"), P("model", "data")),
    # MoE experts: EP on model, f on data (FSDP), the contraction dim d
    # replicated so the gate/up products are local
    (("moe", "router"), P(None, None)),
    (("moe", "w_gate"), P("model", None, "data")),
    (("moe", "w_up"), P("model", None, "data")),
    (("moe", "w_down"), P("model", "data", None)),
    # mamba2
    (("in_proj",), P("data", "model")),
    (("out_proj",), P("model", "data")),
    (("conv_w",), P(None, "model")),
    (("conv_b",), P("model")),
    (("A_log",), P(None)),
    (("D",), P(None)),
    (("dt_bias",), P(None)),
    # norms / small
    (("scale",), P(None)),
]


def _match_rule(path_keys) -> Optional[tuple]:
    for suffix, spec in _RULES:
        if len(path_keys) >= len(suffix) and tuple(path_keys[-len(suffix):]) == suffix:
            return spec
    return None


def _walk(tree: Any, fn, path=()):
    """``fn(path names, leaf)`` over a nested dict / tuple / list tree, the
    containers kept.  A dict key with dots (a state dict key) is split into
    its names; sequence positions add no name (the reference's
    ``SequenceKey``)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + tuple(str(k).split("."))) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, fn, path) for v in tree)
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in getattr(leaf, "shape", np.shape(leaf)))


def param_pspecs(params: Any, mesh=None) -> Any:
    """The spec tree of a parameter tree (a port state dict, or the
    reference's nested layout with its stack axes ``None``).

    When a mesh is given, every axis assignment whose dim is not divisible
    by that mesh axis is dropped (replicated along that dim), the
    reference's guard: its pjit input shardings need exact divisibility.
    """

    def leaf_spec(names, leaf):
        shape = _shape(leaf)
        rank = len(shape)
        rule = _match_rule(names)
        if rule is None or rank < len(rule):
            return P(*([None] * rank))
        full = [None] * (rank - len(rule)) + list(rule)
        if mesh is not None:
            for i, ax in enumerate(full):
                size = int(np.prod([_axis_size(mesh, a) for a in _names(ax)]))
                if ax is not None and shape[i] % size != 0:
                    full[i] = None
        return P(*full)

    return _walk(params, leaf_spec)


# ---------------------------------------------------------------------------
# cache + batch rules


def _maybe(dp_axes, dim: int, dp_size: int):
    if not dp_axes or dim % dp_size != 0:
        return None
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def cache_pspecs(cache: Any, mesh) -> Any:
    """KV caches: heads on "model" when divisible, else head_dim, else
    replicated; batch on the DP axes when divisible; SSM states on "model"
    heads.  The port's Python-int ``pos`` is a rank-0 leaf (``()``)."""
    dp = _dp_axes(mesh)
    dp_size = int(np.prod([_axis_size(mesh, a) for a in dp])) if dp else 1
    model_size = _axis_size(mesh, "model")

    def leaf_spec(names, leaf):
        shape = _shape(leaf)
        rank = len(shape)
        if rank == 0 or (names and names[-1] == "pos"):
            return P(*([None] * rank))
        spec = [None] * rank
        last = names[-1] if names else None

        def kv(b_i, h_i, hd_i):
            spec[b_i] = _maybe(dp, shape[b_i], dp_size)
            if shape[h_i] % model_size == 0:
                spec[h_i] = "model"
            elif shape[hd_i] % model_size == 0:
                spec[hd_i] = "model"

        if last in ("k", "v") and rank >= 4:
            # (layers?, b, hkv, S, hd)
            kv(rank - 4, rank - 3, rank - 1)
        elif last == "state" and rank >= 4:
            # (layers?, b, h, p, n)
            b_i, h_i = rank - 4, rank - 3
            spec[b_i] = _maybe(dp, shape[b_i], dp_size)
            if shape[h_i] % model_size == 0:
                spec[h_i] = "model"
        elif last == "conv" and rank >= 3:
            # (layers?, b, k-1, conv_dim)
            b_i, c_i = rank - 3, rank - 1
            spec[b_i] = _maybe(dp, shape[b_i], dp_size)
            if shape[c_i] % model_size == 0:
                spec[c_i] = "model"
        elif rank >= 4:
            # whisper's cross (k, v) tuple leaves: (layers, b, hkv, S, hd)
            kv(rank - 4, rank - 3, rank - 1)
        return P(*spec)

    return _walk(cache, leaf_spec)


def batch_pspec(batch: Any, mesh) -> Any:
    """Shard the batch dim over the DP axes: the longest prefix of
    ("pod", "data") whose product divides it (greedy), else replicated."""
    dp = _dp_axes(mesh)

    def leaf_spec(_names, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        b = shape[0]
        chosen, prod = (), 1
        for a in dp:
            if b % (prod * _axis_size(mesh, a)) == 0:
                chosen = chosen + (a,)
                prod *= _axis_size(mesh, a)
        spec = [None] * len(shape)
        if chosen:
            spec[0] = chosen if len(chosen) > 1 else chosen[0]
        return P(*spec)

    return _walk(batch, leaf_spec)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh``'s dims, in mesh
    order: ``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
    ``Replicate()`` on the others.  A dim split by several axes (the
    batch's ``("pod", "data")``) is split major to minor in mesh order, as
    the reference's tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {a: d for d, entry in enumerate(spec) for a in _names(entry)}
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate() for a in mesh_sizes(mesh))


def to_shardings(pspecs: Any, mesh) -> Any:
    """Every spec of a spec tree as its placements (:func:`placements`)."""
    if isinstance(pspecs, PartitionSpec):
        return placements(pspecs, mesh)
    if isinstance(pspecs, dict):
        return {k: to_shardings(v, mesh) for k, v in pspecs.items()}
    if isinstance(pspecs, (list, tuple)):
        return type(pspecs)(to_shardings(v, mesh) for v in pspecs)
    raise TypeError(f"not a spec tree: {pspecs!r}")
