"""Nested containers of tensors, flattened in ``jax.tree.flatten``'s leaf order.

The reference keeps parameters, gradients, optimizer state and checkpoints
as JAX pytrees and walks them with ``jax.tree``; the port keeps the same
nested dicts, tuples and lists of tensors.  ``flatten`` orders the leaves as
JAX does (dict keys sorted, sequences in order, ``None`` an empty subtree),
so a checkpoint's ``<i>.bin`` index names the same leaf in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = "*"


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the containers in
    :func:`unflatten`."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (tuple, list)):
            return (type(node).__name__, None, [walk(v) for v in node])
        if node is None:
            return ("none", None, [])
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        kind, keys, children = d
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        out = [build(c) for c in children]
        return tuple(out) if kind == "tuple" else out

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def map_leaves(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf (``jax.tree.map`` over one tree)."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])


def treedef_str(treedef: Any) -> str:
    """A readable rendering in the style of JAX's ``PyTreeDef(...)`` string
    (written to a checkpoint's manifest, never read back)."""

    def render(d):
        if d == _LEAF:
            return "*"
        kind, keys, children = d
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {render(c)}" for k, c in zip(keys, children)) + "}"
        inner = ", ".join(render(c) for c in children)
        if kind == "tuple":
            return "(" + inner + ("," if len(children) == 1 else "") + ")"
        return "[" + inner + "]"

    return f"PyTreeDef({render(treedef)})"
