"""AdamW with decoupled weight decay; float32 moments whatever the parameter dtype.

``init`` and ``update`` are plain functions of trees of tensors (a name ->
tensor mapping, or the reference's nested parameter tree; see
:mod:`repro_torch.tree`), in the reference's order of float32 operations:
global-norm clip, bias correction, the clamp of ``v`` at zero.

Moment tensors take the parameters' specs (``state_pspecs``), so over a
mesh each rank updates its own (data, model) blocks of the parameters,
gradients and moments; the one number that spans ranks is the global
norm, whose per-leaf squared sums ``update`` hands to ``norm_terms`` (the
mesh step's sums each leaf's blocks across the data and model ranks,
every element once) before adding them in leaf order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import tree


def _f32(v: float, device) -> torch.Tensor:
    """A Python float as a float32 tensor, as JAX rounds a weak scalar."""
    return torch.tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params: Any) -> Any:
        flat = tree.leaves(params)
        device = flat[0].device if flat else None
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {
            "m": tree.map_leaves(zeros, params),
            "v": tree.map_leaves(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _schedule(self, step: torch.Tensor) -> torch.Tensor:
        # float32 throughout, dividing by a tensor (on the card a host scalar
        # divisor becomes a reciprocal multiply)
        frac = (step + 1).to(torch.float32) / _f32(max(self.warmup_steps, 1), step.device)
        return _f32(self.lr, step.device) * torch.clamp_max(frac, 1.0)

    @torch.no_grad()
    def update(self, grads: Any, state: Any, params: Any, norm_terms=None) -> Tuple[Any, Any]:
        """One step.  ``norm_terms`` (optional) maps the leaves' squared
        sums, in leaf order, to the global ones (over a mesh: a shard's
        partial sums added across the ranks)."""
        step = state["step"] + 1
        dev = step.device
        lr = self._schedule(step)

        # global-norm clip (float32)
        terms = [torch.sum(torch.square(g.to(torch.float32))) for g in tree.leaves(grads)]
        if norm_terms is not None:
            terms = norm_terms(terms)
        gsq = sum(terms)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp_max(_f32(self.grad_clip, dev) / torch.clamp_min(gnorm, 1e-12), 1.0)

        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(_f32(b1, dev), stepf)
        bc2 = 1.0 - torch.pow(_f32(b2, dev), stepf)

        def upd(p, g, m, v):
            g32 = g.to(torch.float32) * scale
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            mh = m_new / bc1
            # clamp: lossily restored (FFCz checkpoint codec) moments can be
            # epsilon-negative; sqrt would NaN the whole update
            vh = torch.clamp_min(v_new / bc2, 0.0)
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p.to(torch.float32)
            p_new = p.to(torch.float32) - lr * delta
            return p_new.to(p.dtype), m_new, v_new

        flat_p, treedef = tree.flatten(params)
        flat_g, flat_m, flat_v = tree.leaves(grads), tree.leaves(state["m"]), tree.leaves(state["v"])
        if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
            raise ValueError("params, grads and moments differ in their number of leaves")
        out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
        new_p = tree.unflatten(treedef, [o[0] for o in out])
        new_m = tree.unflatten(treedef, [o[1] for o in out])
        new_v = tree.unflatten(treedef, [o[2] for o in out])
        return new_p, {"m": new_m, "v": new_v, "step": step}

    def state_pspecs(self, param_pspecs: Any) -> Any:
        """The specs of :meth:`init`'s state: the moments take the
        parameters' specs, ``step`` is replicated."""
        from repro_torch.sharding.rules import P

        return {"m": param_pspecs, "v": param_pspecs, "step": P()}
