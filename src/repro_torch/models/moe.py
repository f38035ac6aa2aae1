"""Mixture-of-Experts FFN with capacity-based dispatch.

Top-k routing -> stable sort by expert -> capacity-bounded scatter into a
dense (experts, capacity, d) buffer -> batched per-expert SwiGLU products ->
weighted scatter back to the tokens, as the reference's
``repro/models/moe.py``.  Tokens routed beyond an expert's capacity are
dropped for that expert (their other top-k choices and the residual still
carry them), and the router's softmax weights are renormalised over the
surviving choices.

The reference scatters with ``.at[...].add(mode="drop")``: a dropped pair
gets an out-of-range slot and vanishes.  Here every scatter target has one
spare row (and column) past its end; dropped pairs land there and the spare
is sliced off, so no index is ever wrapped or clipped onto a real slot.
Every kept pair owns its slot, so the dispatch buffer and the per-slot
weights are written by a plain scatter: the values of the reference's add
onto zeros (the dropped pairs all write zero into the spare).  Only the
combine, where a token's kept pairs meet, accumulates, and it does so
token-side: each (token, choice) pair gathers its slot's weighted row (a
dropped pair a zero row) and a token's ``top_k`` rows are summed, as are
its router weights for the renormalisation.  Gathers and sums add in a
fixed order on the card, where a scatter-add (``index_add``) adds float32
in the order its atomics land; so a forward, its gradients and a resumed
training run repeat bitwise.
The expert products are ``einsum``s, as in the reference (no kernel there
either).

Over a mesh whose "data" axis splits the batch the layer sees only its
rank's tokens, where the reference's ``moe_apply`` under
GSPMD sees the global token count.  The capacity and each pair's slot are
global there: ``C = capacity_of(T_global, ...)``, and a pair's position in
its expert is its rank in a stable sort over the global (token, choice)
order.  Batch rows are split across ranks in rank-major blocks, so inside
:func:`token_split` a rank's positions are its local ones plus, per expert,
the pairs routed there by the ranks below it (an all-gather of one count an
expert), and every rank drops exactly the pairs the global dispatch drops.
The reference's expert-parallel layout hints (``mesh_axes``) carry no
arithmetic and are accepted as such.  Expert parallelism comes from the
tensor-parallel context (:mod:`repro_torch.sharding.tp`) the mesh layer
sets: the expert weights are then this model rank's ``E_pad / tp``
experts, the router stays replicated and every model rank routes the same
tokens (the capacity and drops of the global batch, as above), the
renormalised weights and the tokens enter through ``copy_to_model``, each
rank fills and runs only its own experts' slots, and the weighted combine
(its experts' rows of each token, zeros for the others) is summed over
"model" in float32; a shared expert is column- then row-parallel.

Routing ties: ``torch.topk`` and ``jax.lax.top_k`` may order equal router
logits differently; on inputs without ties the two route alike.  The
renormalisation and the combine sum a token's pairs in choice order, the
reference's scatter-add in its own: equal within rounding, not bitwise.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import SwiGLU, parallel_mlp, dense_init, normal, swiglu
from repro_torch.sharding import tp


def _expert_init(gen: torch.Generator, e: int, d_in: int, d_out: int, dtype) -> torch.Tensor:
    return normal(gen, (e, d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int, shared_expert: bool, dtype,
             n_experts_padded: int | None = None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree, on the generator's device: a float32
    ``router (d, n_experts)``, expert weights ``w_gate``/``w_up (E_pad, d,
    f)`` and ``w_down (E_pad, f, d)`` in ``dtype``, and with
    ``shared_expert`` a SwiGLU ``shared {"w_gu", "w_down"}``."""
    e_pad = n_experts_padded or n_experts
    p = {
        "router": dense_init(gen, d, n_experts, torch.float32),  # router kept float32
        "w_gate": _expert_init(gen, e_pad, d, f, dtype),
        "w_up": _expert_init(gen, e_pad, d, f, dtype),
        "w_down": _expert_init(gen, e_pad, f, d, dtype),
    }
    if shared_expert:  # the reference's swiglu_init
        p["shared"] = {"w_gu": normal(gen, (d, 2, f), 1.0 / math.sqrt(d), dtype),
                       "w_down": dense_init(gen, f, d, dtype)}
    return p


class MoE(nn.Module):
    """The parameters of :func:`moe_init` as an ``nn.Module`` (state dict
    keys ``router``, ``w_gate``, ``w_up``, ``w_down``, ``shared.w_gu``,
    ``shared.w_down``)."""

    def __init__(self, d: int, f: int, n_experts: int, shared_expert: bool, dtype,
                 n_experts_padded: int | None = None, device=None):
        super().__init__()
        e_pad = n_experts_padded or n_experts
        self.router = nn.Parameter(torch.empty((d, n_experts), dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty((e_pad, d, f), dtype=dtype, device=device))
        self.w_up = nn.Parameter(torch.empty((e_pad, d, f), dtype=dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((e_pad, f, d), dtype=dtype, device=device))
        if shared_expert:
            self.shared = SwiGLU(d, f, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        d, n_experts = self.router.shape
        e_pad, _, f = self.w_gate.shape
        p = moe_init(gen, d, f, n_experts, hasattr(self, "shared"), self.w_gate.dtype, e_pad)
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(self, name).copy_(p[name])
        if hasattr(self, "shared"):
            self.shared.w_gu.copy_(p["shared"]["w_gu"])
            self.shared.w_down.copy_(p["shared"]["w_down"])

    def params(self) -> Dict:
        p = {k: v for k, v in self.named_parameters(recurse=False)}
        if hasattr(self, "shared"):
            p["shared"] = {"w_gu": self.shared.w_gu, "w_down": self.shared.w_down}
        return p


def capacity_of(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, ((cap + 7) // 8) * 8)  # a multiple of 8, as the reference's


@dataclasses.dataclass(frozen=True)
class Routing:
    """The dispatch of ``T * top_k`` (token, choice) pairs, sorted stably by
    expert: pair ``i`` is token ``sorted_t[i]`` with router weight
    ``sorted_w[i]``; it is kept when ``keep[i]``, in slot ``(slot_e[i],
    slot_c[i])`` of the ``(E_pad, C)`` buffer, and a dropped pair's slot is
    the spare ``(E_pad, C)``.  ``tok_slot (E_pad, C)`` is the token in each
    slot, ``T`` for an empty one; ``pair_of (T, top_k)`` is the sorted
    position of each token's choices, in choice order."""

    capacity: int
    sorted_t: torch.Tensor
    sorted_w: torch.Tensor
    keep: torch.Tensor
    slot_e: torch.Tensor
    slot_c: torch.Tensor
    tok_slot: torch.Tensor
    pair_of: torch.Tensor


#: the token split in force (:func:`token_split`): ``(group, ranks, rank)``
_SPLIT: contextvars.ContextVar = contextvars.ContextVar("token_split", default=(None, 1, 0))


@contextlib.contextmanager
def token_split(group, n_ranks: int, rank: int):
    """Route as one slice of a batch split over ``n_ranks`` ranks of
    ``group`` in rank-major blocks of equal size (every rank of the group
    routes the same layers in the same order): the capacity of the global
    token count, and global positions in each expert (module docstring).
    One rank is the unsplit routing."""
    token = _SPLIT.set((group, int(n_ranks), int(rank)))
    try:
        yield
    finally:
        _SPLIT.reset(token)


def _ranks_below(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Per expert, the pairs the ranks below this one route there."""
    import torch.distributed as dist

    group, n, rank = _SPLIT.get()
    counts = torch.bincount(flat_e, minlength=n_experts)
    parts = [torch.empty_like(counts) for _ in range(n)]
    dist.all_gather(parts, counts, group=group)
    below = torch.zeros_like(counts)
    for r in range(rank):
        below += parts[r]
    return below


def route(router: torch.Tensor, tokens: torch.Tensor, *, top_k: int, capacity_factor: float,
          e_pad: int) -> Routing:
    """Top-k routing of ``tokens (T, d)`` and the capacity-bounded slots
    (global ones inside :func:`token_split`)."""
    T = tokens.shape[0]
    n_experts = router.shape[1]  # routable (un-padded) experts
    split = _SPLIT.get()[1]
    C = capacity_of(T * split, top_k, n_experts, capacity_factor)
    dev = tokens.device
    logits = tokens.to(torch.float32) @ router  # (T, E)
    top_w, top_i = torch.topk(logits, top_k, dim=-1)  # (T, k), descending as lax.top_k
    top_w = torch.softmax(top_w, dim=-1)

    # flatten (token, choice) pairs and rank them within each expert
    flat_e = top_i.reshape(-1)
    flat_w = top_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e, sorted_t, sorted_w = flat_e[order], flat_t[order], flat_w[order]
    seg_starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=dev), side="left")
    pos_in_e = torch.arange(T * top_k, device=dev) - seg_starts[sorted_e]
    if split > 1:
        pos_in_e = pos_in_e + _ranks_below(flat_e, n_experts)[sorted_e]
    keep = pos_in_e < C
    slot_e = torch.where(keep, sorted_e, e_pad)
    slot_c = torch.where(keep, pos_in_e, C)
    tok_slot = torch.full((e_pad + 1, C + 1), T, dtype=torch.int64, device=dev)
    tok_slot = tok_slot.index_put((slot_e, slot_c), torch.where(keep, sorted_t, T))[:e_pad, :C]
    pair_of = torch.empty_like(order).index_put((order,), torch.arange(T * top_k, device=dev)).reshape(T, top_k)
    return Routing(C, sorted_t, sorted_w, keep, slot_e, slot_c, tok_slot, pair_of)


def moe_apply(params: Mapping, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              mesh_axes: tuple = ()) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d).  ``mesh_axes``: the reference's layout
    hints; the tensor-parallel context decides expert parallelism (module
    docstring)."""
    del mesh_axes
    b, s, d = x.shape
    ctx = tp.active()
    ep = ctx is not None and ctx.experts
    e_local = params["w_gate"].shape[0]  # this rank's experts (all of them without EP)
    e_pad = e_local * ctx.size if ep else e_local
    tokens = x.reshape(-1, d)
    r = route(params["router"], tokens, top_k=top_k, capacity_factor=capacity_factor, e_pad=e_pad)
    C, keep = r.capacity, r.keep
    # per-pair renormalised weights: a token's kept weights summed over its choices
    w_kept = torch.where(keep, r.sorted_w, 0.0)
    denom = torch.sum(w_kept[r.pair_of], dim=1)
    w_norm = w_kept / torch.clamp(denom[r.sorted_t], min=1e-9)
    if ep:
        lo = ctx.rank * e_local
        mine = keep & (r.slot_e >= lo) & (r.slot_e < lo + e_local)
        slots = (torch.where(mine, r.slot_e - lo, e_local), torch.where(mine, r.slot_c, C))
        inputs, w_norm = tp.copy_to_model(tokens), tp.copy_to_model(w_norm)
    else:
        mine, slots, inputs = keep, (r.slot_e, r.slot_c), tokens

    # dispatch: (E, C, d) buffer (+ the spare row and column); dropped pairs
    # (and under EP other ranks' pairs) write zeros
    payload = torch.where(mine[:, None], inputs[r.sorted_t], 0.0).to(x.dtype)
    buf = torch.zeros((e_local + 1, C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put(slots, payload)[:e_local, :C]
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, params["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    eout = torch.einsum("ecf,efd->ecd", g * u, params["w_down"])  # (E, C, d)

    # combine: every slot's row weighted, then each token's choices
    # gathered from their slots (a dropped pair from the zero row past the
    # last slot) and summed
    w_slot = torch.zeros((e_local + 1, C + 1), dtype=torch.float32, device=x.device)
    w_slot = w_slot.index_put(slots, torch.where(mine, w_norm, 0.0))[:e_local, :C]
    contrib = eout * w_slot[..., None].to(eout.dtype)  # (E, C, d)
    rows = torch.cat([contrib.reshape(-1, d).to(torch.float32), contrib.new_zeros((1, d), dtype=torch.float32)])
    slot_row = torch.where(mine, slots[0] * C + slots[1], e_local * C)
    out = torch.sum(rows[slot_row[r.pair_of]], dim=1)  # (T, d) float32
    out = (tp.reduce_from_model(out) if ep else out).to(x.dtype)

    if "shared" in params:
        out = out + parallel_mlp(swiglu, params["shared"]["w_gu"], params["shared"]["w_down"], tokens)
    return out.reshape(b, s, d)


def moe_ref(params: Mapping, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Dense oracle (no capacity drops): every token through its top-k
    experts.  O(E) work: tests and tiny configs only."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    logits = tokens.to(torch.float32) @ params["router"]
    top_w, top_i = torch.topk(logits, top_k, dim=-1)
    top_w = torch.softmax(top_w, dim=-1)
    g = F.silu(torch.einsum("td,edf->tef", tokens, params["w_gate"]))
    u = torch.einsum("td,edf->tef", tokens, params["w_up"])
    all_out = torch.einsum("tef,efd->ted", g * u, params["w_down"])  # (T, E, d)
    sel = torch.take_along_dim(all_out, top_i[:, :, None], dim=1)  # (T, k, d)
    out = torch.sum(sel * top_w[:, :, None].to(x.dtype), dim=1)
    if "shared" in params:
        out = out + swiglu(params["shared"]["w_gu"], params["shared"]["w_down"], tokens)
    return out.reshape(b, s, d)
