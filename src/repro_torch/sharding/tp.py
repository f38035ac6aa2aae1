"""Tensor and expert parallelism over a mesh's "model" axis, written out.

The reference gets tensor parallelism from GSPMD: its partition rules put
attention heads, the MLP hidden dim, the vocab and the MoE expert axis on
"model", and XLA inserts the collectives.  The port writes them out, as
Megatron-LM does, with two operators over the "model" group:

* :func:`copy_to_model`: the identity forward, an all-reduce of the
  gradient backward (a replicated activation entering a split region);
* :func:`reduce_from_model`: an all-reduce forward (the partial sums of a
  row-parallel product), the identity backward.

Between split regions every activation is replicated over "model" and so is
its gradient, so a parameter the whole region reads outside them (a norm,
the router) gets the same gradient on every model rank.  The vocab pieces
keep the logits split: :func:`vocab_embed` looks up the rank's rows and
sums, :func:`vocab_cross_entropy` all-reduces the max and the sum of
exponentials and takes the gold logit from the rank that holds it, and the
float32 ``(b, s, V)`` logits are never gathered.

A :class:`TPContext` (set by the mesh layer, :func:`context`) says which of
a config's splits this mesh allows: heads (``n_heads`` and ``n_kv_heads``
both divisible, so GQA groups stay whole), the MLP hidden dim, the padded
experts, the padded vocab.  The models read it through :func:`active`;
without a context, or at a model size of 1, every operator here is the
identity with no copy and no collective, and the models run their
one-device code.  :func:`compute_index` says which part of a parameter a
model rank's compute reads (``sharding/fsdp.py`` gathers it and takes that
part).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The "model" group (``group`` of ``size`` ranks, this one at
    ``rank``) and which of the config's axes it splits."""

    group: Any
    size: int
    rank: int
    heads: bool = False
    mlp: bool = False
    experts: bool = False
    vocab: bool = False

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` (divisible) entries."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def plan(cfg, group, size: int, rank: int) -> TPContext:
    """The splits of ``cfg`` over a "model" group of ``size`` ranks."""

    def splits(n: int) -> bool:
        return size > 1 and n > 0 and n % size == 0

    return TPContext(group, size, rank,
                     heads=splits(cfg.n_heads) and splits(cfg.n_kv_heads),
                     mlp=splits(cfg.d_ff),
                     experts=splits(cfg.n_experts_padded),
                     vocab=splits(cfg.vocab_padded))


_CTX: contextvars.ContextVar = contextvars.ContextVar("tp_context", default=None)


@contextlib.contextmanager
def context(ctx: Optional[TPContext]):
    """Run the models under ``ctx`` (``None``: no tensor parallelism)."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def active() -> Optional[TPContext]:
    """The context in force when its model size is above 1, else ``None``."""
    ctx = _CTX.get()
    return ctx if ctx is not None and ctx.size > 1 else None


# ---------------------------------------------------------------------------
# the two operators


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, gradient all-reduced over "model" backward."""
    ctx = active()
    return x if ctx is None else _CopyToModel.apply(x, ctx.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Partial sums all-reduced over "model" forward, identity backward."""
    ctx = active()
    return x if ctx is None else _ReduceFromModel.apply(x, ctx.group)


# ---------------------------------------------------------------------------
# vocab-parallel embedding and cross-entropy


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` of a vocab-split table (this rank's rows): each rank
    looks up the ids it holds, zeros elsewhere, and the ranks' rows are
    summed (one nonzero term a token: the one-device values exactly)."""
    ctx = active()
    rows = table.shape[0]
    ids = tokens - ctx.rank * rows
    inside = (ids >= 0) & (ids < rows)
    got = table[ids.clamp(0, rows - 1)]
    return reduce_from_model(torch.where(inside[..., None], got, torch.zeros_like(got)))


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean token cross-entropy, in float32, of vocab-split logits
    (``(..., V / tp)``: this rank's block of the vocab) and labels: the max
    and the sum of exponentials all-reduced over "model", the gold logit from
    the rank that holds it."""
    ctx = active()
    logits = logits.to(torch.float32)
    width = logits.shape[-1]
    top = _all_reduce(torch.amax(logits.detach(), dim=-1), ctx.group, dist.ReduceOp.MAX)
    total = reduce_from_model(torch.sum(torch.exp(logits - top[..., None]), dim=-1))
    ids = labels.to(torch.int64) - ctx.rank * width
    inside = (ids >= 0) & (ids < width)
    gold = torch.gather(logits, -1, ids.clamp(0, width - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, gold, torch.zeros_like(gold)))
    return torch.mean(torch.log(total) + top - gold)


# ---------------------------------------------------------------------------
# tensors split on "model" that a replicated compute reads whole


def gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a tensor split on ``dim`` over "model" (no gradient)."""
    ctx = active()
    parts = [torch.empty_like(t) for _ in range(ctx.size)]
    dist.all_gather(parts, t.contiguous(), group=ctx.group)
    return torch.cat(parts, dim=dim)


def whole(t: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """``t`` whole along ``dim``: gathered over "model" when it holds only
    this rank's block of ``full`` entries there (a cache leaf as
    ``cache_pspecs`` places it)."""
    if t.shape[dim] == full or active() is None:
        return t
    return gather_model(t, dim)


def own_block(t: torch.Tensor, dim: int, local: int) -> torch.Tensor:
    """This rank's block of ``local`` entries of a whole ``t`` along ``dim``
    (``t`` itself when it is no wider)."""
    ctx = active()
    if ctx is None or t.shape[dim] == local:
        return t
    return t.narrow(dim, ctx.rank * local, local)


def to_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` cut, dim by dim, to this rank's block of the shape of ``like``."""
    for dim, n in enumerate(like.shape):
        t = own_block(t, dim, n)
    return t.contiguous()


_NOTED = set()


def note_replicated(what: str, n_heads: int, n_kv_heads: int) -> None:
    """Log, once per configuration, that an attention runs whole on every
    model rank (its heads do not split: the reference's "replicate the
    head axis" branch)."""
    ctx = active()
    key = (what, n_heads, n_kv_heads, ctx.size)
    if key not in _NOTED:
        _NOTED.add(key)
        log.warning("%s: %d query and %d kv heads do not split over a 'model' axis of %d: every model rank "
                    "computes the attention whole from gathered weights", what, n_heads, n_kv_heads, ctx.size)


# ---------------------------------------------------------------------------
# which part of a parameter a model rank's compute reads


def _tail(name: str, n: int) -> Tuple[str, ...]:
    return tuple(name.split("."))[-n:]


def compute_index(name: str, shape: Sequence[int], cfg, ctx: TPContext) -> Optional[Tuple[int, torch.Tensor]]:
    """``(dim, indices)`` of the part of parameter ``name`` (whole shape
    ``shape``) that model rank ``ctx.rank``'s compute reads, or ``None`` when
    its compute reads the whole tensor (replicated compute).

    - attention ``wqkv (d, hq + 2 hkv, hd)`` / ``bqkv (hq + 2 hkv, hd)``, when
      the heads split: the rank's q heads, then its k and v heads (the fused
      axis is [q | k | v], so these are three runs, not one block);
      ``wo (hq, hd, d)``: its q heads;
    - dense and shared MLPs: ``w_gu (d, 2, f)`` / ``w_up (d, f)`` its f
      columns, ``w_down (f, d)`` its f rows;
    - MoE experts ``w_gate``/``w_up``/``w_down (E_pad, ...)``: its experts;
    - ``embed (V_pad, d)`` its vocab rows, ``lm_head (d, V_pad)`` its vocab
      columns.

    Everything else (norms, the router, Mamba2, zamba2's ``in_proj``, the
    vlm projector) is computed whole on every model rank."""
    if ctx.size == 1:
        return None

    def block(dim):
        b = ctx.block(shape[dim])
        return dim, torch.arange(b.start, b.stop)

    last = _tail(name, 1)[0]
    pair = _tail(name, 2)
    attn = len(pair) == 2 and pair[0] in ("attn", "self_attn", "cross_attn")
    if attn and last in ("wqkv", "bqkv"):
        if not ctx.heads:
            return None
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        q, kv = ctx.block(hq), ctx.block(hkv)
        idx = torch.cat([torch.arange(q.start, q.stop), hq + torch.arange(kv.start, kv.stop),
                         hq + hkv + torch.arange(kv.start, kv.stop)])
        return (1 if last == "wqkv" else 0), idx
    if attn and last == "wo":
        return block(0) if ctx.heads else None
    if pair in (("mlp", "w_gu"), ("shared", "w_gu")):
        return block(2) if ctx.mlp else None
    if pair == ("mlp", "w_up"):
        return block(1) if ctx.mlp else None
    if pair in (("mlp", "w_down"), ("shared", "w_down")):
        return block(0) if ctx.mlp else None
    if pair in (("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down")):
        return block(0) if ctx.experts else None
    if name == "embed":
        return block(0) if ctx.vocab else None
    if name == "lm_head":
        return block(1) if ctx.vocab else None
    return None
