"""Fully sharded data parallelism over "data", tensor and expert
parallelism over "model".

The reference trains under GSPMD: its partition rules
(:mod:`repro_torch.sharding.rules`) place every large weight's FSDP dim on
"data" and its head, hidden, vocab or expert dim on "model", and XLA
all-gathers the parameters forward, reduce-scatters the gradients backward
and inserts the tensor-parallel collectives.  The port does the same by
hand, in the open:

* **State.**  Each rank holds its (data, model) block of every parameter,
  gradient and AdamW moment, exactly as the rules' spec gives it (the
  divisibility guard makes every split even; a tensor may be split on two
  dims), whole where the rule replicates it (norms, ``A_log``, ``D``,
  ``dt_bias``, the router, the projector).  The ranks that hold distinct
  blocks are one pod's (data, model) ranks (:class:`MeshLayout`).
* **Compute over "model".**  :mod:`repro_torch.sharding.tp` runs each
  model rank on its heads, MLP hidden columns, experts and vocab block
  (Megatron's operators).  Each parameter's :class:`Use` says what a
  rank's compute reads: its block gathered over "data" where the stored
  "model" split is the compute's (``wo``, the MLPs, the experts, ``embed``,
  ``lm_head``); else the tensor gathered over "model" too and the rank's
  part taken (``wqkv``/``bqkv`` on the head-split route, whose stored
  split runs over the fused ``[q | k | v]`` axis, not over q, k and v
  heads; whisper's unsplit ``mlp.w_up``), or read whole (every Mamba2
  tensor and zamba2's ``in_proj``: the rules split ``in_proj`` on its
  fused ``[z | x | B | C | dt]`` columns and ``conv_w``/``conv_b``/
  ``out_proj`` on ``conv_dim``/``d_inner``, which do not fall on SSD heads,
  so every model rank computes the block whole, replicated compute with
  sharded storage; ``wqkv``/``bqkv``/``wo`` on the replicated-attention
  route).  The gradient is that gather's transpose: where each model rank
  used only its own part it is summed over "model" (reduce-scattered); where
  every model rank computed the whole, each holds the same full gradient
  and keeps its block with no sum (a sum would count it ``n_model``
  times).  A parameter replicated over "model" gets the same gradient on
  every model rank (the activations entering a split region do so through
  ``copy_to_model``) and is not summed over "model".
* **Forward.**  :class:`MeshTrainStep` runs the model as a list of
  segments (:func:`train_segments`: the embedding, each layer or layer
  group, the head), gathering one segment's parameters just before it runs
  and dropping them after, under ``torch.no_grad``; it keeps each
  segment's inputs (the residual stream between blocks, replicated over
  "model").
* **Backward.**  Segments in reverse: gather the segment's parameters
  again, recompute it under autograd (and under the tensor-parallel
  context) from its kept inputs, and take ``torch.autograd.grad`` of its
  outputs against the gradients arriving from the segments after it.
  ``autograd.grad`` fills no ``.grad`` and no hook runs, so the reduction is
  explicit: a parameter's gradient is summed over every segment that reads
  it (zamba2's shared block in every group, a tied embedding in the
  embedding and the head), cut to the rank's "model" block as its
  :class:`Use` says, then reduce-scattered over the ranks that split the
  batch (the batch's data ranks only) to this rank's block (the mean of the
  ranks' gradients of their own mean losses; every rank holds as many
  tokens, so this is the gradient of the global mean).  Where the batch does
  not divide, every rank computes the whole batch and nothing is reduced
  over "data".  Only one segment's parameters and gradients are ever whole
  on a rank.
* **Routing.**  MoE layers run inside :func:`repro_torch.models.moe.
  token_split` when the batch is split, so their capacity and drops are the
  global batch's, as under GSPMD; every model rank routes the same tokens.

At one rank every gather and reduction is the identity, each segment's
backward is the one-device autograd graph's for that block, and the step
gives the one-device step's loss and parameters; at a model size of 1 the
tensor-parallel operators are the identity.

:func:`init_shards` draws the one-device initialization (the same
generator stream) and keeps each rank's block, one tensor at a time;
:class:`MeshServe` runs prefill and decode steps with each layer's
parameters gathered by a forward hook around that layer's call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.overrides import TorchFunctionMode

from repro_torch.configs import ArchConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import RMSNorm
from repro_torch.models.model import (
    build_model,
    cross_kv_from_encoder,
    encoder_input,
    head_loss,
    lm_class,
    mamba_residual,
)
from repro_torch.sharding import dist_fft, tp
from repro_torch.sharding.rules import _names, batch_pspec, cache_pspecs, mesh_sizes, param_pspecs, to_shardings

def require_device_mesh(mesh, what: str = "this step"):
    """``NotImplementedError`` unless ``mesh`` is a ``torch.distributed``
    ``DeviceMesh`` (any of its "pod", "data" and "model" axes)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise NotImplementedError(
            f"{what} runs over a torch.distributed DeviceMesh, got {type(mesh).__name__}")


def _axis_dim(spec, axis: str) -> Optional[int]:
    """The tensor dim a parameter spec splits over ``axis`` (None: whole)."""
    for d, entry in enumerate(spec):
        names = _names(entry)
        if "pod" in names:
            raise NotImplementedError(f"a parameter split over 'pod' ({spec}) is not ported")
        if axis in names:
            return d
    return None


def axes_group(mesh, axes: Sequence[str]):
    """``(group, size, rank)`` of the ranks spanned by mesh ``axes``
    (``(None, 1, 0)`` for none)."""
    axes = tuple(axes)
    if not axes:
        return None, 1, 0
    if len(axes) == 1:
        return dist_fft.mesh_axis(mesh, axes[0])
    group = mesh[axes]._flatten().get_group()
    return group, dist.get_world_size(group), dist.get_rank(group)


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """How a global batch lies over the mesh: the ranks that split its rows
    (``group`` of ``size``, this rank at ``rank``, spanning mesh ``axes``);
    size 1 is replicated."""

    group: Any
    size: int
    rank: int
    axes: Tuple[str, ...] = ()

    def rows(self, n: int) -> slice:
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def routing(self):
        """The MoE routing context of this split."""
        if self.size == 1:
            return contextlib.nullcontext()
        return moe_mod.token_split(self.group, self.size, self.rank)


@dataclasses.dataclass(frozen=True)
class Use:
    """How a model rank's compute reads one parameter: ``gather_model``,
    all-gathered over "model" (beyond the data gather), then ``index``
    (``(dim, indices)``, or None) taken.  ``grad`` says how the gradient of
    the gathered tensor becomes the rank's block: ``"local"`` it is the
    block's (over "model"), ``"own"`` every model rank computed the whole
    and holds the same gradient (the rank keeps its block, no sum), ``"sum"``
    each rank's covers its own part (summed over "model": reduce-scattered
    when the tensor is split there, else all-reduced)."""

    gather_model: bool = False
    index: Optional[Tuple[int, torch.Tensor]] = None
    grad: str = "local"


class MeshLayout:
    """Where each parameter of ``cfg``'s model lies over ``mesh``.

    ``specs`` are the rules' specs of the port's state dict
    (:func:`repro_torch.sharding.rules.param_pspecs`), ``placements`` their
    DTensor placements, ``dims[name]`` the dim split over "data" and
    ``model_dims[name]`` the one split over "model" (None: whole): each rank
    holds its (data, model) block.  ``uses[name]`` (:class:`Use`) is how
    its compute reads each one under ``tp_ctx``, the mesh's
    tensor-parallel context.  ``skeleton`` is the model on the meta device:
    the step runs its modules with gathered tensors swapped in.

    The ranks that hold distinct blocks are the (data, model) ranks of one
    pod: ``group``, ``n`` and ``rank`` (data-major: rank ``d * n_model +
    m``); the data and model axes alone are ``data_group``/``n_data``/
    ``data_rank`` and ``model_group``/``n_model``/``model_rank``."""

    def __init__(self, cfg: ArchConfig, mesh):
        require_device_mesh(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.device = dist_fft.mesh_device(mesh)
        self.skeleton = lm_class(cfg)(cfg, device="meta")
        meta = self.skeleton.state_dict()
        self.shapes = {k: tuple(v.shape) for k, v in meta.items()}
        self.dtypes = {k: v.dtype for k, v in meta.items()}
        self.specs = param_pspecs(meta, mesh)
        self.placements = to_shardings(self.specs, mesh)
        self.dims = {k: _axis_dim(s, "data") for k, s in self.specs.items()}
        self.model_dims = {k: _axis_dim(s, "model") for k, s in self.specs.items()}
        self.data_group, self.n_data, self.data_rank = axes_group(mesh, ("data",) if "data" in self.sizes else ())
        self.model_group, self.n_model, self.model_rank = axes_group(mesh, ("model",) if "model" in self.sizes else ())
        if self.n_model == 1:
            self.group, self.n, self.rank = self.data_group, self.n_data, self.data_rank
        elif self.n_data == 1:
            self.group, self.n, self.rank = self.model_group, self.n_model, self.model_rank
        else:
            self.group, self.n, self.rank = axes_group(mesh, ("data", "model"))
        if self.rank != self.data_rank * self.n_model + self.model_rank:
            raise RuntimeError(f"the (data, model) group's rank {self.rank} is not data-major")
        self.tp_ctx = tp.plan(cfg, self.model_group, self.n_model, self.model_rank)
        self.uses = {k: self._use(k) for k in self.shapes}

    def _use(self, name: str) -> Use:
        md = self.model_dims[name] if self.n_model > 1 else None
        index = tp.compute_index(name, self.shapes[name], self.cfg, self.tp_ctx)
        if index is None:
            return Use(gather_model=md is not None, grad="own" if md is not None else "local")
        dim, idx = index
        block = self.tp_ctx.block(self.shapes[name][dim])
        if md == dim and torch.equal(idx, torch.arange(block.start, block.stop)):
            return Use()
        return Use(gather_model=md is not None, index=index, grad="sum")

    # -- blocks ------------------------------------------------------------

    def coords(self, holder: int) -> Dict[str, int]:
        """The (data, model) coordinates of block holder ``holder``."""
        return {"data": holder // self.n_model, "model": holder % self.n_model}

    def holder(self, coords: Dict[str, int]) -> int:
        """The block holder at (data, model) ``coords``."""
        return coords["data"] * self.n_model + coords["model"]

    def splits(self, name: str) -> List[Tuple[int, str, int]]:
        """``(dim, axis, ranks)`` of each mesh axis that splits ``name``,
        outer dim first."""
        out = [(self.dims[name], "data", self.n_data), (self.model_dims[name], "model", self.n_model)]
        return sorted((d, a, n) for d, a, n in out if d is not None and n > 1)

    def split(self, name: str) -> bool:
        """Whether ``name`` is split across the block holders."""
        return bool(self.splits(name))

    def local_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(self.shapes[name])
        for d, _a, n in self.splits(name):
            shape[d] //= n
        return tuple(shape)

    def shard(self, name: str, full: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """Holder ``rank``'s (default this rank's) block of a whole tensor,
        a fresh contiguous tensor."""
        at = self.coords(self.rank if rank is None else rank)
        for d, a, n in self.splits(name):
            c = self.shapes[name][d] // n
            full = full.narrow(d, at[a] * c, c)
        return full.clone(memory_format=torch.contiguous_format)

    def _all_gather(self, local, dim, group, n):
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The tensor this rank's compute reads ``name`` from: its block
        all-gathered over "data", and over "model" when its use says so."""
        d, md = self.dims[name], self.model_dims[name]
        if d is not None and self.n_data > 1:
            local = self._all_gather(local, d, self.data_group, self.n_data)
        if self.uses[name].gather_model:
            local = self._all_gather(local, md, self.model_group, self.n_model)
        return local

    def select(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The part of a gathered tensor that the compute reads."""
        index = self.uses[name].index
        if index is None:
            return t
        dim, idx = index
        return t.index_select(dim, idx.to(t.device))

    def compute(self, name: str, local: torch.Tensor) -> torch.Tensor:
        return self.select(name, self.gather(name, local))

    def model_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """The gradient of :meth:`gather`'s tensor cut (and summed) to this
        rank's block over "model" (still whole over "data")."""
        use, md = self.uses[name], self.model_dims[name]
        if use.grad == "local":
            return g
        if use.grad == "own":
            c = self.shapes[name][md] // self.n_model
            return g.narrow(md, self.model_rank * c, c)
        if md is None:
            g = g.contiguous()
            dist.all_reduce(g, group=self.model_group)
            return g
        front = g.movedim(md, 0).contiguous()
        out = front.new_empty((front.shape[0] // self.n_model,) + tuple(front.shape[1:]))
        dist.reduce_scatter_tensor(out, front, group=self.model_group)
        return out.movedim(0, md)

    def _data_shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        if d is None or self.n_data == 1:
            return t.contiguous()
        c = self.shapes[name][d] // self.n_data
        return t.narrow(d, self.data_rank * c, c).clone(memory_format=torch.contiguous_format)

    def reduce(self, name: str, full: torch.Tensor, split: BatchSplit) -> torch.Tensor:
        """This rank's block of the mean over the batch's ranks of a
        gradient whole over "data" (each rank's of its own mean loss; over
        "model" already this rank's block, :meth:`model_grad`).

        A parameter split over "data" is reduce-scattered there, its data
        dim moved to the front so that each rank's shard is one contiguous
        run (a transposed product's gradient is strided, and NCCL takes no
        strided tensor), then summed over the batch's other axes ("pod");
        a whole one is all-reduced.  The sum is divided by the batch's
        ranks after."""
        if split.size == 1:
            return self._data_shard(name, full)
        if self.dims[name] is None or self.n_data == 1 or "data" not in split.axes:
            full = full.contiguous()
            dist.all_reduce(full, group=split.group)
            return self._data_shard(name, full.div_(split.size))
        k = self.dims[name]
        front = full.movedim(k, 0).contiguous()
        del full
        out = front.new_empty((front.shape[0] // self.n_data,) + tuple(front.shape[1:]))
        dist.reduce_scatter_tensor(out, front, group=self.data_group)
        del front
        others = tuple(a for a in split.axes if a != "data")
        if others:
            dist.all_reduce(out, group=axes_group(self.mesh, others)[0])
        return out.div_(split.size).movedim(0, k).contiguous()

    def counted(self, name: str) -> bool:
        """Whether this rank's block of ``name`` is the one a sum over the
        holders counts (a block held by several ranks counts once)."""
        at = self.coords(self.rank)
        axes = {a for _d, a, _n in self.splits(name)}
        return all(at[a] == 0 for a in ("data", "model") if a not in axes)

    def gather_to_rank0(self, name: str, local: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole tensor on rank 0's host (``None`` elsewhere), one block
        in flight at a time: each distinct block's first holder broadcasts
        it in turn (``dist_fft.gather_to_host``'s pattern) and rank 0 copies
        it out."""
        levels = self.splits(name)
        if not levels:
            return local.detach().cpu() if self.rank == 0 else None
        blocks = {}
        for h in range(self.n):
            at = self.coords(h)
            if any(at[a] for a in ("data", "model") if a not in {a for _d, a, _n in levels}):
                continue
            buf = local.contiguous() if h == self.rank else torch.empty_like(local)
            dist.broadcast(buf, src=dist.get_global_rank(self.group, h), group=self.group)
            if self.rank == 0:
                blocks[tuple(at[a] for _d, a, _n in levels)] = buf.cpu()
            del buf
        if self.rank != 0:
            return None

        def join(level, key):
            if level == len(levels):
                return blocks[key]
            d, _a, n = levels[level]
            return torch.cat([join(level + 1, key + (i,)) for i in range(n)], dim=d)

        return join(0, ())

    def state_bytes(self, tree) -> int:
        """Bytes of the tensors of ``tree`` (a dict, nested dicts)."""
        if isinstance(tree, dict):
            return sum(self.state_bytes(v) for v in tree.values())
        return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0

    def share_bytes(self, moments: bool = True) -> int:
        """The rules' share of one rank: its parameter blocks, and with
        ``moments`` AdamW's two float32 moments of them (and its step)."""
        total = 0
        for k in self.shapes:
            n = 1
            for s in self.local_shape(k):
                n *= s
            total += n * torch.empty(0, dtype=self.dtypes[k]).element_size() + (8 * n if moments else 0)
        return total + (4 if moments else 0)

    # -- batches -----------------------------------------------------------

    def batch_split(self, rows: int) -> BatchSplit:
        """How a batch of ``rows`` rows lies: ``batch_pspec``'s axes."""
        spec = batch_pspec({"tokens": torch.empty((rows, 1), device="meta")}, self.mesh)["tokens"]
        axes = tuple(_names(spec[0]))
        return BatchSplit(*axes_group(self.mesh, axes), axes)

    def local_batch(self, batch: Dict[str, Any], split: BatchSplit) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch, on the mesh's device (tokens
        as int64, as the bundle's loss reads them)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            t = t[split.rows(t.shape[0])].to(self.device)
            out[k] = t.to(torch.int64) if k == "tokens" else t
        return out


# ---------------------------------------------------------------------------
# initialization


class _CaptureCopies(TorchFunctionMode):
    """Intercept ``Tensor.copy_`` into the skeleton's meta parameters (the
    model's ``init_`` writes each parameter so) and hand the value over."""

    def __init__(self, names: Dict[int, str], take: Callable):
        super().__init__()
        self.names, self.take = names, take

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.copy_ and id(args[0]) in self.names:
            self.take(self.names[id(args[0])], args[1])
            return args[0]
        return func(*args, **(kwargs or {}))


def init_shards(layout: MeshLayout, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """This rank's shards of the one-device initialization
    (``build_model(cfg).init(gen)`` with a generator seeded alike).

    The model's own ``init_`` runs on the meta skeleton with ``gen`` (on the
    mesh's device): each value it draws is whole for a moment, cast to the
    parameter's dtype and cut to this rank's shard.  Parameters ``init_``
    leaves at their constructor value are RMSNorm scales: ones."""
    out: Dict[str, torch.Tensor] = {}
    params = dict(layout.skeleton.named_parameters())

    def take(name, value):
        out[name] = layout.shard(name, value.to(layout.dtypes[name]))

    with _CaptureCopies({id(p): k for k, p in params.items()}, take):
        layout.skeleton.init_(gen, layout.cfg)
    owners = {f"{m}.scale" if m else "scale": mod for m, mod in layout.skeleton.named_modules()}
    for name in params:
        if name not in out:
            if not isinstance(owners.get(name), RMSNorm):
                raise RuntimeError(f"init_ left {name} unset, and it is not an RMSNorm scale")
            out[name] = torch.ones(layout.local_shape(name), dtype=layout.dtypes[name], device=layout.device)
    return {k: out[k] for k in params}


# ---------------------------------------------------------------------------
# the training step


@dataclasses.dataclass(frozen=True)
class Segment:
    """One stage of the forward: ``fn(lm, inputs, batch)`` returns the
    tensors named ``writes`` from those named ``reads``, reading the
    parameters ``params`` of the skeleton ``lm``."""

    name: str
    params: Tuple[str, ...]
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    fn: Callable


def train_segments(cfg: ArchConfig, lm: nn.Module) -> List[Segment]:
    """The scoring loss of ``cfg``'s family as segments, in forward order:
    the embedding (the vlm's projector with it), each layer or layer group
    (zamba2's groups read the shared block and the embeddings too; each
    whisper decoder layer its encoder output), the head.  The ops are the
    bundle's ``loss``'s."""
    names = list(lm.state_dict())

    def under(prefix):
        return tuple(n for n in names if n.startswith(prefix + "."))

    def stack(attr, fn, reads=("x",), writes=("x",), extra=()):
        """One segment an entry of the block list ``attr``: ``fn(i, lm,
        inputs, batch)``, reading entry ``i``'s parameters and ``extra``."""
        return [Segment(f"{attr}.{i}", under(f"{attr}.{i}") + extra, reads, writes, functools.partial(fn, i))
                for i in range(len(getattr(lm, attr)))]

    def embed(m, ins, b):
        stubs = {"patches": b["patches"]} if cfg.family == "vlm" else {}
        return (m.embed_inputs(b["tokens"], cfg, **stubs),)

    def cross(i, m, ins, b):
        block = m.decoder[i]
        return (block(ins[0], cross_kv_from_encoder(block, ins[1], cfg), cfg)[0],)

    head = Segment("head", ("ln_f.scale", "embed" if cfg.tie_embeddings else "lm_head"), ("x",), ("loss",),
                   lambda m, ins, b: (head_loss(m, ins[0], b["tokens"], cfg),))
    if cfg.family == "audio":
        return [Segment("encoder_input", (), (), ("enc",), lambda m, ins, b: (encoder_input(b["frames"], cfg),)),
                *stack("encoder", lambda i, m, ins, b: (m.encoder[i](ins[0], cfg),), ("enc",), ("enc",)),
                Segment("decoder_input", ("embed",), (), ("x",), lambda m, ins, b: (m.dec_embed(b["tokens"], 0, cfg),)),
                *stack("decoder", cross, ("x", "enc")), head]
    if cfg.family == "hybrid":
        # the embeddings are the first group's input and every group's embed0
        segs = [Segment("embed", ("embed",), (), ("x", "e0"), lambda m, ins, b: embed(m, ins, b) * 2),
                *stack("groups", lambda i, m, ins, b: (m.groups[i](ins[0], m.shared, ins[1], cfg)[0],),
                       ("x", "e0"), extra=under("shared"))]
        if hasattr(lm, "tail"):
            segs += stack("tail", lambda i, m, ins, b: (mamba_residual(m.tail[i], ins[0], cfg),))
        return segs + [head]
    blocks = {
        "moe": ("groups", lambda i, m, ins, b: (m.groups[i](ins[0], cfg)[0],)),
        "ssm": ("layers", lambda i, m, ins, b: (mamba_residual(m.layers[i], ins[0], cfg),)),
    }.get(cfg.family, ("layers", lambda i, m, ins, b: (m.layers[i](ins[0], cfg)[0],)))  # dense, vlm
    return [Segment("embed", under("projector") + ("embed",), (), ("x",), embed), *stack(*blocks), head]


def reference_leaves(cfg: ArchConfig, names: Sequence[str]) -> List[List[str]]:
    """The reference tree's leaves, in its leaf order (``tree.flatten`` of
    ``convert.lm_params_to_reference``), each as the port names stacked
    into it, in stack order: the layout the gradients are compressed in."""
    from repro_torch import tree
    from repro_torch.convert import lm_params_to_reference

    names = list(names)
    index = {k: torch.tensor([float(i)]) for i, k in enumerate(names)}
    return [[names[int(v)] for v in t.reshape(-1).tolist()]
            for t in tree.leaves(lm_params_to_reference(index, cfg))]


class _Runner(nn.Module):
    """Holds the skeleton, so ``functional_call`` swaps a segment's gathered
    tensors in under ``lm.<name>`` for the duration of one call."""

    def __init__(self, lm: nn.Module):
        super().__init__()
        self.lm = lm

    def forward(self, fn, inputs, batch):
        return fn(self.lm, inputs, batch)


class MeshTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    this rank's shards (module docstring).

    ``params``: this rank's parameter shards by state dict name;
    ``opt_state``: AdamW's state over them; ``batch``: the global batch
    (every rank passes the same), of which this rank takes its rows.  The
    gradients are compressed over the mesh when the config asks for it
    (:func:`repro_torch.optim.grad_compress.compress_sharded_gradients`,
    through ``engine``), then AdamW updates each shard with the global norm
    summed across ranks.  Returns new shards and the loss of the global
    batch (the mean over the batch's ranks of their mean losses)."""

    def __init__(self, layout: MeshLayout, optimizer, engine=None):
        self.layout = layout
        self.cfg = layout.cfg
        self.optimizer = optimizer
        self.engine = engine
        self.segments = train_segments(self.cfg, layout.skeleton)
        self._runner = _Runner(layout.skeleton)
        self.uses = Counter(n for s in self.segments for n in s.params)
        if set(self.uses) != set(layout.shapes):
            raise RuntimeError(f"segments miss parameters: {sorted(set(layout.shapes) - set(self.uses))}")
        self.leaves = reference_leaves(self.cfg, list(layout.shapes))

    def init_state(self, gen: torch.Generator):
        """This rank's shards of the one-device initialization and AdamW's
        state over them."""
        params = init_shards(self.layout, gen)
        return params, self.optimizer.init(params)

    def _run(self, seg: Segment, full: Dict[str, torch.Tensor], inputs, batch):
        with tp.context(self.layout.tp_ctx):
            return functional_call(self._runner, {f"lm.{k}": v for k, v in full.items()}, (seg.fn, inputs, batch))

    def loss_and_grads(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], split: BatchSplit):
        """This rank's loss (of its rows) and its gradient shards."""
        L = self.layout
        saved: List[list] = []
        acts: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for seg in self.segments:
                ins = [acts[r] for r in seg.reads]
                saved.append(ins)
                full = {n: L.compute(n, params[n]) for n in seg.params}
                outs = self._run(seg, full, ins, batch)
                del full
                acts.update(zip(seg.writes, outs))
        loss = acts.pop("loss")
        del acts
        grads_of = {"loss": torch.ones_like(loss)}
        remaining = Counter(self.uses)
        full_grads: Dict[str, torch.Tensor] = {}
        shards: Dict[str, torch.Tensor] = {}
        for i in reversed(range(len(self.segments))):
            seg = self.segments[i]
            ins = saved.pop(i)
            wanted = [(j, grads_of.pop(w)) for j, w in enumerate(seg.writes) if w in grads_of]
            if not seg.params and not any(t.is_floating_point() for t in ins):
                continue  # nothing upstream to differentiate (whisper's encoder input)
            full = {n: L.gather(n, params[n]).detach().requires_grad_() for n in seg.params}
            ins = [t.detach().requires_grad_(t.is_floating_point()) for t in ins]
            with torch.enable_grad():
                outs = self._run(seg, {n: L.select(n, t) for n, t in full.items()}, ins, batch)
            diff = [t for t in ins if t.requires_grad] + list(full.values())
            got = [None] * len(diff)
            if wanted:
                got = torch.autograd.grad([outs[j] for j, _ in wanted], diff, [g for _, g in wanted],
                                          allow_unused=True)
            del outs, wanted
            it = iter(got)
            for r, t in zip(seg.reads, ins):
                if t.requires_grad:
                    g = next(it)
                    if g is not None:
                        grads_of[r] = g if r not in grads_of else grads_of[r] + g
            for n, t in full.items():
                g = next(it)
                if g is None:
                    g = torch.zeros_like(t)
                full_grads[n] = g if n not in full_grads else full_grads[n] + g
                remaining[n] -= 1
                if remaining[n] == 0:
                    shards[n] = L.reduce(n, L.model_grad(n, full_grads.pop(n)), split)
            del full, ins, got
        return loss, {k: shards[k] for k in params}

    def norm_terms(self, names: Sequence[str]):
        """AdamW's per-leaf squared norms over the mesh: each leaf's blocks'
        partial sums added across the (data, model) ranks, every element
        once (a block several ranks hold taken from one of them)."""
        L = self.layout
        if L.n == 1:
            return None

        def reduce(terms):
            t = torch.stack(terms)
            counted = torch.tensor([L.counted(n) for n in names], device=t.device)
            t = torch.where(counted, t, torch.zeros_like(t))
            dist.all_reduce(t, group=L.group)
            return list(t.unbind())

        return reduce

    def __call__(self, params, opt_state, batch):
        from repro_torch.optim.grad_compress import compress_sharded_gradients

        L = self.layout
        rows = int(torch.as_tensor(batch["tokens"]).shape[0])
        split = L.batch_split(rows)
        local = L.local_batch(batch, split)
        with split.routing():
            loss, grads = self.loss_and_grads(params, local, split)
        if split.size > 1:
            dist.all_reduce(loss, group=split.group)
            loss = loss / split.size
        comp = self.cfg.compression
        if comp.grad_compression:
            grads = compress_sharded_gradients(
                grads, self.layout, self.leaves, bits=comp.grad_bits, E_rel=comp.grad_E_rel,
                Delta_rel=comp.grad_Delta_rel, block=comp.grad_block, engine=self.engine)
        new_params, opt_state = self.optimizer.update(grads, opt_state, params,
                                                      norm_terms=self.norm_terms(sorted(grads)))
        return new_params, opt_state, loss.detach()


# ---------------------------------------------------------------------------
# prefill and decode


#: the stacked block lists of the LM classes: each entry is one unit whose
#: parameters a forward hook gathers around its call
_STACKS = ("layers", "groups", "tail", "encoder", "decoder")
#: parameters of a unit that the family's forward reads outside the unit's
#: call (whisper's cross-attention K/V come from the encoder output first):
#: gathered with the top-level ones
_OUTSIDE = {"audio": ("cross_attn",)}


@contextlib.contextmanager
def swapped(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``tensors`` replaced by them for the
    duration (the skeleton's meta parameters put back after)."""
    saved = []
    try:
        for name, t in tensors.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name else module
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield module
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


class MeshServe:
    """Prefill (``kind="prefill"``: ``step(params, batch, cache)``) and
    decode (``kind="decode"``: ``step(params, tokens, cache)``) on this
    rank's shards, each returning ``(logits, cache)`` for this rank's rows
    and, when the vocab splits over "model", its vocab block of the logits
    (the reference's ``_logits_spec``).

    The cache is this rank's (``cache_pspecs``: its batch dim split over
    the data ranks when divisible, else whole; kv heads split over "model"
    when they divide, else ``head_dim``; the SSM ``state`` on heads and
    ``conv`` on ``conv_dim``): :meth:`init_cache` makes one.  The step takes
    the rows of the global batch that go with it.  Top-level parameters are
    gathered for the call, each layer's (group's) around its own call by
    forward hooks, and dropped after, each as the rank's compute reads it
    (:attr:`MeshLayout.uses`).  The bundle's own ``prefill``/``decode`` run
    under the mesh's tensor-parallel context."""

    def __init__(self, layout: MeshLayout, kind: str):
        if kind not in ("prefill", "decode"):
            raise ValueError(kind)
        self.layout, self.kind = layout, kind
        self.bundle = build_model(layout.cfg, layout.device)
        lm = layout.skeleton
        outside = _OUTSIDE.get(layout.cfg.family, ())
        self.units = []
        unit_names = set()
        for attr in _STACKS:
            for i, block in enumerate(getattr(lm, attr, ())):
                prefix = f"{attr}.{i}."
                names = [n for n in layout.shapes if n.startswith(prefix)
                         and not any(f".{o}." in n[len(prefix) - 1:] for o in outside)]
                self.units.append((block, prefix, names))
                unit_names.update(names)
        self.top = [n for n in layout.shapes if n not in unit_names]

    def init_cache(self, rows: int, max_len: int):
        """This rank's zero cache for a global batch of ``rows`` rows
        (``cache_pspecs`` of the global one: each split dim cut)."""
        L = self.layout
        like = build_model(L.cfg, device="meta").init_cache(rows, max_len)
        specs = cache_pspecs(like, L.mesh)

        def local(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            shape = list(t.shape)
            for d, entry in enumerate(spec):
                for a in _names(entry):
                    shape[d] //= L.sizes[a]
            return torch.zeros(shape, dtype=t.dtype, device=L.device)

        return _zip_tree(like, specs, local)

    def __call__(self, params, inputs, cache):
        L = self.layout
        rows_global = int(torch.as_tensor(inputs["tokens"] if isinstance(inputs, dict) else inputs).shape[0])
        rows_local = _cache_rows(cache)
        split = BatchSplit(None, 1, 0) if rows_local == rows_global else L.batch_split(rows_global)
        if split.size * rows_local != rows_global:
            raise ValueError(f"a cache of {rows_local} rows does not split a batch of {rows_global}")
        batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
        local = L.local_batch(batch, split)
        handles = []

        def pre(prefix, names):
            def hook(module, args, kwargs=None):
                ctx = swapped(module, {n[len(prefix):]: L.compute(n, params[n]) for n in names})
                ctx.__enter__()
                module._mesh_swap = ctx
            return hook

        def post(module, args, out):
            module._mesh_swap.__exit__(None, None, None)
            del module._mesh_swap

        for block, prefix, names in self.units:
            handles.append(block.register_forward_pre_hook(pre(prefix, names)))
            handles.append(block.register_forward_hook(post))
        try:
            with torch.no_grad(), split.routing(), tp.context(L.tp_ctx), \
                    swapped(L.skeleton, {n: L.compute(n, params[n]) for n in self.top}):
                if self.kind == "prefill":
                    return self.bundle.prefill(L.skeleton, local, cache)
                return self.bundle.decode(L.skeleton, local["tokens"], cache)
        finally:
            for h in handles:
                h.remove()


def _cache_rows(cache) -> int:
    """The batch rows of a port cache (its first k/v/conv/state leaf)."""
    for name, t in _named_leaves(cache):
        if not isinstance(t, torch.Tensor):
            continue
        if name in ("k", "v", "state"):
            return int(t.shape[-4])
        if name == "conv":
            return int(t.shape[-3])
        if t.ndim >= 4:
            return int(t.shape[-4])
    raise ValueError("a cache without a batch dim")


def _zip_tree(tree, specs, fn):
    """``fn(leaf, spec)`` over a cache tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_tree(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_tree(v, s, fn) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _named_leaves(node, name=None):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _named_leaves(v, k)
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _named_leaves(v, name)
    else:
        yield name, node
