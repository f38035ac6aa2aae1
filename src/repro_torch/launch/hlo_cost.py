"""Cost of one executed step: flops, bytes, collective bytes, kernels.

The reference (``src/repro/launch/hlo_cost.py``) walks the optimized HLO of
a compiled step and scales ``while`` bodies by their trip counts.  The port
has no HLO: :func:`count_cost` runs the step under a ``TorchDispatchMode``
and counts every op as it is dispatched.  Every loop runs, so trip counts
come for free and ``unknown_trips`` stays 0.  The cost model is the
reference's, per rank (each rank runs its own step):

  flops        products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
               convolutions, the fused attention ops: ``linear``, ``matmul``
               and ``einsum`` reach the dispatcher as these):
               2 * prod(result) * prod(contracted dims), by torch's own
               formulas (``torch.utils.flop_counter``); one flop an element
               of the result for the arithmetic and transcendental ops of
               the reference's ``_ELEMENTWISE_FLOP_OPS`` under their aten
               names (:data:`ELEMENTWISE_FLOPS`: an op that XLA would
               decompose, ``silu`` or ``_softmax``, counts the elementwise
               ops it decomposes into); FFTs (``_fft_r2c``, ``_fft_c2r``,
               ``_fft_c2c``): 5 N log2 N, N the result's elements.
  bytes        operand bytes plus result bytes of every op that is not a
               view, an allocation or a metadata op.  The reference counts
               top-level (post-fusion) instructions; every eager op is top
               level, so the port counts what an unfused program moves.
  collectives  result bytes of each ``torch.distributed`` collective, by
               the reference's kinds (``all_reduce``: "all-reduce",
               ``all_gather`` and ``all_gather_into_tensor``: "all-gather",
               ``reduce_scatter_tensor``: "reduce-scatter",
               ``all_to_all_single``: "all-to-all", ``send``/``recv``:
               "collective-permute"), and the kinds the reference's HLO
               has no name for under their own ("broadcast", "reduce");
               ``coll_by_name`` keys them by the module that called
               ``torch.distributed``.
  kernels      a hand-written kernel does not pass through the dispatcher:
               the launches the port's kernel wrappers counted during the
               step, by name, so a count is never silently short.

The counter works on the meta device (nothing is computed, no data-dependent
op can run), on the CPU and on the card.  It also tracks the bytes of live
tensors that the step allocates (its arguments' storage excluded): their
peak is :attr:`Cost.peak_temp_bytes`, an estimate of the step's temporary
memory (the allocator's caching and fragmentation are not in it).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: one flop an element of the result: the reference's elementwise opcodes
#: under their aten names; ops XLA decomposes count their parts
ELEMENTWISE_FLOPS = {
    **dict.fromkeys((
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "exp", "expm1", "log",
        "log1p", "tanh", "rsqrt", "sqrt", "pow", "sin", "cos", "atan2", "sigmoid", "floor", "ceil",
        "round", "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge", "erf",
        "reciprocal", "sign", "logical_not", "logical_and", "logical_or", "bitwise_not"), 1),
    "silu": 2,       # logistic, multiply
    "gelu": 8,       # the tanh form: 3 multiplies, 2 adds, tanh, 2 multiplies
    "_softmax": 3,   # subtract the max, exponential, divide by the sum
    "_log_softmax": 3,
    "addcmul": 2,
    "addcdiv": 2,
    "lerp": 3,
}

_FFT_OPS = {"_fft_r2c", "_fft_c2r", "_fft_c2c"}

#: c10d op -> (the reference's kind, index of the argument its result is)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
    "recv_any_source_": ("collective-permute", 0),
    "broadcast_": ("broadcast", 0),
    "reduce_": ("reduce", 0),
}

#: ops that move no bytes: allocations and metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "lift_fresh",
               "alias", "set_", "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "size",
               "stride", "is_contiguous", "is_non_overlapping_and_dense", "is_strides_like_format", "_local_scalar_dense",
               "record_stream"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_trips: int = 0
    # (op kind, calling module) -> bytes
    coll_by_name: Dict[Tuple[str, str], float] = dataclasses.field(default_factory=dict)
    # kernel name -> launches of the port's hand-written kernels
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the largest bytes of live tensors the counted code allocated at once
    peak_temp_bytes: int = 0

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v
        for k, v in other.coll_by_name.items():
            self.coll_by_name[k] = self.coll_by_name.get(k, 0.0) + v
        for k, v in other.kernels.items():
            self.kernels[k] = self.kernels.get(k, 0) + v
        self.unknown_trips += other.unknown_trips
        self.peak_temp_bytes = max(self.peak_temp_bytes, other.peak_temp_bytes)
        return self

    def scaled(self, n: float) -> "Cost":
        return Cost(self.flops * n, self.bytes * n,
                    {k: v * n for k, v in self.collectives.items()}, self.unknown_trips,
                    {k: v * n for k, v in self.coll_by_name.items()},
                    {k: v * n for k, v in self.kernels.items()}, self.peak_temp_bytes)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, lists, tuples)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


#: modules whose frames lie between a caller and the dispatcher (torch's own,
#: and the wrappers torch's deprecation warnings and decorators add)
_WRAPPERS = ("typing_extensions", "warnings", "functools", "contextlib")


def _caller() -> str:
    """The module that called into ``torch.distributed``."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_globals.get("__name__", "?")
        if not (name in (__name__, "torch", *_WRAPPERS) or name.startswith("torch.")):
            return name
        f = f.f_back
    return "?"


class CostMode(TorchDispatchMode):
    """Counts every dispatched op into :attr:`cost` (module docstring).
    Storages of ``keep`` (the step's arguments) are not temporaries."""

    def __init__(self, keep=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.cost = Cost()
        self._products = flop_registry
        self._kept = {t.untyped_storage()._cdata for t in _tensors(keep)}
        self._refs: Dict[int, list] = {}  # storage -> [bytes, live tensors]
        self._live = 0

    def _release(self, key):
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live -= entry[0]
            del self._refs[key]

    def _track(self, out, args):
        inputs = {id(t) for t in _tensors((args,))}
        for t in _tensors(out):
            if id(t) in inputs:
                continue  # in place: the argument itself
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._kept:
                continue
            entry = self._refs.get(key)
            if entry is None:
                entry = self._refs[key] = [storage.nbytes(), 0]
                self._live += entry[0]
                self.cost.peak_temp_bytes = max(self.cost.peak_temp_bytes, self._live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        c = self.cost
        if ns == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                n = float(tree_bytes(args[kind[1]]))
                c.collectives[kind[0]] = c.collectives.get(kind[0], 0.0) + n
                key = (kind[0], _caller())
                c.coll_by_name[key] = c.coll_by_name.get(key, 0.0) + n
            return out
        if packet in self._products:
            c.flops += float(self._products[packet](*args, **kwargs, out_val=out))
        elif name in _FFT_OPS:
            n = max(out.numel(), 1)
            c.flops += 5.0 * n * math.log2(max(n, 2))
        else:
            per = ELEMENTWISE_FLOPS.get(name.rstrip("_"))
            if per is not None:
                c.flops += float(per * sum(t.numel() for t in _tensors(out)))
        if not func.is_view and name not in _NO_TRAFFIC:
            c.bytes += float(tree_bytes((args, kwargs)) + tree_bytes(out))
        self._track(out, (args, kwargs))
        return out


def counted(fn: Callable, *args, **kwargs) -> Tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode`; its result
    and the :class:`Cost` of the run (the arguments' storage is not counted
    as temporary)."""
    from repro_torch.kernels import launch_counters

    counters = launch_counters()
    before = [dict(c) for c in counters]
    mode = CostMode(keep=(args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    cost = mode.cost
    for c, was in zip(counters, before):
        for k, n in c.items():
            if n != was.get(k, 0):
                cost.kernels[k] = cost.kernels.get(k, 0) + n - was.get(k, 0)
    return out, cost


def count_cost(fn: Callable, *args, **kwargs) -> Cost:
    """The :class:`Cost` of one run of ``fn(*args, **kwargs)``."""
    return counted(fn, *args, **kwargs)[1]
