"""Pencil-decomposed distributed rFFT over ``torch.distributed``.

A real 2-D/3-D field is slab-sharded along axis 0 over one axis of a
:class:`torch.distributed.device_mesh.DeviceMesh`; every rank runs the same
code on its own slab (the reference's ``shard_map`` region), transforms the
unsharded axes locally and moves data between the per-axis passes with
``all_to_all_single`` over the axis's process group.  NCCL on
``cuda:{local_rank}``, gloo on the CPU; complex tensors cross every
collective as ``torch.view_as_real`` views, so one code path serves both.

Layout (D = mesh axis size, ``H = N_last // 2 + 1``, ``S0 = ceil(N0 / D)``,
``P0 = D * S0``), as in the reference:

  3-D field (N0, N1, N2), local slab (S0, N1, N2), pad rows zero:
    rfft ax2 -> [pad ax1 | a2a(1->0) | slice ax0 to N0 | fft ax0]
             -> [pad ax0 | a2a(0->1) | slice ax1 to N1 | fft ax1]
    local half-spectrum block (S0, N1, H), sharded along axis 0.
  2-D field (N0, N1), local slab (S0, N1):
    rfft ax1 -> [pad ax1 to D*ceil(H/D) | a2a(1->0) | slice ax0 to N0 | fft ax0]
    local half-spectrum block (N0, ceil(H/D)), sharded along the half axis.

Pad rows and columns are exactly zero and every pass is linear, so they stay
zero through forward, inverse and the whole POCS loop.

Bitwise discipline.  Every pass runs along the LAST axis of a contiguous
tensor with at least two lines (a lone line is paired with a zero line):
torch's FFTs are then batch-invariant (a line transforms to the same bits
whatever the other lines are), and a strided axis or a single line may take
another code path in the FFT library and round differently.  ``all_to_all``
moves bits untouched, padding inserts and removes exact zeros and the loop's
counts are integer sums, so the transforms, the POCS loop and the blobs
built from it are bitwise the same at every world size, for every shape.
The anchor is this module's own world-size-1 run: torch's fused
``torch.fft.rfftn`` does not reproduce the per-axis sequence bit for bit
(the reference's XLA CPU passes do), so the sharded path is held against the
fused single-device path at a tolerance, never bitwise.  The parity
tri-state of :func:`classify_parity` is the reference's and keeps its
meaning there; the port reports it unchanged.

``*_local`` functions run on every rank of the axis group on local blocks;
:func:`pencil_rfftn` / :func:`pencil_irfftn` are the field-level entry
points; :class:`ShardedField` is the engine-facing handle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cubes import rfft_pair_weights

#: Default number of last-axis chunks each 3-D all_to_all + FFT pair is split
#: into so that communication can overlap compute (1 = single-shot).
DEFAULT_OVERLAP_CHUNKS = 2

def ceil_div(n: int, d: int) -> int:
    return -(-n // d)


def slab_rows(n0: int, n_dev: int) -> int:
    """Rows of axis 0 each rank holds (the padded slab height)."""
    return ceil_div(n0, n_dev)


def padded_extent(n: int, n_dev: int) -> int:
    """``n`` zero-padded up to the next multiple of ``n_dev``."""
    return n_dev * ceil_div(n, n_dev)


def classify_parity(shape: Tuple[int, ...], n_dev: int) -> str:
    """Tri-state parity class of a slab decomposition: value or ValueError.

    ``"bitwise"`` when every c2c axis (all but the last for 3-D, axis 0 for
    2-D) has power-of-two length, ``"bound"`` otherwise; ``ValueError`` for
    unsupported ranks or degenerate extents.  The reference's classes: there
    ``"bitwise"`` means the sharded transforms reproduce the fused
    single-device ones.  In the port every shape is bitwise across world
    sizes, and none against the fused transform (see the module docstring).
    """
    if len(shape) not in (2, 3):
        raise ValueError(
            f"pencil-decomposed FFT supports 2-D and 3-D fields, got rank {len(shape)} "
            f"(shape {shape}); tile other ranks through the engine's pencil batches instead"
        )
    if any(int(n) < 1 for n in shape):
        raise ValueError(f"field shape {shape} has a degenerate (< 1) axis extent")
    if n_dev < 1:
        raise ValueError(f"mesh axis size must be >= 1, got {n_dev}")
    c2c = shape[:-1]
    if all((int(n) & (int(n) - 1)) == 0 for n in c2c):
        return "bitwise"
    return "bound"


def validate_pencil_shape(shape: Tuple[int, ...], n_dev: int, strict_bitwise: bool = True) -> str:
    """Classify ``shape``'s parity; raise when bitwise is demanded but absent.

    Any 2-D/3-D shape slab-decomposes over any mesh size.  With
    ``strict_bitwise`` (the default) a ``"bound"``-class shape raises;
    ``strict_bitwise=False`` accepts it.  Returns the parity class.  The
    reference's check, message included, for the same results on the same
    arguments; no path of the port calls it (see the module docstring).
    """
    parity = classify_parity(tuple(int(n) for n in shape), n_dev)
    if strict_bitwise and parity != "bitwise":
        bad = [(a, int(n)) for a, n in enumerate(shape[:-1]) if int(n) & (int(n) - 1)]
        a, n = bad[0]
        raise ValueError(
            f"axis {a} length {n} is not a power of two: the inverse FFT's "
            f"1/{n} normalization then rounds differently split per-axis "
            f"than fused, so blobs would not be bitwise identical to the "
            f"single-device path; request parity='auto' (strict_bitwise=False) "
            f"to accept float32-rounding-level divergence (bounds still hold)"
        )
    return parity


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Static description of one slab decomposition.

    The reference's fields (mesh axis name, true global shape, axis size,
    transpose overlap chunk count) plus the axis's process ``group`` (not
    compared or hashed; ``None`` is the default group), which the collectives
    of the ``*_local`` bodies and the loop's ``dist`` mode run over.
    """

    axis_name: str
    gshape: Tuple[int, ...]
    n_dev: int
    overlap_chunks: int = DEFAULT_OVERLAP_CHUNKS
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def rank(self) -> int:
        """This process's index along the axis."""
        return dist.get_rank(self.group)


def freq_partition_spec(ndim: int, axis_name: str) -> Tuple[Optional[str], ...]:
    """The mesh axis of each axis of the distributed half-spectrum (the
    reference's ``PartitionSpec``, as a tuple): axis 0 for a 3-D field, the
    half axis for a 2-D one."""
    return (axis_name,) if ndim == 3 else (None, axis_name)


def local_freq_shape(gshape: Tuple[int, ...], n_dev: int) -> Tuple[int, ...]:
    """Local (per-rank) half-spectrum block shape, pad rows/columns included."""
    h = gshape[-1] // 2 + 1
    if len(gshape) == 3:
        return (slab_rows(gshape[0], n_dev), gshape[1], h)
    return (gshape[0], ceil_div(h, n_dev))


def padded_freq_shape(gshape: Tuple[int, ...], n_dev: int) -> Tuple[int, ...]:
    """Global half-spectrum shape of the gathered blocks, pad included."""
    h = gshape[-1] // 2 + 1
    if len(gshape) == 3:
        return (padded_extent(gshape[0], n_dev), gshape[1], h)
    return (gshape[0], padded_extent(h, n_dev))


def padded_spatial_shape(gshape: Tuple[int, ...], n_dev: int) -> Tuple[int, ...]:
    """Global spatial shape of the gathered slabs: axis 0 padded to a slab multiple."""
    return (padded_extent(gshape[0], n_dev),) + tuple(gshape[1:])


def local_pair_weights(gshape: Tuple[int, ...], freq_shape: Tuple[int, ...], rank: int = 0, device=None):
    """Conjugate-pair multiplicities for rank ``rank``'s half-spectrum block.

    3-D blocks keep the whole half axis, so the static
    :func:`repro_torch.core.cubes.rfft_pair_weights` plane broadcasts as is
    (pad rows carry weights, but their components are exactly zero).  2-D
    blocks shard the half axis: global column indices start at
    ``rank * freq_shape[-1]``, and transit-pad columns beyond the true half
    extent get weight 0.  (The reference reads the rank from
    ``jax.lax.axis_index``.)
    """
    if len(gshape) == 3:
        return rfft_pair_weights(gshape, device=device)
    n = gshape[-1]
    h = n // 2 + 1
    h_loc = freq_shape[-1]
    col = rank * h_loc + torch.arange(h_loc, device=device)
    w = torch.where(col == 0, 1, 2)
    if n % 2 == 0:
        w = torch.where(col == h - 1, 1, w)
    w = torch.where(col >= h, 0, w)  # transit-pad columns: not spectrum at all
    return w.to(torch.int32)[None, :]


# ---------------------------------------------------------------------------
# meshes and process groups


#: the default group the cached meshes were built over, and its meshes by
#: axis name (dropped when the default group is no longer that object)
_DEFAULT_MESHES: dict = {"group": None, "meshes": {}}


def _device_type(backend: str) -> str:
    return "cuda" if "nccl" in str(backend) else "cpu"


def default_mesh(axis_name: str = "data"):
    """A 1-D mesh named ``axis_name`` over the default process group.

    The port never starts a process group itself: without an initialized
    one this raises ``ValueError`` (pass ``mesh=``, or call
    ``torch.distributed.init_process_group`` first).  NCCL groups give a
    ``"cuda"`` mesh, others a ``"cpu"`` one.  Built once per default group
    and axis name (building a mesh is a collective call); a new default
    group, after ``destroy_process_group``, gets new meshes.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "no mesh given and no torch.distributed process group is initialized: pass "
            "mesh=<DeviceMesh> or call torch.distributed.init_process_group first"
        )
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.group.WORLD
    if _DEFAULT_MESHES["group"] is not world:
        _DEFAULT_MESHES.update(group=world, meshes={})
    meshes = _DEFAULT_MESHES["meshes"]
    if axis_name not in meshes:
        meshes[axis_name] = init_device_mesh(
            _device_type(dist.get_backend()), (dist.get_world_size(),), mesh_dim_names=(axis_name,)
        )
    return meshes[axis_name]


def mesh_axis(mesh, axis_name: str):
    """``(group, size, rank)`` of ``mesh``'s axis ``axis_name``."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as collectives carry it: complex as its real view,
    bool as uint8."""
    t = t.contiguous()
    if t.is_complex():
        return torch.view_as_real(t)
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(t)
    if like.dtype == torch.bool:
        return t.to(torch.bool)
    return t


def all_gather_cat(t: torch.Tensor, group, n_dev: int, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each), concatenated along ``dim`` in
    rank order; on every rank."""
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(n_dev)]
    dist.all_gather(parts, w, group=group)
    return torch.cat([_unwire(p, t) for p in parts], dim=dim)


def gather_to_host(t: torch.Tensor, group, n_dev: int, dim: int = 0, keep: Optional[int] = None,
                   dtype=None) -> np.ndarray:
    """Every rank's block ``t`` (same shape on each), concatenated along
    ``dim`` in rank order and cut to its first ``keep`` entries there (all
    of them by default), as one host array on every rank.

    The blocks travel one at a time: rank ``r`` broadcasts its block, every
    rank copies it into the host array and drops it before the next, so a
    card holds its own block and one received block at most (an all-gather
    would hold the whole array on every card).  Blocks wholly past ``keep``
    are not sent.  ``dtype`` is the host array's (default ``t``'s); values
    are cast as they land, exactly when the cast widens.
    """
    n = t.shape[dim]
    keep = n * n_dev if keep is None else int(keep)
    w = _wire(t)
    shape = list(t.shape)
    shape[dim] = keep
    out = np.empty(shape, dtype=dtype if dtype is not None else torch.empty(0, dtype=t.dtype).numpy().dtype)
    me = dist.get_rank(group)
    where = [slice(None)] * len(shape)
    for r in range(ceil_div(keep, n)):
        buf = w if r == me else torch.empty_like(w)
        dist.broadcast(buf, src=r if group is None else dist.get_global_rank(group, r), group=group)
        m = min(n, keep - r * n)
        where[dim] = slice(r * n, r * n + m)
        out[tuple(where)] = _unwire(buf, t).narrow(dim, 0, m).cpu().numpy()
        del buf
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    dist.all_reduce(t, op=op, group=group)
    return t


# ---------------------------------------------------------------------------
# local passes and transposes


def _along(fn, p: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the last-axis transform ``fn`` along ``axis`` of ``p``.

    The axis is moved last and the tensor made contiguous, and a lone line
    is paired with a zero line: every line then takes the same path through
    the FFT library whatever the batch (see the module docstring)."""
    q = p.movedim(axis, -1).contiguous()
    n = q.shape[-1]
    if q.numel() == n and n:
        pair = torch.cat([q.reshape(1, n), torch.zeros_like(q.reshape(1, n))])
        out = fn(pair)[:1].reshape(q.shape[:-1] + (-1,))
    else:
        out = fn(q)
    return out.movedim(-1, axis)


def _fft(q):
    return torch.fft.fft(q, dim=-1)


def _ifft(q):
    return torch.fft.ifft(q, dim=-1)


def _pad_axis_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _start_all_to_all(piece: torch.Tensor, spec: DistSpec, split_axis: int):
    """Split ``piece`` along ``split_axis`` into ``n_dev`` equal parts and
    start sending part j to rank j; returns (work, received, like)."""
    piece = _pad_axis_to(piece, split_axis, spec.n_dev)
    send = _wire(torch.stack(torch.chunk(piece, spec.n_dev, dim=split_axis)))
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=spec.group, async_op=True)
    return work, recv, send, piece


def _transpose_apply(t: torch.Tensor, spec: DistSpec, split_axis: int, concat_axis: int, keep: int, apply_fn):
    """One transpose + FFT pair: pad -> all_to_all -> slice -> per-axis pass.

    Pads ``split_axis`` with zeros to a multiple of the axis size so that the
    all_to_all is well formed on any extent, concatenates the received parts
    along ``concat_axis`` in rank order, slices that axis back to its true
    extent ``keep`` and runs ``apply_fn`` (the pass along ``concat_axis``).
    When the last axis is free (3-D) and ``spec.overlap_chunks > 1``, the
    pair runs on independent last-axis chunks, chunk ``i + 1``'s all_to_all
    started before chunk ``i``'s transform; chunking changes no bit (every
    line transforms alone).
    """

    def finish(handle):
        work, recv, _send, piece = handle
        work.wait()
        parts = _unwire(recv, piece).unbind(0)
        out = torch.cat(parts, dim=concat_axis)
        if out.shape[concat_axis] != keep:
            out = out.narrow(concat_axis, 0, keep)
        return apply_fn(out)

    last = t.ndim - 1
    chunks = spec.overlap_chunks
    if chunks <= 1 or last in (split_axis, concat_axis) or t.shape[last] < chunks:
        return finish(_start_all_to_all(t, spec, split_axis))
    base, rem = divmod(t.shape[last], chunks)
    sizes = [base + (1 if i < rem else 0) for i in range(chunks)]
    offsets = np.cumsum([0] + sizes[:-1])
    pieces = [t.narrow(last, int(o), s) for o, s in zip(offsets, sizes)]
    handles = [_start_all_to_all(pieces[0], spec, split_axis)]
    outs = []
    for i in range(len(pieces)):
        if i + 1 < len(pieces):
            handles.append(_start_all_to_all(pieces[i + 1], spec, split_axis))
        outs.append(finish(handles[i]))
        handles[i] = None
    return torch.cat(outs, dim=last)


def rfftn_local(block: torch.Tensor, spec: DistSpec) -> torch.Tensor:
    """Distributed ``rfftn`` body on this rank's slab: r2c along the last
    axis, then c2c along axis 0, then axis 1 (the reference's pass order),
    with padded all_to_all transposes between them."""
    gshape = spec.gshape
    nd = len(gshape)
    r = _along(lambda q: torch.fft.rfft(q, dim=-1), block, nd - 1)
    t = _transpose_apply(r, spec, split_axis=1, concat_axis=0, keep=gshape[0],
                         apply_fn=lambda p: _along(_fft, p, 0))
    if nd == 2:
        return t
    return _transpose_apply(t, spec, split_axis=0, concat_axis=1, keep=gshape[1],
                            apply_fn=lambda p: _along(_fft, p, 1))


def _c2r_last(p: torch.Tensor, n: int, fft_impl: str) -> torch.Tensor:
    """The local last-axis C2R pass; ``fft_impl="packed"`` takes the
    pack-trick transform (:func:`repro_torch.kernels.rfft.ops.packed_irfft`)
    for an even ``n``, anything else ``torch.fft.irfft``."""
    if fft_impl == "packed" and n % 2 == 0 and n >= 2:
        from repro_torch.kernels.rfft import ops as rfft_ops

        return _along(lambda q: rfft_ops.packed_irfft(q, n), p, p.ndim - 1)
    return _along(lambda q: torch.fft.irfft(q, n=n, dim=-1), p, p.ndim - 1)


def irfftn_local(block: torch.Tensor, spec: DistSpec, fft_impl: str = "xla") -> torch.Tensor:
    """Distributed ``irfftn`` body (inverse pass order: axis 0, axis 1, c2r
    last); ``fft_impl="packed"`` runs the c2r pass through the pack trick."""
    gshape = spec.gshape
    nd = len(gshape)
    if nd == 2:
        t = _along(_ifft, block, 0)
        return _transpose_apply(t, spec, split_axis=0, concat_axis=1, keep=gshape[-1] // 2 + 1,
                                apply_fn=lambda p: _c2r_last(p, gshape[1], fft_impl))
    t = _transpose_apply(block, spec, split_axis=1, concat_axis=0, keep=gshape[0],
                         apply_fn=lambda p: _along(_ifft, p, 0))
    t = _transpose_apply(t, spec, split_axis=0, concat_axis=1, keep=gshape[1],
                         apply_fn=lambda p: _along(_ifft, p, 1))
    return _c2r_last(t, gshape[2], fft_impl)


# ---------------------------------------------------------------------------
# the engine-facing handle


class ShardedField:
    """A real 2-D/3-D field slab-sharded along axis 0 over one mesh axis.

    Every rank of the axis holds one slab, ``local``: rows ``[rank * S0,
    (rank + 1) * S0)`` of the field zero-padded at the tail of axis 0 to
    ``padded_shape``, as float32 on the mesh's device.  ``shape`` stays the
    true extent.  ``CorrectionEngine.plan_field`` / ``execute_field``,
    ``FFCz.compress`` and ``power_spectrum`` accept it; each is a collective
    call that every rank of the axis makes.

    The constructor takes the whole field (every rank passes the same
    array, as each reads the same file) and keeps this rank's slab;
    :meth:`from_local` takes a slab a rank already holds.
    ``overlap_chunks`` is the reference's.  ``parity`` is accepted as the
    reference's signature has it and selects nothing: every shape is
    bitwise across world sizes and none against the fused single-device
    transform; ``parity`` (the attribute) reports the reference's class.
    ``to_host()`` is the gathered, unpadded host copy (cached), moved one
    slab at a time: the staging buffer of the host stages (base compressor,
    polish, encode).
    """

    def __init__(
        self,
        array,
        mesh,
        axis_name: str = "data",
        parity: Union[str, bool, None] = "auto",
        overlap_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    ):
        self._setup(tuple(int(n) for n in array.shape), mesh, axis_name, overlap_chunks)
        s0 = self.padded_shape[0] // self.n_dev
        a = self.rank * s0
        b = min(a + s0, self.gshape[0])
        if isinstance(array, torch.Tensor):
            rows = array.detach()[a:b].to(device=self.device, dtype=torch.float32)
        else:
            rows = torch.from_numpy(np.ascontiguousarray(np.asarray(array)[a:b], dtype=np.float32)).to(self.device)
        self.local = _pad_axis_to(rows, 0, s0) if rows.shape[0] else rows.new_zeros((s0,) + self.gshape[1:])
        self.local = self.local.contiguous()

    def _setup(self, shape, mesh, axis_name, overlap_chunks):
        self.group, n_dev, self.rank = mesh_axis(mesh, axis_name)
        self.parity = classify_parity(shape, n_dev)
        self.mesh = mesh
        self.axis_name = axis_name
        self.overlap_chunks = int(overlap_chunks)
        self.gshape = shape
        self.padded_shape = padded_spatial_shape(shape, n_dev)
        self.device = mesh_device(mesh)
        self.n_dev = n_dev
        self._host: Optional[np.ndarray] = None

    @classmethod
    def shard(
        cls,
        x,
        mesh=None,
        axis_name: str = "data",
        parity: Union[str, bool, None] = "auto",
        overlap_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    ) -> "ShardedField":
        """Shard a whole field over ``mesh[axis_name]`` (default: a 1-D mesh
        over the default process group, :func:`default_mesh`)."""
        if mesh is None:
            mesh = default_mesh(axis_name)
        return cls(x, mesh, axis_name, parity, overlap_chunks)

    @classmethod
    def from_local(
        cls,
        local: torch.Tensor,
        gshape: Tuple[int, ...],
        mesh,
        axis_name: str = "data",
        parity: Union[str, bool, None] = "auto",
        overlap_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    ) -> "ShardedField":
        """Wrap this rank's slab ``local`` (``S0`` rows, pad rows included;
        they are set to zero) of a field of true shape ``gshape``."""
        field = cls.__new__(cls)
        field._setup(tuple(int(n) for n in gshape), mesh, axis_name, overlap_chunks)
        s0 = field.padded_shape[0] // field.n_dev
        want = (s0,) + field.gshape[1:]
        if tuple(local.shape) != want:
            raise ValueError(f"rank {field.rank}'s slab must have shape {want}, got {tuple(local.shape)}")
        local = local.to(device=field.device, dtype=torch.float32).contiguous()
        keep = max(0, min(s0, field.gshape[0] - field.rank * s0))
        if keep < s0:
            local = local.clone()
            local[keep:] = 0
        field.local = local
        return field

    @property
    def shape(self) -> Tuple[int, ...]:
        """The TRUE (unpadded) global field shape."""
        return self.gshape

    @property
    def ndim(self) -> int:
        return len(self.gshape)

    @property
    def padded_freq_shape(self) -> Tuple[int, ...]:
        return padded_freq_shape(self.gshape, self.n_dev)

    @property
    def freq_shape(self) -> Tuple[int, ...]:
        """The TRUE (unpadded) rfft half-spectrum shape."""
        return tuple(self.gshape[:-1]) + (self.gshape[-1] // 2 + 1,)

    @property
    def local_freq_shape(self) -> Tuple[int, ...]:
        return local_freq_shape(self.gshape, self.n_dev)

    @property
    def dist_spec(self) -> DistSpec:
        return DistSpec(self.axis_name, self.gshape, self.n_dev, self.overlap_chunks, group=self.group)

    def unpad_spatial(self, a):
        """Slice a padded (gathered) spatial array to the true extents."""
        return a[: self.gshape[0]]

    def unpad_freq(self, a):
        """Slice a padded (gathered) half-spectrum to the true extents."""
        if self.ndim == 3:
            return a[: self.gshape[0]]
        return a[:, : self.freq_shape[-1]]

    def pad_spatial_np(self, grid: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Pad a true-extent spatial grid to the padded layout; ``fill`` is
        the pad-row value (bound grids pad with the background bound, so the
        zero pad rows of the field stay inside their cube)."""
        pad0 = self.padded_shape[0] - self.gshape[0]
        if pad0:
            widths = [(0, pad0)] + [(0, 0)] * (self.ndim - 1)
            return np.pad(grid, widths, constant_values=fill)
        return grid

    def pad_freq_np(self, grid: np.ndarray) -> np.ndarray:
        """Zero-pad a true-extent half-spectrum grid to the padded layout."""
        pfs = self.padded_freq_shape
        widths = [(0, p - t) for p, t in zip(pfs, grid.shape)]
        if any(w != (0, 0) for w in widths):
            return np.pad(grid, widths)
        return grid

    @property
    def freq_axis(self) -> int:
        """The sharded axis of the half-spectrum."""
        return freq_partition_spec(self.ndim, self.axis_name).index(self.axis_name)

    def to_local(self, grid_padded: np.ndarray, freq: bool = False) -> torch.Tensor:
        """This rank's part of a padded host grid (a spatial slab, or with
        ``freq`` a half-spectrum block), contiguous on the device."""
        axis = self.freq_axis if freq else 0
        n = self.local_freq_shape[axis] if freq else self.padded_shape[0] // self.n_dev
        part = np.take(grid_padded, range(self.rank * n, (self.rank + 1) * n), axis=axis)
        return torch.from_numpy(np.ascontiguousarray(part)).to(self.device)

    def spatial_to_host(self, local: torch.Tensor, dtype=None) -> np.ndarray:
        """Every rank's spatial slab ``local``, as one host array at the
        true extents, on every rank (:func:`gather_to_host`)."""
        return gather_to_host(local, self.group, self.n_dev, 0, self.gshape[0], dtype)

    def freq_to_host(self, local: torch.Tensor, dtype=None) -> np.ndarray:
        """Every rank's half-spectrum block ``local``, as one host array at
        the true extents, on every rank (:func:`gather_to_host`)."""
        axis = self.freq_axis
        return gather_to_host(local, self.group, self.n_dev, axis, self.freq_shape[axis], dtype)

    def to_host(self) -> np.ndarray:
        """Gathered UNPADDED host copy (cached), on every rank."""
        if self._host is None:
            self._host = self.spatial_to_host(self.local)
        return self._host


def pencil_rfftn(field: ShardedField) -> torch.Tensor:
    """Distributed ``rfftn`` of a :class:`ShardedField`: this rank's block of
    the half-spectrum in the padded layout (``field.local_freq_shape``; pad
    rows/columns exactly zero).  ``field.freq_to_host`` gives the
    true-extent spectrum, bitwise the same at every world size."""
    return rfftn_local(field.local, field.dist_spec)


def pencil_irfftn(
    spectrum,
    gshape: Tuple[int, ...],
    mesh,
    axis_name: str = "data",
    parity: Union[str, bool, None] = "auto",
    overlap_chunks: int = DEFAULT_OVERLAP_CHUNKS,
) -> ShardedField:
    """Distributed ``irfftn`` -> a :class:`ShardedField` of true shape ``gshape``.

    ``spectrum`` is the global half-spectrum (a host array or a tensor), in
    the padded layout of ANY writer mesh (pad rows/columns are zero and sit
    at the tail, so a foreign mesh's padding is sliced off) or at the true
    extents; either is re-padded to THIS mesh's layout, and each rank
    transforms its own block.  ``parity`` selects nothing, as in
    :class:`ShardedField`.
    """
    gshape = tuple(int(n) for n in gshape)
    _, n_dev, _ = mesh_axis(mesh, axis_name)
    classify_parity(gshape, n_dev)
    if isinstance(spectrum, torch.Tensor):
        spectrum = spectrum.detach().cpu().numpy()
    spectrum = np.asarray(spectrum, dtype=np.complex64)
    pfs = padded_freq_shape(gshape, n_dev)
    if tuple(spectrum.shape) != pfs:
        true_fs = tuple(gshape[:-1]) + (gshape[-1] // 2 + 1,)
        if len(spectrum.shape) != len(true_fs) or any(s < t for s, t in zip(spectrum.shape, true_fs)):
            raise ValueError(
                f"spectrum shape {tuple(spectrum.shape)} is smaller than the "
                f"half-spectrum {true_fs} of field shape {gshape}; pass the "
                f"true-extent spectrum or a padded layout"
            )
        spectrum = spectrum[tuple(slice(0, t) for t in true_fs)]
        spectrum = np.pad(spectrum, [(0, p - t) for p, t in zip(pfs, true_fs)])
    field = ShardedField.__new__(ShardedField)
    field._setup(gshape, mesh, axis_name, overlap_chunks)
    local = irfftn_local(field.to_local(spectrum, freq=True), field.dist_spec)
    return ShardedField.from_local(local, gshape, mesh, axis_name, overlap_chunks=overlap_chunks)
