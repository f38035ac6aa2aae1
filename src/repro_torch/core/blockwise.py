"""Blockwise EXECUTE stage of the CorrectionEngine: pencil-tiled correction.

Fields and framework tensors (KV blocks, gradients, checkpoint leaves) are
flattened, zero-padded and tiled into ``block``-length pencils, and each
pencil is corrected independently; the frequency bound then applies to each
pencil's own spectrum.  The plan stage
(:meth:`repro_torch.core.engine.CorrectionEngine.plan_pencils`) resolves
bounds and tiling, this module runs the device loop, and
:mod:`repro_torch.core.edits` serializes the result.  The reference's three
backends share the packed ``(B, block)`` layout:

``local``    one :func:`blockwise_correct_with_edits` call per tensor.
``batched``  MANY heterogeneous tensors in ONE loop (:func:`correct_batch`):
             each tensor is tiled into a shared ``(B, block)`` buffer,
             per-tensor bounds become per-block bound vectors, and one
             batched loop (:func:`repro_torch.core.pocs.alternating_projection_batched`)
             corrects every pencil, each row frozen once it converges.
``sharded``  the batched loop with the packed rows split over a mesh axis
             (:func:`_pocs_sharded`): every rank of the axis packs the same
             batch, runs the loop on its own contiguous rows and
             ``all_gather``s the results.  Blocks are independent, so no
             collective runs inside the loop, and each pencil's bits and
             stats are the batched backend's (the loop's transforms run per
             row).

Buffers: JAX donates ``correct_batch``'s inputs so each corrected output can
alias its input.  The port donates nothing of the caller's: inputs are read,
never written, and every output is a fresh tensor.  The packed buffer is the
port's own, so the batched loop takes it as its ``eps`` (``donate``); each
per-tensor tiling is released once it has been packed, and without
``return_edits`` the loop keeps no edit streams.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.pocs import AlternatingProjectionResult, alternating_projection_batched
from repro_torch.device import resolve_device
from repro_torch.sharding import dist_fft


def tile_1d(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Flatten to 1D and tile into (n_blocks, block); zero-pad the tail."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


def untile_1d(blocks: torch.Tensor, shape, pad: int) -> torch.Tensor:
    flat = blocks.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def blockwise_correct(eps: torch.Tensor, E, Delta, block: int = 4096, max_iters: int = 50,
                      fft_impl: str = "xla") -> torch.Tensor:
    """Dual-domain-bound a spatial error tensor, blockwise.

    Returns the corrected error tensor (``eps``'s shape) whose every
    ``block``-length pencil satisfies ``|eps_n| <= E`` and
    ``|Re/Im(FFT(eps))_k| <= Delta`` (``E``/``Delta`` scalars).
    """
    return blockwise_correct_with_edits(eps, E, Delta, block, max_iters, fft_impl)[0]


def blockwise_correct_with_edits(eps: torch.Tensor, E, Delta, block: int = 4096, max_iters: int = 50,
                                 fft_impl: str = "xla", warm: Optional[torch.Tensor] = None):
    """Like :func:`blockwise_correct` but also returns ``(spat_edits,
    freq_edits, iterations-per-block, converged-per-block)``; ``freq_edits``
    are per-block rfft half-spectra ``(n_blocks, block // 2 + 1)``.  ``warm``
    optionally seeds each block's loop with a prior edit spectrum of that
    layout."""
    tiles, pad = tile_1d(eps.to(torch.float32), block)
    res = alternating_projection_batched(
        tiles, E, Delta, max_iters=max_iters, fft_impl=fft_impl, warm_freq=warm
    )
    corrected = untile_1d(res.eps, eps.shape, pad)
    return corrected, res.spat_edits, res.freq_edits, res.iterations, res.converged


@dataclasses.dataclass
class BatchCorrectionStats:
    """Per-instance accounting for one :func:`correct_batch` call."""

    iterations: Any  # (n_tensors,) int32: max POCS iterations over the tensor's blocks
    converged: Any  # (n_tensors,) bool: every block of the tensor converged
    block_iterations: Any  # (total_blocks,) int32
    block_converged: Any  # (total_blocks,) bool


def empty_stats(device) -> BatchCorrectionStats:
    """The stats of an empty batch."""
    return BatchCorrectionStats(
        iterations=torch.zeros((0,), dtype=torch.int32, device=device),
        converged=torch.zeros((0,), dtype=torch.bool, device=device),
        block_iterations=torch.zeros((0,), dtype=torch.int32, device=device),
        block_converged=torch.zeros((0,), dtype=torch.bool, device=device),
    )


def _check_backend(backend: str) -> None:
    if backend not in ("batched", "sharded"):
        raise ValueError(f"the packed path runs backend 'batched' (or 'sharded'), got {backend!r}")


def _pocs_batched(packed, E_blk, D_blk, max_iters, fft_impl="xla", warm=None, donate=False, keep_edits=True):
    """The batched loop over a packed ``(B, block)`` buffer (the batched
    backend); ``warm`` is an optional packed ``(B, block//2+1)`` complex
    buffer of per-block warm-start spectra aligned with ``packed``'s rows;
    with ``donate`` the loop writes its ``eps`` into ``packed``, without
    ``keep_edits`` it accumulates no edit streams."""
    return alternating_projection_batched(
        packed, E_blk, D_blk, max_iters=max_iters, fft_impl=fft_impl, warm_freq=warm, donate=donate,
        keep_edits=keep_edits,
    )


def _pocs_sharded(packed, E_blk, D_blk, max_iters, mesh, axis, fft_impl="xla", warm=None, donate=False,
                  keep_edits=True):
    """The batched loop with the packed rows split over ``mesh[axis]``.

    The block count is padded to a multiple of the axis size with
    already-feasible zero blocks (E = Delta = 1; zero warm rows when warm
    started), which stop at the first check.  Each rank runs
    :func:`_pocs_batched` on its contiguous share of rows; the results are
    ``all_gather``ed in rank order and sliced back to the batch's rows, on
    every rank.  ``donate`` lets the loop write its ``eps`` into
    ``packed``'s rows.
    """
    group, n_dev, rank = dist_fft.mesh_axis(mesh, axis)
    nb = packed.shape[0]
    pad = (-nb) % n_dev
    if pad:
        packed = torch.cat([packed, packed.new_zeros((pad, packed.shape[1]))])
        E_blk = torch.cat([E_blk, E_blk.new_ones((pad,))])
        D_blk = torch.cat([D_blk, D_blk.new_ones((pad,))])
        if warm is not None:
            warm = torch.cat([warm, warm.new_zeros((pad, warm.shape[1]))])
        donate = True  # the padded buffer is the loop's own
    rows = (nb + pad) // n_dev
    mine = slice(rank * rows, (rank + 1) * rows)
    res = _pocs_batched(packed[mine], E_blk[mine], D_blk[mine], max_iters, fft_impl,
                        None if warm is None else warm[mine], donate=donate, keep_edits=keep_edits)
    del packed, warm

    def gathered(t):
        return None if t is None else dist_fft.all_gather_cat(t, group, n_dev)[:nb]

    return AlternatingProjectionResult(
        eps=gathered(res.eps),
        spat_edits=gathered(res.spat_edits),
        freq_edits=gathered(res.freq_edits),
        iterations=gathered(res.iterations),
        converged=gathered(res.converged),
        final_violations=gathered(res.final_violations),
    )


def _run_packed(packed, E_blk, D_blk, max_iters, backend, mesh, axis, fft_impl, warm, donate=False,
                keep_edits=True):
    """The packed loop on ``backend``: batched, or sharded over ``mesh[axis]``."""
    with tracing.span("ffcz.loop") as s:
        rows, block = packed.shape
        if backend == "sharded":
            res = _pocs_sharded(packed, E_blk, D_blk, max_iters, mesh, axis, fft_impl, warm, donate, keep_edits)
        else:
            res = _pocs_batched(packed, E_blk, D_blk, max_iters, fft_impl, warm, donate=donate,
                                keep_edits=keep_edits)
        if s:
            s.count(rows=rows, block=block, iterations=res.iterations.sum(), converged=res.converged.sum())
    return res


def _segment_stats(res, seg: torch.Tensor, n: int) -> BatchCorrectionStats:
    """Per-instance reductions of per-block results (``segment_max`` /
    ``segment_min`` in the reference; an instance with no block reports the
    int32 identity of the max and is not converged, as there)."""
    i32 = torch.iinfo(torch.int32)
    it = torch.full((n,), i32.min, dtype=torch.int32, device=seg.device)
    it = it.scatter_reduce(0, seg, res.iterations, "amax")
    conv = torch.full((n,), i32.max, dtype=torch.int32, device=seg.device)
    conv = conv.scatter_reduce(0, seg, res.converged.to(torch.int32), "amin")
    return BatchCorrectionStats(
        iterations=it,
        converged=conv == 1,
        block_iterations=res.iterations,
        block_converged=res.converged,
    )


def _segments(counts: Sequence[int], device) -> torch.Tensor:
    return torch.from_numpy(np.repeat(np.arange(len(counts)), counts)).to(device)


def _correct_batch_core(tensors, E, Delta, block, max_iters, return_edits, return_corrected,
                        backend="batched", fft_impl="xla", warm=None, mesh=None, axis="data"):
    """The whole batched correction: pack (per-tensor bounds included),
    batched (or sharded) loop, unpack, stats."""
    _check_backend(backend)
    with tracing.span("ffcz.engine.pack"):
        n, dev = len(tensors), tensors[0].device
        E_arr, Delta_arr = as_bound_array(E, n, dev), as_bound_array(Delta, n, dev)
        tiles_list, pads, counts = [], [], []
        for t in tensors:
            tiles, pad = tile_1d(t.to(torch.float32), block)
            tiles_list.append(tiles)
            pads.append(pad)
            counts.append(tiles.shape[0])
        packed = torch.cat(tiles_list, dim=0)
        del tiles_list, tiles
        seg = _segments(counts, packed.device)
        warm_packed = None
        if warm is not None:
            warm_packed = torch.cat([torch.as_tensor(w, device=packed.device).to(torch.complex64)
                                     for w in warm], dim=0)
        E_blk, D_blk = E_arr[seg], Delta_arr[seg]
    res = _run_packed(packed, E_blk, D_blk, max_iters, backend, mesh, axis, fft_impl, warm_packed,
                      donate=True, keep_edits=return_edits)
    del packed, warm_packed, E_blk, D_blk
    with tracing.span("ffcz.engine.unpack"):
        stats = _segment_stats(res, seg, n)
        eps, edits, offsets = res.eps, [], np.cumsum((0,) + tuple(counts))
        if return_edits:
            edits = [(res.spat_edits[a:b], res.freq_edits[a:b]) for a, b in zip(offsets[:-1], offsets[1:])]
        del res
        corrected = []
        if return_corrected:
            corrected = [untile_1d(eps[a:b], t.shape, pad).to(t.dtype)
                         for t, pad, a, b in zip(tensors, pads, offsets[:-1], offsets[1:])]
    return corrected, edits, stats


def batch_layout(sizes: Sequence[int], block: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-tensor (block counts, tail pads) for a packed ``(B, block)`` batch."""
    counts = tuple(-(-s // block) for s in sizes)
    pads = tuple((-s) % block for s in sizes)
    return counts, pads


def pack_batch(tensors: Sequence[Any], block: int, out: Optional[np.ndarray] = None):
    """Stage a heterogeneous batch into ONE host ``(B, block)`` float32 buffer.

    Each tensor is flattened, cast to float32 and zero-padded into
    ``block``-length rows, all tensors concatenated along the rows axis.
    ``out`` is an optional reusable staging buffer, filled in place and
    returned when its shape matches the batch's ``(B, block)`` layout.

    Returns ``(packed, counts, pads)`` with ``counts[i]`` rows belonging to
    ``tensors[i]`` and ``pads[i]`` trailing zeros in its last row.
    """
    arrays = [to_numpy(t) for t in tensors]
    counts, pads = batch_layout([a.size for a in arrays], block)
    B = sum(counts)
    if out is None or out.shape != (B, block) or out.dtype != np.float32:
        out = np.empty((B, block), dtype=np.float32)
    row = 0
    for a, nb, pad in zip(arrays, counts, pads):
        flat = np.asarray(a, dtype=np.float32).reshape(-1)
        dest = out[row : row + nb].reshape(-1)
        dest[: flat.size] = flat
        if pad:
            dest[flat.size :] = 0.0
        row += nb
    return out, counts, pads


def to_numpy(t) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def as_bound_array(v, n: int, device) -> torch.Tensor:
    """Per-tensor float32 bounds: a scalar broadcast to ``n``, or a sequence
    of ``n`` scalars (a length mismatch raises rather than mis-assigning)."""
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected {n} per-tensor bounds, got {len(v)}")
        return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())
                            for x in v])
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=device), (n,))


def correct_packed(packed, counts: Sequence[int], E, Delta, max_iters: int = 50,
                   backend: str = "batched", fft_impl: str = "xla", warm=None, device=None,
                   mesh=None, axis: str = "data"):
    """Run the batched loop on a pre-packed ``(B, block)`` buffer (a
    :func:`pack_batch` staging array, or a float32 tensor); returns
    ``(res, stats)``.

    A numpy buffer is copied to ``device`` (``None`` means ``"cuda"``); a
    tensor runs where it lies.  The buffer is not written.  ``backend`` /
    ``mesh`` / ``axis`` as in :func:`correct_batch`.
    """
    _check_backend(backend)
    if backend == "sharded" and mesh is None:
        mesh = dist_fft.default_mesh(axis)
    with tracing.span("ffcz.engine.pack"):
        if isinstance(packed, torch.Tensor):
            dev = packed.device
        else:
            dev = resolve_device(device)
            packed = torch.from_numpy(np.ascontiguousarray(packed, dtype=np.float32)).to(dev)
        n = len(counts)
        seg = _segments(counts, dev)
        E_blk, D_blk = as_bound_array(E, n, dev)[seg], as_bound_array(Delta, n, dev)[seg]
        warm = None if warm is None else torch.as_tensor(warm, device=dev).to(torch.complex64)
    res = _run_packed(packed, E_blk, D_blk, max_iters, backend, mesh, axis, fft_impl, warm)
    with tracing.span("ffcz.engine.unpack"):
        return res, _segment_stats(res, seg, n)


def correct_batch(tensors: Sequence[Any], E, Delta, block: int = 4096, max_iters: int = 50,
                  return_edits: bool = False, return_corrected: bool = True,
                  backend: str = "batched", fft_impl: str = "xla",
                  warm_freq: Optional[Sequence[Any]] = None, device=None, mesh=None, axis: str = "data"):
    """Correct a heterogeneous batch of error tensors in one batched loop.

    Args:
      tensors: arbitrary-shape real tensors (each flattened + zero-padded
        into ``block``-length pencils; padded tails are discarded on
        unpack).  Tensors run where they lie (all on one device); numpy
        arrays are copied to ``device`` (``None`` means ``"cuda"``).  Inputs
        are not written (the reference donates them; the port does not).
      E, Delta: scalar bounds, or per-tensor sequences of scalars.
      block: pencil length shared by the whole batch.
      max_iters: POCS iteration cap (shared).
      return_edits: also return, per tensor, the padded-tile edit streams
        ``(spat_edits (n_blocks, block), freq_edits (n_blocks, block//2+1))``.
      return_corrected: set False (with ``return_edits``) to skip the
        per-tensor corrected outputs.
      backend: ``"batched"``, or ``"sharded"``: the packed rows split over
        ``mesh[axis]`` (every rank of the axis calls with the same batch and
        gets the whole result), bitwise the batched backend's.
      mesh, axis: the sharded backend's ``DeviceMesh`` and axis name;
        ``mesh=None`` takes a 1-D mesh over the default process group, and
        raises ``ValueError`` when none is initialized.
      fft_impl: the loop's transform selector (``"xla"`` | ``"packed"`` |
        ``"pallas"``).
      warm_freq: optional per-tensor warm-start spectra, ``warm_freq[i]`` of
        shape ``(n_blocks_i, block//2+1)``.

    Returns ``(corrected, stats)`` — or ``(corrected, edits, stats)`` with
    ``return_edits`` — where ``corrected[i]`` has ``tensors[i]``'s shape and
    dtype and ``stats`` is a :class:`BatchCorrectionStats`.
    """
    _check_backend(backend)
    if backend == "sharded" and mesh is None:
        mesh = dist_fft.default_mesh(axis)
    n = len(tensors)
    if n == 0:
        stats = empty_stats(resolve_device(device))
        return ([], [], stats) if return_edits else ([], stats)
    dev = tensors[0].device if isinstance(tensors[0], torch.Tensor) else resolve_device(device)
    tensors = tuple(t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t)).to(dev)
                    for t in tensors)
    if warm_freq is not None and len(warm_freq) != n:
        raise ValueError(f"expected {n} per-tensor warm spectra, got {len(warm_freq)}")
    corrected, edits, stats = _correct_batch_core(
        tensors, E, Delta, block, max_iters, return_edits, return_corrected, backend, fft_impl, warm_freq,
        mesh, axis,
    )
    if return_edits:
        return corrected, edits, stats
    return corrected, stats
