"""CorrectionEngine: the whole-field FFCz pipeline as PLAN / EXECUTE / ENCODE.

  PLAN     resolve user bounds to absolute dual bounds on the engine's device
           (spectra only when a bound consumes them: ``Delta_abs`` needs no
           forward FFT), apply :func:`float32_bound_discipline`.
  EXECUTE  the POCS loop of :func:`repro_torch.core.pocs.alternating_projection`
           on the device, then the exact float64 polish on the host.
  ENCODE   pair-weight accounting, :func:`adaptive_quant_bits`, and
           edit-stream serialization through :mod:`repro_torch.core.edits`.

Whole fields run the loop on one device, or slab-sharded over a mesh axis
when PLAN and EXECUTE are given a :class:`repro_torch.sharding.dist_fft.
ShardedField` (every rank of the axis calls them; the loop runs in ``dist``
mode and the host stages run on every rank's gathered copy).  Pencil-tiled
batches (the KV-cache, gradient and checkpoint clients) run
:mod:`repro_torch.core.blockwise` on the ``local`` backend (one loop per
tensor), the ``batched`` backend (one loop for the whole batch, the default)
or the ``sharded`` backend (the batch's rows split over a mesh axis, each
rank running the batched loop on its own rows).
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import host, tracing
from repro_torch.coding.quantize import DEFAULT_QUANT_BITS
from repro_torch.core import blockwise
from repro_torch.core.bounds import (
    power_spectrum_delta_rfft,
    resolve_bounds,
    resolve_roi_bound_grid,
)
from repro_torch.core.cubes import rfft_pair_weights
from repro_torch.core.edits import EncodedEdits, encode_edits
from repro_torch.core.errors import FFCzError, InfeasibleBound, classify_exception
from repro_torch.core.pocs import AlternatingProjectionResult, alternating_projection
from repro_torch.device import resolve_device
from repro_torch.sharding import dist_fft
from repro_torch.sharding.dist_fft import ShardedField

_BACKENDS = ("local", "batched", "sharded")
_FFT_IMPLS = ("xla", "packed", "pallas")

#: how many times this process ran each of the codec's host stages: the base
#: compressor, the float64 polish (fields and pencils), ENCODE of a field,
#: verification and a decode; read and reset like a kernel's ``launches``
host_stages = {"base": 0, "polish": 0, "encode": 0, "verify": 0, "decode": 0}


# ---------------------------------------------------------------------------
# shared guarantee math (host numpy float64, as in the reference)


def polish_pocs_float64(eps, spat, freq, E, Delta, axes=None, max_iters: int = 30, threads: int = 1):
    """Exact (float64) POCS iterations to absorb float32 FFT round-off.

    Runs on the rfft half-spectrum over ``axes`` (default: all axes), with
    ``freq`` the matching half-spectrum accumulator.  Residual violations
    after the float32 loop are O(eps32 * ||delta||_inf), orders of magnitude
    below the bounds, so this converges in a handful of iterations.

    ``threads > 1`` is for independent pencils (``axes=(1,)``, one a row,
    scalar bounds): each iteration's transforms and clips run over row
    chunks of at least 256 rows in that many threads, in lockstep, and the
    result is bitwise the one-chunk result (no row depends on another, and
    every chunk stops at the first iteration in which no row moves).
    """
    host_stages["polish"] += 1
    axes = tuple(range(eps.ndim)) if axes is None else tuple(axes)
    s = [eps.shape[a] for a in axes]
    eps, spat, freq = np.array(eps), np.array(spat), np.array(freq)
    chunks = 1
    if threads > 1:
        if axes != (1,) or eps.ndim != 2 or np.ndim(E) or np.ndim(Delta):
            raise ValueError("threads > 1 needs independent pencils: axes=(1,) and scalar bounds")
        chunks = max(1, min(threads, eps.shape[0] // 256))
    edges = np.linspace(0, eps.shape[0], chunks + 1).astype(int)
    parts = [slice(a, b) for a, b in zip(edges, edges[1:])]

    def forward(sl):
        delta = np.fft.rfftn(eps[sl], axes=axes)
        clipped = np.clip(delta.real, -Delta, Delta) + 1j * np.clip(delta.imag, -Delta, Delta)
        return delta, clipped

    def inverse(sl, delta, clipped):
        freq[sl] += clipped - delta
        eps_f = np.fft.irfftn(clipped, s=s, axes=axes)
        eps_s = np.clip(eps_f, -E, E)
        spat[sl] += eps_s - eps_f
        eps[sl] = eps_s

    with ThreadPoolExecutor(chunks) as pool:
        run = map if chunks == 1 else pool.map
        for _ in range(max_iters):
            fwd = list(run(forward, parts))
            if all(np.array_equal(clipped, delta) for delta, clipped in fwd):
                break
            list(run(lambda a: inverse(a[0], *a[1]), zip(parts, fwd)))
    return eps, spat, freq


def _sharded_range(x: ShardedField) -> Tuple[float, float]:
    """(min, max) of a sharded field's real rows, all-reduced in float32
    (exact in any order); a rank without real rows counts (+inf, -inf)."""
    s0 = x.padded_shape[0] // x.n_dev
    rows = x.local[: max(0, min(s0, x.gshape[0] - x.rank * s0))]
    inf = torch.tensor(np.inf, dtype=torch.float32, device=x.local.device)
    ext = torch.stack([torch.max(rows), -torch.min(rows)]) if rows.numel() else torch.stack([-inf, -inf])
    dist_fft.all_reduce_(ext, x.group, dist.ReduceOp.MAX)
    return -float(ext[1]), float(ext[0])


def _without_grids(plan: "FieldPlan") -> "FieldPlan":
    """``plan`` with its pointwise Delta_k and ROI grids taken out (``None``):
    what the root of a sharded plan hands the other ranks."""
    if plan.pointwise:
        plan = dataclasses.replace(plan, Delta=None, Delta_proj=None)
    if plan.E_grid is not None:
        plan = dataclasses.replace(plan, E_grid=None, E_grid_proj=None)
    return plan


def _host_l2_norm(x32: np.ndarray) -> float:
    """l2 norm feeding the cast-noise slack, as a float64 numpy pairwise sum
    on the host copy (the reference computes it the same way)."""
    if not x32.size:
        return 0.0
    x64 = np.asarray(x32, dtype=np.float64)
    return float(np.sqrt(np.sum(x64 * x64)))


def float32_bound_discipline(E, Delta, m: int, l2_norm: float, abs_max: float):
    """Shrink user bounds for quantization + float32-storage round-off.

    Reserves 2x the direct quantization term (one for the stream's own
    noise, one for the other stream's cross-domain leakage — matched by
    :func:`adaptive_quant_bits`), subtracts the absolute float32 slack
    (casting the reconstruction perturbs each frequency component by
    ~u32*l2_norm, 4-sigma statistical budget, and each point by
    u32*abs_max), and clamps Delta at 4x the frequency slack so the bound
    stays representable.  ``Delta`` may be a scalar or a pointwise grid.

    Returns ``(E_proj, Delta_proj, Delta_floored, slack_f)``.
    """
    u32 = float(np.finfo(np.float32).eps)
    shrink = 1.0 - 2.0 ** (-m) - 2.0 ** (-m)
    slack_f = 4.0 * u32 * float(l2_norm)
    slack_s = u32 * float(abs_max)
    Delta = np.maximum(Delta, 4.0 * slack_f)
    return E * shrink - slack_s, Delta * shrink - slack_f, Delta, slack_f


def adaptive_quant_bits(m: int, k_s: int, E: float, min_delta: float, sum_w_delta: float, n: int, cap: int = 48):
    """Closed-form edit-stream bit-widths covering cross-domain quant leakage.

    The base width ``m`` covers each stream's *direct* quantization term;
    the widened widths also fit the cross terms inside the same reserved
    margin: ``k_s`` quantized spatial edits perturb every frequency
    component by up to ``k_s * E * 2^-m_s`` after the FFT (kept under
    ``min_delta * 2^-m``), and the active frequency edits — ``sum_w_delta``
    being their conjugate-pair-weighted Delta sum — perturb every spatial
    point by up to ``(sqrt2/n) * sum_w_delta * 2^-m_f`` after the IFFT
    (kept under ``E * 2^-m``).
    """
    m_s = m
    if k_s > 0 and min_delta > 0 and E > 0:
        m_s = m + max(0, int(np.ceil(np.log2(max(k_s * E / min_delta, 1.0)))))
    m_f = m
    if sum_w_delta > 0 and E > 0 and n > 0:
        ratio = np.sqrt(2.0) * sum_w_delta / (n * E)
        m_f = m + max(0, int(np.ceil(np.log2(max(ratio, 1.0)))))
    return min(m_s, cap), min(m_f, cap)


# ---------------------------------------------------------------------------
# plan and result objects


@dataclasses.dataclass(frozen=True)
class FieldPlan:
    """PLAN-stage output for one whole-field correction.

    ``Delta`` is the representability-floored bound the edits are encoded
    against (scalar, or a float32 half-spectrum ``Delta_k`` grid in
    ``pspec`` mode); ``E_proj``/``Delta_proj`` are the shrunk bounds the
    projection runs with (see :func:`float32_bound_discipline`).  Field
    names and meanings are the reference's, so a reference plan converts
    one to one (:func:`repro_torch.convert.plan_from_reference`).
    """

    shape: Tuple[int, ...]
    E: float
    Delta: Union[float, np.ndarray]
    E_proj: float
    Delta_proj: Union[float, np.ndarray]
    slack_f: float
    pointwise: bool
    quant_bits: int
    max_iters: int
    relax: float
    use_kernels: bool
    codec: str
    fft_impl: str = "xla"
    check_every: int = 1
    warm_start: bool = False
    # ROI bounds: per-point float32 spatial bound grid and its disciplined
    # projection twin, or None for uniform E
    E_grid: Optional[np.ndarray] = None
    E_grid_proj: Optional[np.ndarray] = None

    @property
    def roi(self) -> bool:
        """True when the plan carries a per-point spatial bound grid."""
        return self.E_grid is not None

    @property
    def delta_scalar(self) -> float:
        """Scalar Delta for the blob header (nan when pointwise)."""
        return float("nan") if self.pointwise else float(self.Delta)

    def pointwise_bytes(self) -> Optional[bytes]:
        """float32 half-spectrum Delta_k grid for the blob, or None."""
        if not self.pointwise:
            return None
        return np.asarray(self.Delta, dtype=np.float32).tobytes()

    def roi_bytes(self) -> Optional[bytes]:
        """float32 spatial E_n grid for the blob's FFCR section, or None."""
        if self.E_grid is None:
            return None
        return np.asarray(self.E_grid, dtype=np.float32).tobytes()


@dataclasses.dataclass(frozen=True)
class PencilPlan:
    """PLAN-stage output for one tensor's pencil-tiled correction.

    The frequency bound applies to each ``block``-length pencil's local
    rfft spectrum: ``Delta = Delta_rel * max_k |RFFT(pencil of x)_k|``.
    """

    block: int
    quant_bits: int
    E: float
    Delta: float
    E_proj: float
    Delta_proj: float


@dataclasses.dataclass
class FieldResult:
    """EXECUTE-stage output: float64-exact loop state ready to encode.

    When ``converged`` is False, ``final_violations`` is the pair-weighted
    full-spectrum count of frequency components still outside the (shrunk)
    f-cube *after* the float64 polish.  A sharded field's result holds the
    arrays and the count on its root only (``None`` on the other ranks).
    """

    eps: np.ndarray  # final error vector (float64, inside the s-cube)
    spat: np.ndarray  # spatial edit accumulator (float64)
    freq: np.ndarray  # frequency edit accumulator (complex128, rfft layout)
    iterations: int
    converged: bool
    final_violations: int = 0


class FieldExecuteHandle:
    """One in-flight whole-field EXECUTE; ``result()`` fences and polishes.

    The fence is a CUDA event recorded on the loop's stream after its last
    launch (nothing to wait for on the CPU).  ``result()`` is idempotent and
    caches the finalized :class:`FieldResult` or the classified error.
    """

    def __init__(self, engine: "CorrectionEngine", raw: AlternatingProjectionResult, plan: FieldPlan,
                 field: Optional[ShardedField] = None):
        self._engine = engine
        self._raw = raw
        self._plan = plan
        self._field = field  # the ShardedField when sharded, else None
        self._event = _record_event(raw.eps)
        self._value: Optional[FieldResult] = None
        self._exc: Optional[FFCzError] = None

    def result(self) -> FieldResult:
        if self._exc is not None:
            raise self._exc
        if self._value is None:
            try:
                self._value = self._engine._finalize_field(self._raw, self._event, self._plan, self._field)
            except FFCzError as err:
                self._exc = err
                raise
            finally:
                self._raw = self._event = None
        return self._value


def _spec(t) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, torch dtype) of a tensor or an array."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), t.dtype
    a = np.asarray(t)
    return a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype


def _record_event(t: torch.Tensor):
    """A CUDA event recorded on ``t``'s current stream, or None on the CPU."""
    if t.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


class PencilBatchHandle:
    """One in-flight pencil EXECUTE over a packed ``(B, block)`` buffer.

    ``result()`` fences on a CUDA event recorded after the loop's last launch
    and returns the same ``(corrected, edits, stats)`` (or ``(corrected,
    stats)``) tuple :meth:`CorrectionEngine.correct` produces, with
    per-tensor slices of the packed outputs.  Idempotent, like
    :class:`FieldExecuteHandle`; failures re-raise classified.
    """

    def __init__(self, raw, stats, specs, counts, pads, return_edits, return_corrected):
        self._raw = raw
        self._stats = stats
        self._specs = specs  # [(shape, torch dtype)] per tensor
        self._counts = counts
        self._pads = pads
        self._return_edits = return_edits
        self._return_corrected = return_corrected
        self._event = _record_event(raw.eps)
        self._value = None
        self._exc: Optional[FFCzError] = None

    def result(self):
        if self._exc is not None:
            raise self._exc
        if self._value is None:
            try:
                if self._event is not None:
                    self._event.synchronize()
                res, corrected, edits = self._raw, [], []
                offset = 0
                for (shape, dtype), nb, pad in zip(self._specs, self._counts, self._pads):
                    sl = slice(offset, offset + nb)
                    if self._return_corrected:
                        corrected.append(blockwise.untile_1d(res.eps[sl], shape, pad).to(dtype))
                    if self._return_edits:
                        edits.append((res.spat_edits[sl], res.freq_edits[sl]))
                    offset += nb
                if self._return_edits:
                    self._value = (corrected, edits, self._stats)
                else:
                    self._value = (corrected, self._stats)
            except (RuntimeError, MemoryError) as e:
                self._exc = classify_exception(e, "execute")
                raise self._exc from e
            finally:
                self._raw = self._event = None
        return self._value


class _FenceHandle:
    """Handle over already-structured outputs: ``result()`` is the event
    fence.  Used by the ``local`` backend, whose loops run eagerly."""

    def __init__(self, value, device):
        self._value = value
        self._event = None
        if torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def result(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._value


# ---------------------------------------------------------------------------
# the engine


class CorrectionEngine:
    """Plan / execute / encode FFCz corrections.

    Args:
      backend: ``"local"`` (one pencil loop per tensor), ``"batched"`` (one
        loop for a whole batch; the default) or ``"sharded"`` (the batch's
        rows split over ``mesh[axis]``, each rank running the batched loop
        on its rows; every rank of the axis calls :meth:`correct` with the
        same batch).  Whole fields run the same loop on every backend; a
        :class:`~repro_torch.sharding.dist_fft.ShardedField` runs it sharded.
      axis: the mesh axis the sharded backend splits the batch over.
      fft_impl: default POCS transform selector for the *pencil* paths
        (``"xla"`` | ``"packed"`` | ``"pallas"``); whole fields take theirs
        from ``FFCzConfig.fft_impl`` via the plan.
      device: where PLAN's spectra and EXECUTE's loop run; ``None`` means
        the mesh's device when a ``mesh`` is given, else ``"cuda"``, and
        raises when there is no card (never a CPU fallback).
      mesh: the sharded backend's ``DeviceMesh``; ``None`` builds a 1-D mesh
        over the default process group on first use
        (:func:`repro_torch.sharding.dist_fft.default_mesh`), which raises
        ``ValueError`` when no group is initialized.
    """

    def __init__(self, backend: str = "batched", axis: str = "data", fft_impl: str = "xla", device=None,
                 mesh=None):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if fft_impl not in _FFT_IMPLS:
            raise ValueError(f"fft_impl must be 'xla', 'packed' or 'pallas', got {fft_impl!r}")
        self.backend = backend
        self.axis = axis
        self.fft_impl = fft_impl
        if device is None and mesh is not None:
            device = dist_fft.mesh_device(mesh)
        self.device = resolve_device(device)
        self._mesh = mesh

    @property
    def mesh(self):
        """The sharded backend's mesh (built over the default group on
        first use when none was given)."""
        if self._mesh is None:
            self._mesh = dist_fft.default_mesh(self.axis)
        return self._mesh

    # -- PLAN --------------------------------------------------------------

    def plan_field(self, x: Union[np.ndarray, ShardedField], cfg) -> FieldPlan:
        """Resolve one whole field's bounds on the device (cfg: FFCzConfig).

        The forward spectrum is computed (a float32 device rfft) only when a
        bound consumes it: ``pspec_rel`` needs the pointwise grid,
        ``Delta_rel`` needs ``max_k |X_k|``, ``Delta_abs`` needs none.
        Relative bounds resolved from the float32 spectrum can differ from
        another backend's at float32 rounding level; the blob stores the
        values it was built with and every guarantee is checked against
        those.

        A :class:`~repro_torch.sharding.dist_fft.ShardedField` (a collective
        call) keeps the spectrum sharded: the forward transform is
        :func:`~repro_torch.sharding.dist_fft.pencil_rfftn`; minima and
        maxima (the ``E_rel`` range, ``max |x|``, ``max |X_k|``) are
        all-reduced in float32, exact in any order; the float64 norm keeps
        its summation order on the root's gathered host copy, and the
        ``pspec`` and ROI grids are built on the root.  The root then hands
        every rank the plan's scalars (or the :class:`InfeasibleBound` it
        raised): the other ranks' plans carry ``None`` where the root's
        carry a grid, and the loop scatters each rank its block of those.
        The root's plan is the same at every world size.
        """
        sharded = isinstance(x, ShardedField)
        E_abs, E_rel = cfg.E_abs, cfg.E_rel
        if sharded:
            x32, x_dev = x.to_root(), x.local  # x32: None off the root
            if E_abs is None and E_rel is not None:
                # over the real rows only (the slab-pad rows are zero and
                # would enter the min): float32 max and min are exact in any
                # order, so the float32 subtract and multiply give the
                # single-device resolution's value exactly
                lo, hi = _sharded_range(x)
                rng32 = np.float32(hi) - np.float32(lo)
                if float(rng32) == 0.0:
                    raise InfeasibleBound(
                        f"E_rel={float(cfg.E_rel):g} on a constant field: range(x) == 0 "
                        "resolves the spatial bound to E = 0 (an empty s-cube); pass "
                        "E_abs for constant fields",
                        stage="plan",
                    )
                E_abs, E_rel = np.float32(cfg.E_rel) * np.float32(rng32), None
        else:
            x32 = np.asarray(x, dtype=np.float32)
            x_dev = torch.from_numpy(np.ascontiguousarray(x32)).to(self.device)

        def spectrum():
            return dist_fft.pencil_rfftn(x) if sharded else torch.fft.rfftn(x_dev)

        def field_max(t):
            m = torch.max(t).reshape(1)
            return (dist_fft.all_reduce_(m, x.group, dist.ReduceOp.MAX) if sharded else m)[0]

        if cfg.pspec_rel is not None:
            X = spectrum()
            # a sharded spectrum's DC component is on rank 0's block only
            grid = power_spectrum_delta_rfft(X, cfg.pspec_rel, has_dc=not sharded or x.rank == 0)
            gmax = float(field_max(grid))
            if gmax <= 0:
                # grid = t*|X|/sqrt(2) with floor 0: gmax == 0 iff the field
                # is all-zero, and every Delta_k would resolve to 0
                raise InfeasibleBound(
                    f"pspec_rel={float(cfg.pspec_rel):g} on an all-zero field: every "
                    "Delta_k resolves to 0 (no spectrum to preserve); use Delta_abs "
                    "for zero fields",
                    stage="plan",
                )
            floor = torch.tensor(np.float32(gmax * cfg.pspec_floor_rel), device=grid.device)
            Delta_user = torch.maximum(grid, floor)
            Delta_user = x.freq_to_root(Delta_user) if sharded else Delta_user.cpu().numpy()
            bounds = resolve_bounds(x_dev, E_abs=E_abs, E_rel=E_rel, Delta_abs=1.0)
            pointwise = True
        elif cfg.Delta_abs is not None:
            bounds = resolve_bounds(x_dev, E_abs=E_abs, E_rel=E_rel, Delta_abs=cfg.Delta_abs)
            Delta_user = float(bounds.Delta)
            pointwise = False
        else:
            X = spectrum()
            if sharded:
                X = field_max(torch.abs(X)).reshape(1)  # resolve_bounds reads only max |X_k|
            bounds = resolve_bounds(x_dev, E_abs=E_abs, E_rel=E_rel, Delta_rel=cfg.Delta_rel, X=X)
            Delta_user = float(bounds.Delta)
            pointwise = False
        E = float(bounds.E)
        if not sharded:
            l2_norm = _host_l2_norm(x32)
            abs_max = float(torch.max(torch.abs(x_dev))) if x32.size else 0.0
            return self._plan_host(cfg, E, Delta_user, pointwise, x32.shape, l2_norm, abs_max)
        # max |x| over the slabs (pad rows are zero); the root's plan or error
        abs_max = float(field_max(torch.abs(x_dev))) if x_dev.numel() else 0.0
        outcome = None
        if x.is_root:
            try:
                outcome = self._plan_host(cfg, E, Delta_user, pointwise, x32.shape, _host_l2_norm(x32), abs_max)
            except InfeasibleBound as e:
                outcome = e
        scalars = dist_fft.root_outcome(
            _without_grids(outcome) if isinstance(outcome, FieldPlan) else outcome, x.group)
        return outcome if x.is_root else scalars

    @staticmethod
    def _plan_host(cfg, E: float, Delta_user, pointwise: bool, shape, l2_norm: float,
                   abs_max: float) -> FieldPlan:
        """PLAN's host half: the float32 discipline, the ROI grid and the
        representability checks."""
        E_proj, Delta_proj, Delta, slack_f = float32_bound_discipline(
            E, Delta_user, cfg.quant_bits, l2_norm, abs_max
        )
        E_grid = E_grid_proj = None
        E_roi = getattr(cfg, "E_roi", None)
        if E_roi is not None:
            E_grid = resolve_roi_bound_grid(
                E_roi, E, tuple(shape), scale=getattr(cfg, "E_roi_scale", 0.1)
            )
            E_grid_proj, _, _, _ = float32_bound_discipline(
                E_grid, Delta_user, cfg.quant_bits, l2_norm, abs_max
            )
            E_grid_proj = np.asarray(E_grid_proj, dtype=np.float32)
            if float(np.min(E_grid_proj)) <= 0:
                raise InfeasibleBound(
                    f"tightest ROI bound E_n={float(np.min(E_grid)):g} below float32 "
                    "representability for this data",
                    stage="plan",
                )
        if not pointwise:
            Delta_proj = float(Delta_proj)
            Delta = float(Delta)
        if E_proj <= 0:
            raise InfeasibleBound(
                f"spatial bound E={E:g} below float32 representability for this data",
                stage="plan",
            )
        if float(np.min(Delta_proj)) <= 0:
            raise InfeasibleBound(
                f"frequency bound Delta={float(np.min(np.asarray(Delta_user))):g} below float32 "
                f"representability after the quantization shrink (quant_bits={cfg.quant_bits})",
                stage="plan",
            )
        return FieldPlan(
            shape=tuple(shape),
            E=E,
            Delta=Delta,
            E_proj=float(E_proj),
            Delta_proj=Delta_proj,
            slack_f=float(slack_f),
            pointwise=pointwise,
            quant_bits=cfg.quant_bits,
            max_iters=cfg.max_iters,
            relax=cfg.relax,
            use_kernels=cfg.use_kernels,
            codec=cfg.codec,
            fft_impl=getattr(cfg, "fft_impl", "xla"),
            check_every=getattr(cfg, "check_every", 1),
            warm_start=getattr(cfg, "warm_start", False),
            E_grid=E_grid,
            E_grid_proj=E_grid_proj,
        )

    def plan_pencils(
        self,
        x32: np.ndarray,
        *,
        E_rel: Optional[float] = None,
        Delta_rel: Optional[float] = None,
        block: int,
        quant_bits: int = DEFAULT_QUANT_BITS,
        E_abs: Optional[float] = None,
        Delta_abs: Optional[float] = None,
        E_roi=None,
        E_roi_scale: float = 0.1,
    ) -> Optional[PencilPlan]:
        """Resolve one tensor's pencil-tiled bounds; None if E underflows.

        Host float64 (``np.fft.rfft``), as in the reference: the per-pencil
        ``Delta`` is the published guarantee other tools recompute exactly.
        The cast-noise slack uses per-pencil norms.  ``E_abs``/``Delta_abs``
        override the relative resolution (each independently); ``E_roi``
        collapses to the tightest resolved bound (pencil tiling scrambles
        spatial adjacency).
        """
        flat = x32.reshape(-1)
        tiles = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
        if E_abs is not None:
            E = float(E_abs)
        else:
            if E_rel is None:
                raise ValueError("plan_pencils needs E_rel or E_abs")
            E = E_rel * float(np.ptp(x32))
        if E_roi is not None:
            grid = resolve_roi_bound_grid(E_roi, E, tuple(x32.shape), scale=E_roi_scale)
            E = float(np.min(grid))
        if Delta_abs is not None:
            Delta = float(Delta_abs)
        else:
            if Delta_rel is None:
                raise ValueError("plan_pencils needs Delta_rel or Delta_abs")
            Delta = Delta_rel * float(np.abs(np.fft.rfft(tiles, axis=-1)).max())
        E_proj, Delta_proj, Delta, _slack_f = float32_bound_discipline(
            E,
            Delta,
            quant_bits,
            np.sqrt((tiles.astype(np.float64) ** 2).sum(axis=-1).max()),
            np.max(np.abs(x32)) if x32.size else 0.0,
        )
        if E_proj <= 0:
            return None
        return PencilPlan(
            block=block,
            quant_bits=quant_bits,
            E=E,
            Delta=float(Delta),
            E_proj=float(E_proj),
            Delta_proj=float(Delta_proj),
        )

    @staticmethod
    def tile_f64(eps0: np.ndarray, block: int) -> np.ndarray:
        """Float64 (n_blocks, block) tiling of an error tensor — the exact
        loop state the pencil polish rebuilds from."""
        flat = np.asarray(eps0, dtype=np.float64).reshape(-1)
        return np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)

    # -- EXECUTE -----------------------------------------------------------

    def execute_field(
        self, eps0: Union[np.ndarray, ShardedField], plan: FieldPlan, warm_freq: Optional[np.ndarray] = None
    ) -> FieldResult:
        """The device POCS loop + the exact float64 host polish.

        The loop runs in float32; a few exact host-side POCS iterations
        absorb the FFT round-off so the *shrunk* bounds hold in float64.
        ``warm_freq`` (complex half-spectrum, an array or a tensor) seeds the
        loop's ``freq_edits`` only when ``plan.warm_start`` is True.

        A :class:`~repro_torch.sharding.dist_fft.ShardedField` ``eps0`` (a
        collective call) runs the loop in ``dist`` mode on every rank's slab;
        the loop state is gathered, unpadded, to the root's host for the
        polish, which the root alone runs.  The root's result is bitwise the
        same at every world size; the other ranks' carry the iterations and
        convergence, with ``eps``, ``spat``, ``freq`` and
        ``final_violations`` ``None``.  Only the root's ``plan`` grids and
        ``warm_freq`` are read.
        """
        return self.execute_field_async(eps0, plan, warm_freq=warm_freq).result()

    def execute_field_async(
        self, eps0: Union[np.ndarray, ShardedField], plan: FieldPlan, warm_freq: Optional[np.ndarray] = None
    ) -> FieldExecuteHandle:
        """Run the POCS loop on the device; return a handle before the host
        half (fence, staging, float64 polish).  Device failures classify as
        ``execute``-stage :class:`~repro_torch.core.errors.FFCzError`s."""
        if not plan.warm_start:
            warm_freq = None  # neutrality: cold plans never see a warm state
        if isinstance(eps0, ShardedField):
            self._check_sharded_field(eps0, plan)
            try:
                res = self._pocs_field_sharded(eps0, plan, warm_freq)
            except (RuntimeError, MemoryError) as e:
                raise classify_exception(e, "execute") from e
            return FieldExecuteHandle(self, res, plan, eps0)
        try:
            E_op = (
                plan.E_proj
                if plan.E_grid_proj is None
                else torch.from_numpy(np.ascontiguousarray(plan.E_grid_proj, dtype=np.float32)).to(self.device)
            )
            if plan.pointwise:
                Delta_op = torch.from_numpy(np.ascontiguousarray(plan.Delta_proj, dtype=np.float32)).to(self.device)
            else:
                Delta_op = plan.Delta_proj
            eps_dev = torch.from_numpy(np.ascontiguousarray(eps0, dtype=np.float32)).to(self.device)
            res = alternating_projection(
                eps_dev,
                E_op,
                Delta_op,
                max_iters=plan.max_iters,
                use_kernels=plan.use_kernels,
                relax=plan.relax,
                check_slack=0.5 * plan.slack_f,
                fft_impl=plan.fft_impl,
                check_every=plan.check_every,
                warm_freq=warm_freq,  # the loop moves it to its device and dtype
            )
        except (RuntimeError, MemoryError) as e:
            # device dispatch / allocation failures carry stage + disposition
            # (OOM -> "bisect") so callers can act without string-matching
            raise classify_exception(e, "execute") from e
        return FieldExecuteHandle(self, res, plan)

    @staticmethod
    def _check_sharded_field(eps0: ShardedField, plan: FieldPlan) -> None:
        """What the sharded whole-field loop refuses, as the reference does."""
        if plan.use_kernels:
            raise ValueError("use_kernels is not supported for sharded whole fields")
        if plan.fft_impl == "pallas":
            raise ValueError(
                "fft_impl='pallas' is not supported for sharded whole fields "
                "(the fused epilogues assume the whole spectrum; use 'packed')"
            )

    def _pocs_field_sharded(self, eps0: ShardedField, plan: FieldPlan, warm_freq=None):
        """The whole-field POCS loop in ``dist`` mode on this rank's slab.

        The root's pointwise Delta grid, ROI grid and warm spectrum (the
        other ranks' are not read) are rounded to float32 on its host (the
        single-device path's rounding), padded to the gathered layout and
        scattered, each rank its block; the ROI grid's pad rows carry the
        (positive) background bound, so the zero pad rows stay zero through
        the clip.  The root says first which of the ROI grid and the warm
        spectrum it has.
        """
        root = eps0.is_root
        has_roi, has_warm = dist_fft.broadcast_from_root(
            (plan.E_grid_proj is not None, warm_freq is not None) if root else None, eps0.group)
        if plan.pointwise:
            delta_op = eps0.scatter_freq(plan.Delta_proj if root else None)
        else:
            delta_op = plan.Delta_proj
        if has_roi:
            e_op = eps0.scatter_spatial(plan.E_grid_proj if root else None, fill=np.float32(plan.E_proj))
        else:
            e_op = plan.E_proj
        warm_op = None
        if has_warm:
            warm = None
            if root:
                warm = warm_freq.detach().cpu().numpy() if isinstance(warm_freq, torch.Tensor) else warm_freq
                warm = np.asarray(warm, dtype=np.complex64)
            warm_op = eps0.scatter_freq(warm, torch.complex64)
        return alternating_projection(
            eps0.local,
            e_op,
            delta_op,
            max_iters=plan.max_iters,
            relax=plan.relax,
            check_slack=0.5 * plan.slack_f,
            dist=eps0.dist_spec,
            fft_impl=plan.fft_impl,
            check_every=plan.check_every,
            warm_freq=warm_op,
        )

    def _finalize_field(self, res: AlternatingProjectionResult, event, plan: FieldPlan,
                        field: Optional[ShardedField] = None) -> FieldResult:
        """The fence + host half of EXECUTE (see :meth:`execute_field_async`)."""
        try:
            if event is not None:
                event.synchronize()
            spat, freq, eps_f = res.spat_edits, res.freq_edits, res.eps
            if field is not None:
                # every rank's slab on the root's host, one slab at a time,
                # with the pad sliced away: the single-device shapes and
                # values (a collective call); the root alone polishes
                spat = field.spatial_to_root(spat, np.float64)
                eps_f = field.spatial_to_root(eps_f, np.float64)
                freq = field.freq_to_root(freq, np.complex128)
                if not field.is_root:
                    return FieldResult(eps=None, spat=None, freq=None, iterations=int(res.iterations),
                                       converged=bool(res.converged), final_violations=None)
            else:
                spat = spat.cpu().numpy().astype(np.float64)
                freq = freq.cpu().numpy().astype(np.complex128)
                eps_f = eps_f.cpu().numpy().astype(np.float64)
        except (RuntimeError, MemoryError) as e:
            # an asynchronous device failure surfaces at the fence
            raise classify_exception(e, "execute") from e
        E_pol = (
            plan.E_proj
            if plan.E_grid_proj is None
            else np.asarray(plan.E_grid_proj, dtype=np.float64)
        )
        eps_f, spat, freq = polish_pocs_float64(
            eps_f, spat, freq, E_pol, np.asarray(plan.Delta_proj, dtype=np.float64)
        )
        converged = bool(res.converged)
        final_violations = 0
        if not converged:
            # exact post-polish count, pair-weighted (full-spectrum semantics)
            d = np.fft.rfftn(eps_f)
            tol = np.asarray(plan.Delta_proj, dtype=np.float64)
            bad = (np.abs(d.real) > tol) | (np.abs(d.imag) > tol)
            w = np.broadcast_to(rfft_pair_weights(plan.shape).numpy(), bad.shape)
            final_violations = int(np.sum(w * bad))
        return FieldResult(
            eps=eps_f,
            spat=spat,
            freq=freq,
            iterations=int(res.iterations),
            converged=converged,
            final_violations=final_violations,
        )

    def _on_device(self, t):
        """A torch tensor as is, an array copied to the engine's device."""
        if isinstance(t, torch.Tensor):
            return t
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    @tracing.traced("ffcz.engine.correct")
    def correct(
        self,
        tensors: Sequence[Any],
        E,
        Delta,
        block: int = 4096,
        max_iters: int = 50,
        return_edits: bool = False,
        return_corrected: bool = True,
        fft_impl: Optional[str] = None,
        warm_freq: Optional[Sequence[Any]] = None,
    ):
        """Pencil-tiled correction of a heterogeneous batch on this backend.

        Same contract as :func:`repro_torch.core.blockwise.correct_batch`
        (the ``batched`` and ``sharded`` backends); the ``local`` backend runs
        one loop per tensor.  Tensors run where they lie; numpy arrays are copied to the
        engine's device.  ``fft_impl`` overrides the engine default for this
        call; ``warm_freq`` optionally seeds each tensor's blocks with prior
        edit spectra (``(n_blocks_i, block//2+1)`` per tensor).
        """
        fft_impl = self.fft_impl if fft_impl is None else fft_impl
        tensors = [self._on_device(t) for t in tensors]
        try:
            if self.backend == "local":
                return self._correct_local(
                    tensors, E, Delta, block, max_iters, return_edits, return_corrected,
                    fft_impl, warm_freq,
                )
            return blockwise.correct_batch(
                tensors,
                E,
                Delta,
                block=block,
                max_iters=max_iters,
                return_edits=return_edits,
                return_corrected=return_corrected,
                backend=self.backend,
                fft_impl=fft_impl,
                warm_freq=warm_freq,
                device=self.device,
                mesh=self.mesh if self.backend == "sharded" else None,
                axis=self.axis,
            )
        except (RuntimeError, MemoryError) as e:
            raise classify_exception(e, "execute") from e

    @tracing.traced("ffcz.engine.correct")
    def correct_async(
        self,
        tensors: Sequence[Any],
        E,
        Delta,
        block: int = 4096,
        max_iters: int = 50,
        return_edits: bool = False,
        return_corrected: bool = True,
        fft_impl: Optional[str] = None,
        staging: Optional[np.ndarray] = None,
        warm_freq: Optional[Sequence[Any]] = None,
    ):
        """Run a pencil-batch correction; return a handle before the fence.

        The async twin of :meth:`correct`: the batch is packed on the host
        (:func:`repro_torch.core.blockwise.pack_batch`; ``staging``
        optionally reuses a caller-cached ``(B, block)`` buffer), copied to
        the engine's device and corrected by the same batched loop as
        :meth:`correct`, so results are interchangeable.  The loop reads its
        convergence counts back to the host, so the launches are all issued
        when this returns; the handle's ``result()`` fences on a CUDA event
        and slices per tensor.
        """
        fft_impl = self.fft_impl if fft_impl is None else fft_impl
        if len(tensors) == 0:
            empty = blockwise.empty_stats(self.device)
            return _FenceHandle(([], [], empty) if return_edits else ([], empty), self.device)
        if self.backend == "local":
            try:
                return _FenceHandle(
                    self._correct_local(
                        [self._on_device(t) for t in tensors], E, Delta, block, max_iters,
                        return_edits, return_corrected, fft_impl, warm_freq,
                    ),
                    self.device,
                )
            except (RuntimeError, MemoryError) as e:
                raise classify_exception(e, "execute") from e
        specs = [_spec(t) for t in tensors]
        try:
            with tracing.span("ffcz.engine.pack"):
                packed, counts, pads = blockwise.pack_batch(tensors, block, out=staging)
            warm = None
            if warm_freq is not None:
                warm = np.concatenate(
                    [blockwise.to_numpy(w).astype(np.complex64) for w in warm_freq], axis=0
                )
            res, stats = blockwise.correct_packed(
                packed, counts, E, Delta, max_iters=max_iters, backend=self.backend,
                fft_impl=fft_impl, warm=warm, device=self.device,
                mesh=self.mesh if self.backend == "sharded" else None, axis=self.axis,
            )
        except (RuntimeError, MemoryError) as e:
            raise classify_exception(e, "execute") from e
        return PencilBatchHandle(res, stats, specs, counts, pads, return_edits, return_corrected)

    def _correct_local(
        self, tensors, E, Delta, block, max_iters, return_edits, return_corrected,
        fft_impl="xla", warm_freq=None,
    ):
        """One loop per tensor.  Bounds go through the same resolver as the
        batched backend so the scalar-vs-per-tensor contract cannot
        diverge."""
        n = len(tensors)
        dev = tensors[0].device if n else self.device
        Es = blockwise.as_bound_array(E, n, dev)
        Ds = blockwise.as_bound_array(Delta, n, dev)
        warms = [None] * n if warm_freq is None else list(warm_freq)
        if len(warms) != n:
            raise ValueError(f"expected {n} per-tensor warm spectra, got {len(warms)}")
        corrected, edits, it_blocks, conv_blocks, it_t, conv_t = [], [], [], [], [], []
        for t, e, d, w in zip(tensors, Es, Ds, warms):
            corr, spat, freq, iters, conv = blockwise.blockwise_correct_with_edits(
                t, e, d, block=block, max_iters=max_iters, fft_impl=fft_impl,
                warm=None if w is None else torch.as_tensor(w, device=t.device),
            )
            if return_corrected:
                corrected.append(corr.to(t.dtype))
            if return_edits:
                edits.append((spat, freq))
            it_blocks.append(iters)
            conv_blocks.append(conv)
            it_t.append(torch.max(iters))
            conv_t.append(torch.all(conv))
        if n:
            stats = blockwise.BatchCorrectionStats(
                iterations=torch.stack(it_t),
                converged=torch.stack(conv_t),
                block_iterations=torch.cat(it_blocks),
                block_converged=torch.cat(conv_blocks),
            )
        else:
            stats = blockwise.empty_stats(dev)
        if return_edits:
            return corrected, edits, stats
        return corrected, stats

    # -- ENCODE ------------------------------------------------------------

    def encode_field(self, result: FieldResult, plan: FieldPlan) -> Tuple[EncodedEdits, EncodedEdits]:
        """Serialize a whole field's edit streams with adaptive bit-widths.

        K_s and the active pair-weighted Delta sum are known exactly
        post-projection, so the widths come from the closed form in
        :func:`adaptive_quant_bits`.  The Delta sum runs over the *full*
        spectrum, so each active half-spectrum edit contributes with its
        conjugate-pair multiplicity.
        """
        host_stages["encode"] += 1
        k_s = int(np.count_nonzero(result.spat))
        pair_w = np.broadcast_to(rfft_pair_weights(plan.shape).numpy(), result.freq.shape)
        delta_b = np.broadcast_to(np.asarray(plan.Delta), result.freq.shape)
        sum_active_delta = float(np.sum((pair_w * delta_b)[result.freq != 0]))
        n = int(np.prod(plan.shape)) if plan.shape else 1
        m_s, m_f = adaptive_quant_bits(
            plan.quant_bits,
            k_s,
            plan.E,
            float(np.min(plan.Delta)),
            sum_active_delta,
            n,
        )
        if plan.roi:
            # per-point spatial bounds: m_f must keep the IFFT leakage of the
            # frequency stream under the tightest point's reserved margin
            _, m_f = adaptive_quant_bits(
                plan.quant_bits,
                k_s,
                float(np.min(plan.E_grid)),
                float(np.min(plan.Delta)),
                sum_active_delta,
                n,
            )
        try:
            se = encode_edits(
                result.spat, plan.E_grid if plan.roi else plan.E, m=m_s, codec=plan.codec
            )
            fe = encode_edits(result.freq, plan.Delta, m=m_f, codec=plan.codec, half_spectrum=True)
        except (RuntimeError, MemoryError, OSError) as e:
            raise classify_exception(e, "encode") from e
        return se, fe

    def encode_pencils(
        self,
        spat_t: Any,
        freq_t: Any,
        tiles0: np.ndarray,
        plan: PencilPlan,
        codec: str = "zlib",
    ) -> Tuple[EncodedEdits, EncodedEdits]:
        """Polish + serialize one tensor's pencil edit streams.

        ``spat_t``/``freq_t`` are the edit tiles from :meth:`correct`
        (tensors on any device, or arrays); ``tiles0`` the float64 tiling of
        the *initial* error (:meth:`tile_f64`).  The float64 polish reruns
        on the reconstructed loop state on the host, then adaptive
        bit-widths are chosen per worst-case pencil.
        """
        spat = blockwise.to_numpy(spat_t).astype(np.float64)
        freq = blockwise.to_numpy(freq_t).astype(np.complex128)
        eps_now = tiles0 + np.fft.irfft(freq, n=plan.block, axis=-1) + spat
        _eps, spat, freq = polish_pocs_float64(
            eps_now, spat, freq, plan.E_proj, plan.Delta_proj, axes=(1,), threads=host.THREADS
        )
        pair_w = rfft_pair_weights((plan.block,)).numpy().reshape(-1)
        k_s_max = int(np.count_nonzero(spat, axis=1).max()) if spat.size else 0
        wsum_max = float(((freq != 0) * pair_w).sum(axis=1).max()) if freq.size else 0.0
        m_s, m_f = adaptive_quant_bits(
            plan.quant_bits, k_s_max, plan.E, plan.Delta, wsum_max * plan.Delta, plan.block, cap=40
        )
        try:
            se = encode_edits(spat, plan.E, m=m_s, codec=codec)
            fe = encode_edits(freq, plan.Delta, m=m_f, codec=codec, half_spectrum=True)
        except (RuntimeError, MemoryError, OSError) as e:
            raise classify_exception(e, "encode") from e
        return se, fe


@functools.lru_cache(maxsize=None)
def _default_engine(device: torch.device) -> CorrectionEngine:
    return CorrectionEngine(backend="batched", device=device)


def default_engine(device=None) -> CorrectionEngine:
    """Process-wide batched engine the framework integrations share, one per
    device; ``None`` means ``"cuda"`` (and raises without a card)."""
    return _default_engine(resolve_device(device))
