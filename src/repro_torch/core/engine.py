"""CorrectionEngine: the whole-field FFCz pipeline as PLAN / EXECUTE / ENCODE.

  PLAN     resolve user bounds to absolute dual bounds on the engine's device
           (spectra only when a bound consumes them: ``Delta_abs`` needs no
           forward FFT), apply :func:`float32_bound_discipline`.
  EXECUTE  the POCS loop of :func:`repro_torch.core.pocs.alternating_projection`
           on the device, then the exact float64 polish on the host.
  ENCODE   pair-weight accounting, :func:`adaptive_quant_bits`, and
           edit-stream serialization through :mod:`repro_torch.core.edits`.

Whole fields run the loop on one device.  Pencil-tiled batches (the KV-cache,
gradient and checkpoint clients) run :mod:`repro_torch.core.blockwise` on
the ``local`` backend (one loop per tensor) or the ``batched`` backend (one
loop for the whole batch, the default).  The ``sharded`` backend raises
``NotImplementedError`` (ROADMAP.md Queue 1, slice 5).
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import host
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

_BACKENDS = ("local", "batched", "sharded")
_FFT_IMPLS = ("xla", "packed", "pallas")


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
    f-cube *after* the float64 polish.
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

    def __init__(self, engine: "CorrectionEngine", raw: AlternatingProjectionResult, plan: FieldPlan):
        self._engine = engine
        self._raw = raw
        self._plan = plan
        self._event = _record_event(raw.eps)
        self._value: Optional[FieldResult] = None
        self._exc: Optional[FFCzError] = None

    def result(self) -> FieldResult:
        if self._exc is not None:
            raise self._exc
        if self._value is None:
            try:
                self._value = self._engine._finalize_field(self._raw, self._event, self._plan)
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
    """Plan / execute / encode FFCz corrections on one device.

    Args:
      backend: ``"local"`` (one pencil loop per tensor) or ``"batched"`` (one
        loop for a whole batch; the default).  ``"sharded"`` raises
        ``NotImplementedError`` (ROADMAP.md Queue 1, slice 5).  Whole fields
        run the same loop on every backend.
      axis: the mesh axis name of the sharded backend (kept for the
        reference's signature).
      fft_impl: default POCS transform selector for the *pencil* paths
        (``"xla"`` | ``"packed"`` | ``"pallas"``); whole fields take theirs
        from ``FFCzConfig.fft_impl`` via the plan.
      device: where PLAN's spectra and EXECUTE's loop run; ``None`` means
        ``"cuda"`` and raises when there is no card (never a CPU fallback).
    """

    def __init__(self, backend: str = "batched", axis: str = "data", fft_impl: str = "xla", device=None):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if fft_impl not in _FFT_IMPLS:
            raise ValueError(f"fft_impl must be 'xla', 'packed' or 'pallas', got {fft_impl!r}")
        if backend == "sharded":
            raise NotImplementedError(
                "the 'sharded' backend is not ported to repro_torch yet (ROADMAP.md Queue 1, slice 5)"
            )
        self.backend = backend
        self.axis = axis
        self.fft_impl = fft_impl
        self.device = resolve_device(device)

    # -- PLAN --------------------------------------------------------------

    def plan_field(self, x: np.ndarray, cfg) -> FieldPlan:
        """Resolve one whole field's bounds on the device (cfg: FFCzConfig).

        The forward spectrum is computed (a float32 device rfft) only when a
        bound consumes it: ``pspec_rel`` needs the pointwise grid,
        ``Delta_rel`` needs ``max_k |X_k|``, ``Delta_abs`` needs none.
        Relative bounds resolved from the float32 spectrum can differ from
        another backend's at float32 rounding level; the blob stores the
        values it was built with and every guarantee is checked against
        those.
        """
        x32 = np.asarray(x, dtype=np.float32)
        x_dev = torch.from_numpy(np.ascontiguousarray(x32)).to(self.device)
        if cfg.pspec_rel is not None:
            X = torch.fft.rfftn(x_dev)
            grid = power_spectrum_delta_rfft(X, cfg.pspec_rel)
            gmax = float(torch.max(grid))
            if gmax <= 0:
                # grid = t*|X|/sqrt(2) with floor 0: gmax == 0 iff the field
                # is all-zero, and every Delta_k would resolve to 0
                raise InfeasibleBound(
                    f"pspec_rel={float(cfg.pspec_rel):g} on an all-zero field: every "
                    "Delta_k resolves to 0 (no spectrum to preserve); use Delta_abs "
                    "for zero fields",
                    stage="plan",
                )
            floor = torch.tensor(np.float32(gmax * cfg.pspec_floor_rel), device=self.device)
            Delta_user = torch.maximum(grid, floor).cpu().numpy()
            bounds = resolve_bounds(x_dev, E_abs=cfg.E_abs, E_rel=cfg.E_rel, Delta_abs=1.0)
            pointwise = True
        elif cfg.Delta_abs is not None:
            bounds = resolve_bounds(x_dev, E_abs=cfg.E_abs, E_rel=cfg.E_rel, Delta_abs=cfg.Delta_abs)
            Delta_user = float(bounds.Delta)
            pointwise = False
        else:
            X = torch.fft.rfftn(x_dev)
            bounds = resolve_bounds(x_dev, E_abs=cfg.E_abs, E_rel=cfg.E_rel, Delta_rel=cfg.Delta_rel, X=X)
            Delta_user = float(bounds.Delta)
            pointwise = False
        E = float(bounds.E)
        l2_norm = _host_l2_norm(x32)
        abs_max = float(torch.max(torch.abs(x_dev))) if x32.size else 0.0
        E_proj, Delta_proj, Delta, slack_f = float32_bound_discipline(
            E, Delta_user, cfg.quant_bits, l2_norm, abs_max
        )
        E_grid = E_grid_proj = None
        E_roi = getattr(cfg, "E_roi", None)
        if E_roi is not None:
            E_grid = resolve_roi_bound_grid(
                E_roi, E, tuple(x32.shape), scale=getattr(cfg, "E_roi_scale", 0.1)
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
            shape=tuple(x32.shape),
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
        self, eps0: np.ndarray, plan: FieldPlan, warm_freq: Optional[np.ndarray] = None
    ) -> FieldResult:
        """The device POCS loop + the exact float64 host polish.

        The loop runs in float32; a few exact host-side POCS iterations
        absorb the FFT round-off so the *shrunk* bounds hold in float64.
        ``warm_freq`` (complex half-spectrum, an array or a tensor) seeds the
        loop's ``freq_edits`` only when ``plan.warm_start`` is True.
        """
        return self.execute_field_async(eps0, plan, warm_freq=warm_freq).result()

    def execute_field_async(
        self, eps0: np.ndarray, plan: FieldPlan, warm_freq: Optional[np.ndarray] = None
    ) -> FieldExecuteHandle:
        """Run the POCS loop on the device; return a handle before the host
        half (fence, staging, float64 polish).  Device failures classify as
        ``execute``-stage :class:`~repro_torch.core.errors.FFCzError`s."""
        if not plan.warm_start:
            warm_freq = None  # neutrality: cold plans never see a warm state
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

    def _finalize_field(self, res: AlternatingProjectionResult, event, plan: FieldPlan) -> FieldResult:
        """The fence + host half of EXECUTE (see :meth:`execute_field_async`)."""
        try:
            if event is not None:
                event.synchronize()
            spat = res.spat_edits.cpu().numpy().astype(np.float64)
            freq = res.freq_edits.cpu().numpy().astype(np.complex128)
            eps_f = res.eps.cpu().numpy().astype(np.float64)
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
        (the ``batched`` backend); the ``local`` backend runs one loop per
        tensor.  Tensors run where they lie; numpy arrays are copied to the
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
            )
        except (RuntimeError, MemoryError) as e:
            raise classify_exception(e, "execute") from e

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
            packed, counts, pads = blockwise.pack_batch(tensors, block, out=staging)
            warm = None
            if warm_freq is not None:
                warm = np.concatenate(
                    [blockwise.to_numpy(w).astype(np.complex64) for w in warm_freq], axis=0
                )
            res, stats = blockwise.correct_packed(
                packed, counts, E, Delta, max_iters=max_iters, backend=self.backend,
                fft_impl=fft_impl, warm=warm, device=self.device,
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
