"""Alternating projection-correction (paper Alg. 1) as a host-driven loop.

The paper's CUDA pipeline launches per-iteration kernels from the host
(cuFFT -> CheckConvergence -> ProjectOntoFCube -> cuFFT -> ProjectOntoSCube)
and synchronises on the convergence flag.  This module is that loop in
PyTorch: a Python ``while`` whose body enqueues cuFFT calls (``torch.fft``)
and the fused kernels of :mod:`repro_torch.kernels` on the current stream.
The host reads the violation count back only on the iterations that check
convergence (every ``check_every``-th and the last), so between checks the
body never waits for the device.

Semantics match Alg. 1 (and the reference package's ``lax.while_loop``)
exactly:

  eps <- x_hat - x                       (inside the s-cube by construction)
  loop:
    delta <- FFT(eps)
    if delta inside f-cube: stop          (CheckConvergence)
    delta' <- clip(delta, +-Delta)        (ProjectOntoFCube)
    freq_edits += delta' - delta
    eps <- IFFT(delta')
    eps' <- clip(eps, +-E)                (ProjectOntoSCube)
    spat_edits += eps' - eps
    eps <- eps'

Iteration accounting: the terminating check counts as an iteration (a field
already inside both cubes reports 1), and ``final_violations`` is 0 when the
loop converged, else the count of the last (always checking) iteration.

The loop runs on the rfft half-spectrum by default (``use_rfft=True``);
violation counts weight each component by its conjugate-pair multiplicity so
they keep full-spectrum semantics.  ``use_rfft=False`` keeps the complex-FFT
oracle.  Transform selector ``fft_impl``:

  ``"xla"``     ``torch.fft.rfftn`` / ``irfftn`` (the name is the reference
                package's; here both are cuFFT or the CPU FFT).
  ``"packed"``  the forward ``rfftn`` + the pack-trick C2R inverse
                (:func:`repro_torch.kernels.rfft.packed_irfftn`).
  ``"pallas"``  the packed transforms with the fused CUDA epilogues of
                :mod:`repro_torch.kernels.rfft` (the name is kept so one
                ``FFCzConfig`` means the same to both packages).

Shapes with an odd last axis fall back statically: ``"packed"`` to the plain
transforms, ``"pallas"`` to the plain transforms + the fused fcube/scube
kernels of the ``use_kernels`` path.

Distributed pencil mode (``dist=DistSpec(...)``): every rank of the spec's
process group runs the loop on its local slab, with the transforms replaced
by the pencil-decomposed ones of :mod:`repro_torch.sharding.dist_fft`, and
the pair-weighted violation count summed over the group by an int32
``all_reduce`` on the checking iterations (so every rank sees the same count
and takes the same branch).  Slab-pad rows are exactly zero and stay zero
(clips and FFTs preserve zeros, the strict violation test never fires on
one), so the body needs no pad mask.  As in the reference, ``dist`` mode
takes ``fft_impl`` ``"xla"`` or ``"packed"`` (the pack trick on the local
c2r pass) and scalar or pre-sharded pointwise bounds; ``"pallas"`` is
refused (the fused epilogues mirror the whole spectrum on one device).

In-place accumulation: the loop adds each iteration's displacements into the
``spat_edits`` / ``freq_edits`` tensors it owns (``add_``), which gives the
same values as the reference's out-of-place sums.

Layout: the CUDA kernels take contiguous tensors only, and cuFFT's
multi-dimensional transforms may hand back other strides, so every
transform output is made contiguous (a no-op when it already is).

Batched pencils (:func:`alternating_projection_batched`): the reference runs
``jax.vmap(alternating_projection)`` over a packed ``(B, block)`` buffer, one
independent 1-D loop per row with its own ``E`` and ``Delta``.  Here the rows
are one batch: 1-D transforms over the last axis and the kernels' per-pencil
modes (per-row bounds and counts, the Hermitian mirror within the row).  A
vmapped ``while_loop`` runs until every row is done and freezes each row's
state once its check says done; the loop reproduces that with an active-row
mask and ``torch.where`` after the kernels.  The kernels run on every row
(frozen rows' results are discarded), which keeps them free of masks and
costs nothing while most rows are active — converged rows are not gathered
away.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.cubes import (
    project_box_relaxed,
    project_fcube,
    project_fcube_relaxed,
    project_scube,
    rfft_shape,
)
from repro_torch.kernels.fcube import ops as fcube_ops
from repro_torch.kernels.rfft import ops as rfft_ops
from repro_torch.kernels.scube import ops as scube_ops


@dataclasses.dataclass
class AlternatingProjectionResult:
    eps: torch.Tensor  # final spatial error vector (inside s-cube; inside f-cube if converged)
    spat_edits: torch.Tensor  # accumulated displacement along the spatial basis (real)
    # accumulated displacement along the frequency basis (complex); rfft
    # half-spectrum layout (last axis N//2+1) when use_rfft, else full spectrum
    freq_edits: torch.Tensor
    iterations: int  # iteration count
    converged: bool  # inside both cubes
    final_violations: int  # f-cube violations at exit (0 if converged)


_FFT_IMPLS = ("xla", "packed", "pallas")

# Convergence test uses a float32-resolution tolerance: below ~1e-5 relative
# the float32 FFT round-trip oscillates and cannot make progress; the exact
# float64 polish owns the last digits.
_CHECK_TOL = 1e-5


def _bound(b, like: torch.Tensor):
    """A scalar bound stays a host float rounded to ``like``'s real dtype (no
    device read-back inside the loop); an array bound becomes a tensor."""
    real = like.real if like.is_complex() else like
    if getattr(b, "ndim", 0) == 0:
        v = float(b)
        return float(np.float32(v)) if real.dtype == torch.float32 else v
    return torch.as_tensor(b, dtype=real.dtype, device=like.device)


def alternating_projection(
    eps0: torch.Tensor,
    E,
    Delta,
    max_iters: int = 1000,
    use_kernels: bool = False,
    relax: float = 1.0,
    check_slack=0.0,
    use_rfft: bool = True,
    dist: Optional[Any] = None,
    fft_impl: str = "xla",
    check_every: int = 1,
    warm_freq: Optional[torch.Tensor] = None,
) -> AlternatingProjectionResult:
    """Run Alg. 1 from an initial spatial error vector ``eps0``.

    Args:
      eps0: x_hat - x from the base compressor (any rank, real tensor); the
        loop runs on its device.
      E, Delta: scalar or broadcastable pointwise bounds.  Under ``use_rfft``
        a pointwise ``Delta`` may be given on the half-spectrum
        (``rfft_shape(eps0.shape)``) or on the full spectrum (sliced to the
        half-spectrum).
      max_iters: POCS iteration cap.
      use_kernels: route the projections through the fused fcube/scube
        kernels (their plain twins for CPU tensors).
      relax: over-relaxation factor; 1.0 is the paper's plain alternating
        projection, ``1 < relax < 2`` keeps Fejer monotonicity.
      check_slack: host scalar absolute allowance added to the convergence
        threshold (see :func:`repro_torch.kernels.fcube.ops.threshold_scalars`).
      use_rfft: run on the Hermitian half-spectrum (the fast path).
      dist: a :class:`repro_torch.sharding.dist_fft.DistSpec`: run on this
        rank's slab (``eps0`` is the local block, slab-pad rows zero;
        ``freq_edits`` the local half-spectrum block; a pointwise ``Delta``
        the local half-spectrum block and a pointwise ``E`` the local
        spatial block, both zero-padded to them).  Every rank of the spec's
        group must call it.
      fft_impl: ``"xla"`` | ``"packed"`` | ``"pallas"`` (see module
        docstring); ``"pallas"`` needs ``use_rfft``, ``relax == 1.0`` and no
        ``use_kernels``.
      check_every: run the convergence check every K-th iteration (and on
        the final one); the count is read back to the host only then.
      warm_freq: optional complex seed for ``freq_edits`` (the loop's
        frequency-state shape), applied through the loop's own inverse and
        s-cube-projected before iteration 0 so that
        ``eps == eps0 + IFFT(freq_edits) + spat_edits`` holds exactly.

    Returns an :class:`AlternatingProjectionResult` whose tensors live on
    ``eps0``'s device.
    """
    if fft_impl not in _FFT_IMPLS:
        raise ValueError(f"fft_impl must be one of {_FFT_IMPLS}, got {fft_impl!r}")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if fft_impl != "xla" and not use_rfft:
        raise ValueError("fft_impl='packed'/'pallas' require the rfft path (use_rfft=True)")
    if fft_impl == "pallas":
        if use_kernels:
            raise ValueError(
                "fft_impl='pallas' already fuses the projections into its "
                "epilogue kernels; drop use_kernels"
            )
        if relax != 1.0:
            raise ValueError("fft_impl='pallas' supports only relax == 1.0")
        if dist is not None:
            raise ValueError("dist mode supports fft_impl 'xla' or 'packed' only")
    if dist is not None and (use_kernels or not use_rfft):
        raise ValueError("dist mode supports only the plain rfft path (no use_kernels, use_rfft=True)")
    dtype = eps0.dtype
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    shape = tuple(eps0.shape)
    E = _bound(E, eps0)
    Delta_r = _bound(Delta, eps0)
    # threshold scalars of the plain count, rounded to the loop's precision
    # as the reference rounds them (the fused kernels round their own)
    if dtype == torch.float64:
        tol1, slack = 1.0 + _CHECK_TOL, float(check_slack)
    else:
        tol1, slack = fcube_ops.threshold_scalars(_CHECK_TOL, check_slack)

    packed_ok = fft_impl != "xla" and rfft_ops.supports_packed(dist.gshape if dist is not None else shape)
    pallas_fused = fft_impl == "pallas" and packed_ok
    if fft_impl == "pallas" and not packed_ok:
        use_kernels = True
    n_last = shape[-1] if shape else 1
    if dist is not None:
        from repro_torch.sharding import dist_fft

        freq_shape = dist_fft.local_freq_shape(dist.gshape, dist.n_dev)
        if isinstance(Delta_r, torch.Tensor) and tuple(Delta_r.shape) != freq_shape:
            raise ValueError(
                f"dist mode needs a scalar Delta or the local half-spectrum block "
                f"{freq_shape}, got {tuple(Delta_r.shape)}"
            )
        if isinstance(E, torch.Tensor) and tuple(E.shape) != shape:
            # pointwise spatial bounds (ROI grids) arrive pre-sharded in the
            # padded local layout, like a pointwise Delta grid
            raise ValueError(
                f"dist mode needs a scalar E or the local spatial block {shape}, got {tuple(E.shape)}"
            )
        inv_impl = "packed" if packed_ok else "xla"
        # the full-spectrum count is the pair-weighted sum of the local blocks'
        weights = dist_fft.local_pair_weights(dist.gshape, freq_shape, dist.rank, eps0.device)

        def fwd(e):
            return dist_fft.rfftn_local(e, dist).to(cdtype).contiguous()

        def inv(d):
            return dist_fft.irfftn_local(d, dist, fft_impl=inv_impl).to(dtype).contiguous()
    elif use_rfft:
        if isinstance(Delta_r, torch.Tensor) and tuple(Delta_r.shape) == shape:
            # full-spectrum pointwise grid: Hermitian-symmetric by contract,
            # so the rfft half-plane slice is exact
            Delta_r = Delta_r[..., : shape[-1] // 2 + 1]
        freq_shape = rfft_shape(shape)

        def fwd(e):
            return torch.fft.rfftn(e).to(cdtype).contiguous()

        if packed_ok:
            def inv(d):
                return rfft_ops.packed_irfftn(d, shape).to(dtype).contiguous()
        else:
            def inv(d):
                return torch.fft.irfftn(d, s=shape).to(dtype).contiguous()
    else:
        freq_shape = shape

        def fwd(e):
            return torch.fft.fftn(e).to(cdtype).contiguous()

        def inv(d):
            return torch.fft.ifftn(d).real.to(dtype).contiguous()

    if isinstance(Delta_r, torch.Tensor) and pallas_fused:
        Delta_r = torch.broadcast_to(Delta_r, freq_shape).contiguous()

    if use_kernels:
        def f_project(delta):
            clipped, disp, viol = fcube_ops.project_fcube_fused(
                delta, Delta_r, n_last=n_last if use_rfft else None,
                check_tol=_CHECK_TOL, check_slack=check_slack,
            )
            if relax != 1.0:
                clipped, _ = project_fcube(delta + relax * disp, Delta_r)
                disp = clipped - delta
            return clipped, disp, viol

        def s_project(eps):
            clipped, disp = scube_ops.project_scube_fused(eps, E)
            if relax != 1.0:
                clipped, _ = project_scube(eps + relax * disp, E)
                disp = clipped - eps
            return clipped, disp
    else:
        # last-axis k=0 plane (and the Nyquist plane for even N) counts once,
        # every other half-spectrum component twice
        has_nyquist = use_rfft and n_last % 2 == 0 and n_last // 2 + 1 > 1
        dt = torch.as_tensor(Delta_r, dtype=eps0.dtype, device=eps0.device) * torch.tensor(
            tol1, dtype=eps0.dtype, device=eps0.device
        ) + torch.tensor(slack, dtype=eps0.dtype, device=eps0.device)

        def count_violations(delta):
            vb = (torch.abs(delta.real) > dt) | (torch.abs(delta.imag) > dt)
            if dist is not None:
                # integer all-reduce of the pair-weighted local counts: the
                # full-spectrum count, exactly
                viol = torch.sum(vb.to(torch.int32) * weights).to(torch.int32).reshape(1)
                return dist_fft.all_reduce_(viol, dist.group)[0]
            if use_rfft:
                viol = 2 * torch.sum(vb) - torch.sum(vb[..., 0])
                if has_nyquist:
                    viol = viol - torch.sum(vb[..., -1])
            else:
                viol = torch.sum(vb)
            return viol

        def f_project(delta):
            if relax == 1.0:
                clipped, disp = project_fcube(delta, Delta_r)
            else:
                clipped = project_fcube_relaxed(delta, Delta_r, relax)
                disp = clipped - delta
            return clipped, disp, None

        def s_project(eps):
            if relax == 1.0:
                return project_scube(eps, E)
            clipped = project_box_relaxed(eps, E, relax)
            return clipped, clipped - eps

    if warm_freq is None:
        eps, spat = eps0, torch.zeros_like(eps0)
        if isinstance(E, torch.Tensor):
            # pointwise spatial bounds (ROI grids): the base compressor only
            # guarantees the global bound, so restore "state inside the
            # s-cube" before iteration 0 (a trivially converged loop would
            # otherwise return eps0 unclipped)
            eps, spat = project_scube(eps0, E)
            eps, spat = eps.to(dtype), spat.to(dtype)
        freq = torch.zeros(freq_shape, dtype=cdtype, device=eps0.device)
    else:
        warm = torch.as_tensor(warm_freq, device=eps0.device).to(cdtype)
        if tuple(warm.shape) != tuple(freq_shape):
            raise ValueError(
                f"warm_freq must have the loop's frequency-state shape "
                f"{tuple(freq_shape)}, got {tuple(warm.shape)}"
            )
        eps, spat = project_scube(eps0 + inv(warm), E)
        eps, spat = eps.to(dtype), spat.to(dtype)
        freq = warm.clone()

    it, done, viol = 0, False, -1
    while not done and it < max_iters:
        delta = fwd(eps)
        if pallas_fused:
            # one pass: f-clip + displacement + pair-weighted count + the
            # inverse pack twiddle feeding the half-length ifftn
            _clipped, f_disp, Z, viol_dev = rfft_ops.fwd_epilogue_fused(
                delta, Delta_r, weighted=True, check_tol=_CHECK_TOL, check_slack=check_slack
            )
        else:
            clipped, f_disp, viol_dev = f_project(delta)
        if check_every == 1 or it % check_every == 0 or it == max_iters - 1:
            if viol_dev is None:
                viol_dev = count_violations(delta)
            with tracing.span("ffcz.loop.wait"):
                viol = int(viol_dev)  # the host waits for the device here only
            done = viol == 0
        else:
            viol = -1
        if not done:
            freq.add_(f_disp)
            if pallas_fused:
                z = torch.fft.ifftn(Z).contiguous()
                eps_s, s_disp = rfft_ops.unpack_sclip_fused(z, E, shape)
            else:
                eps_s, s_disp = s_project(inv(clipped))
            spat.add_(s_disp.to(dtype))
            eps = eps_s.to(dtype)
        it += 1
    return AlternatingProjectionResult(
        eps=eps,
        spat_edits=spat,
        freq_edits=freq,
        iterations=it,
        converged=done,
        final_violations=0 if done else viol,
    )


def alternating_projection_batched(
    eps0: torch.Tensor,
    E,
    Delta,
    max_iters: int = 1000,
    fft_impl: str = "xla",
    warm_freq: Optional[torch.Tensor] = None,
    donate: bool = False,
    keep_edits: bool = True,
) -> AlternatingProjectionResult:
    """Alg. 1 on every row of a ``(B, block)`` batch of independent pencils.

    The semantics of ``jax.vmap(alternating_projection)`` over rows, with
    per-row scalar bounds: ``E`` and ``Delta`` are scalars or ``(B,)``
    vectors, ``warm_freq`` an optional ``(B, block // 2 + 1)`` complex
    seed.  Each row stops when its own check finds it inside the f-cube (its
    ``eps``, edits, iteration count and violation count are frozen from then
    on) or at ``max_iters``; the loop runs until no row is left, reading the
    rows' counts back to the host once per iteration (one ``any()``).

    ``fft_impl`` as in :func:`alternating_projection`; ``"pallas"`` runs the
    fused epilogues in per-pencil mode for an even ``block`` and the fused
    fcube/scube kernels in per-pencil mode for an odd one (the reference's
    static fallback).  Returns an :class:`AlternatingProjectionResult` whose
    ``iterations``, ``converged`` and ``final_violations`` are ``(B,)``
    tensors (int32, bool, int32) on ``eps0``'s device.

    Memory: each temporary is released once it has been read, and the
    loop's state (``eps``, the edits) is updated in place on the stepping
    rows, so at most seven batch-sized buffers are alive at once (the
    f-clip's input and three outputs beside the state).  With ``donate``
    the loop owns ``eps0`` and writes ``eps`` into it (the returned ``eps``
    is ``eps0``); otherwise ``eps0`` is not written.  Without
    ``keep_edits`` the edit streams, which ``eps`` never reads, are not
    accumulated (``spat_edits`` and ``freq_edits`` are ``None``): five
    buffers at most.
    """
    if fft_impl not in _FFT_IMPLS:
        raise ValueError(f"fft_impl must be one of {_FFT_IMPLS}, got {fft_impl!r}")
    if eps0.ndim != 2 or eps0.dtype != torch.float32:
        raise ValueError(f"need a float32 (B, block) batch, got {eps0.dtype} {tuple(eps0.shape)}")
    rows, n = eps0.shape
    dev = eps0.device

    def per_row(b):
        return torch.broadcast_to(
            torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(-1), (rows,)
        ).reshape(rows, 1).contiguous()

    E, Delta = per_row(E), per_row(Delta)
    packed_ok = fft_impl != "xla" and rfft_ops.supports_packed((n,))
    pallas_fused = fft_impl == "pallas" and packed_ok
    use_kernels = fft_impl == "pallas" and not packed_ok
    h = n // 2 + 1

    def fwd(e):
        return torch.fft.rfft(e, dim=-1).contiguous()

    if packed_ok:
        def inv(d):
            return rfft_ops.packed_irfft(d, n).contiguous()
    else:
        def inv(d):
            return torch.fft.irfft(d, n=n, dim=-1).contiguous()

    tol1, slack = fcube_ops.threshold_scalars(_CHECK_TOL, 0.0)
    dt = Delta * torch.tensor(tol1, device=dev) + torch.tensor(slack, device=dev)
    has_nyquist = n % 2 == 0 and h > 1

    def count_violations(delta):
        vb = ((torch.abs(delta.real) > dt) | (torch.abs(delta.imag) > dt)).to(torch.int32)
        viol = 2 * torch.sum(vb, dim=-1) - vb[:, 0]
        if has_nyquist:
            viol = viol - vb[:, -1]
        return viol.to(torch.int32)

    if warm_freq is None:
        eps = eps0 if donate else eps0.clone()
        spat = torch.zeros_like(eps0) if keep_edits else None
        freq = torch.zeros((rows, h), dtype=torch.complex64, device=dev) if keep_edits else None
    else:
        freq = torch.as_tensor(warm_freq, device=dev).to(torch.complex64).clone()
        if tuple(freq.shape) != (rows, h):
            raise ValueError(f"warm_freq must have shape {(rows, h)}, got {tuple(freq.shape)}")
        eps, spat = project_scube(eps0 + inv(freq), E)
        if not keep_edits:
            spat = freq = None

    iterations = torch.zeros(rows, dtype=torch.int32, device=dev)
    done = torch.zeros(rows, dtype=torch.bool, device=dev)
    viol_state = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(rows, dtype=torch.bool, device=dev)
    it, stepping_any = 0, rows > 0
    while stepping_any and it < max_iters:
        # every row steps (frozen rows' results are discarded); the stepping
        # rows' updates go into the state in place, each temporary is
        # dropped once read: the sums are the reference's element-wise ones
        delta = fwd(eps)
        if pallas_fused:
            clipped, f_disp, Z, viol = rfft_ops.fwd_epilogue_fused(
                delta, Delta, weighted=True, check_tol=_CHECK_TOL, per_row=True
            )
            clipped = None  # the fused path reads Z instead
        elif use_kernels:
            clipped, f_disp, viol = fcube_ops.project_fcube_fused(
                delta, Delta, n_last=n, check_tol=_CHECK_TOL, per_row=True
            )
        else:
            clipped, f_disp = project_fcube(delta, Delta)
            viol = count_violations(delta)
        del delta
        done_now = viol == 0
        stepping = active & ~done_now
        with tracing.span("ffcz.loop.wait"):
            stepping_any = bool(stepping.any())  # the host waits for the device here only
        if stepping_any:
            col = stepping[:, None]
            if keep_edits:
                torch.where(col, f_disp.add_(freq), freq, out=freq)
            del f_disp
            if pallas_fused:
                z = torch.fft.ifft(Z, dim=-1).contiguous()
                del Z
                eps_s, s_disp = rfft_ops.unpack_sclip_fused(z, E, (rows, n))
                del z
            else:
                x = inv(clipped)
                del clipped
                if use_kernels:
                    eps_s, s_disp = scube_ops.project_scube_fused(x, E)
                else:
                    eps_s, s_disp = project_scube(x, E)
                del x
            if keep_edits:
                torch.where(col, s_disp.add_(spat), spat, out=spat)
            del s_disp
            torch.where(col, eps_s, eps, out=eps)
            del eps_s
        viol_state = torch.where(active, viol, viol_state)
        done = done | (active & done_now)
        iterations += active.to(torch.int32)
        active = stepping
        it += 1
    return AlternatingProjectionResult(
        eps=eps,
        spat_edits=spat,
        freq_edits=freq,
        iterations=iterations,
        converged=done,
        final_violations=torch.where(done, torch.zeros_like(viol_state), viol_state),
    )
