"""Frequency-domain metrics: power spectrum, SSNR, RFE, PSNR (paper §III, §V-A).

Tensor functions take torch tensors on any device (numpy arrays are
converted on the CPU); :func:`shell_ratio_error` and
:func:`power_spectrum_relative_error` are host float64 / numpy rechecks.
:func:`power_spectrum` also accepts a slab-sharded
:class:`repro_torch.sharding.dist_fft.ShardedField`, binning shells from the
distributed half-spectrum without gathering the field.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def power_spectrum(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radially binned power spectrum P(k) of an n-D real field (paper §III).

    Normalizes fluctuations (x - mean)/mean, FFTs, shifts the zero frequency
    to the center, and accumulates |X'|^2 over integer radial shells
    ``u^2 + v^2 + w^2 = k^2``.

    Returns (k values, P(k)) with ``k in [0, floor(min(N)/2)]``.

    A :class:`~repro_torch.sharding.dist_fft.ShardedField` goes to
    :func:`power_spectrum_sharded` (same semantics, a collective call).
    """
    from repro_torch.sharding.dist_fft import ShardedField

    if isinstance(x, ShardedField):
        return power_spectrum_sharded(x)
    x = _t(x)
    mean = torch.mean(x)
    xp = (x - mean) / torch.where(mean == 0, torch.ones_like(mean), mean)
    X = torch.fft.fftshift(torch.fft.fftn(xp))
    power = torch.abs(X) ** 2
    grids = torch.meshgrid(
        *[torch.arange(n, device=x.device) - n // 2 for n in x.shape], indexing="ij"
    )
    r = torch.sqrt(sum(g.to(torch.float32) ** 2 for g in grids))
    k_max = min(x.shape) // 2
    shell = torch.round(r).to(torch.int64)
    contrib = torch.where(shell <= k_max, power, torch.zeros_like(power))
    pk = torch.zeros(k_max + 1, dtype=power.dtype, device=x.device)
    pk.index_add_(0, torch.clamp(shell, 0, k_max).reshape(-1), contrib.reshape(-1))
    return torch.arange(k_max + 1, device=x.device), pk


def power_spectrum_sharded(field) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`power_spectrum` of a slab-sharded field, never gathered.

    Every rank of the field's axis calls it and gets the whole ``P(k)``.
    The mean is one float32 ``all_reduce`` of the slab sums over the TRUE
    element count; the slab-pad rows, which the normalization would turn
    into ``-1``, are masked back to zero before the distributed rfftn.
    Conjugate-pair multiplicities recover full-spectrum shell power, shell
    indices come from global frequency coordinates (the rank's offset on
    the sharded axis), pad rows and columns of the half-spectrum are
    excluded, and one ``all_reduce`` of the ``(k_max + 1,)`` histogram merges
    the ranks.  Shell sums re-associate across world sizes, so this matches
    the gathered :func:`power_spectrum` to float tolerance, as in the
    reference (a metric, not a bound).
    """
    from repro_torch.sharding import dist_fft

    spec = field.dist_spec
    gshape, nd, local = field.gshape, field.ndim, field.local
    dev = local.device
    k_max = min(gshape) // 2
    total = dist_fft.all_reduce_(torch.sum(local).reshape(1), field.group)[0]
    mean = total / torch.tensor(float(np.prod(gshape)), dtype=local.dtype, device=dev)
    xp = (local - mean) / torch.where(mean == 0, torch.ones_like(mean), mean)
    row = field.rank * local.shape[0] + torch.arange(local.shape[0], device=dev)
    xp = torch.where((row < gshape[0]).reshape((-1,) + (1,) * (nd - 1)), xp, torch.zeros_like(xp))
    Xh = dist_fft.rfftn_local(xp, spec)
    w = dist_fft.local_pair_weights(gshape, tuple(Xh.shape), field.rank, dev)
    power = (torch.abs(Xh) ** 2) * w.to(torch.float32)
    sharded_axis = 0 if nd == 3 else nd - 1
    coords, pad_ok = [], torch.ones((), dtype=torch.bool, device=dev)
    for a in range(nd):
        idx = torch.arange(Xh.shape[a], device=dev)
        if a == sharded_axis:
            idx = idx + field.rank * Xh.shape[a]
            n_true = gshape[0] if nd == 3 else gshape[-1] // 2 + 1
            shape_a = [1] * nd
            shape_a[a] = -1
            pad_ok = pad_ok & (idx < n_true).reshape(shape_a)
            idx = torch.clamp(idx, max=n_true - 1)
        # power_spectrum's fftshift: bin k sits at signed frequency
        # ((k + n//2) % n) - n//2 (the half axis: k itself, or -n/2)
        coords.append(((idx + gshape[a] // 2) % gshape[a]) - gshape[a] // 2)
    grids = torch.meshgrid(*coords, indexing="ij")
    r = torch.sqrt(sum(g.to(torch.float32) ** 2 for g in grids))
    shell = torch.round(r).to(torch.int64)
    power = torch.where(pad_ok & (shell <= k_max), power, torch.zeros_like(power))
    pk = torch.zeros(k_max + 1, dtype=power.dtype, device=dev)
    pk.index_add_(0, torch.clamp(shell, 0, k_max).reshape(-1), power.reshape(-1))
    return torch.arange(k_max + 1, device=dev), dist_fft.all_reduce_(pk, field.group)


def ssnr(X_hat: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Spectral signal-to-noise ratio in dB (paper §V-A)."""
    X_hat, X = _t(X_hat), _t(X)
    num = torch.sum(torch.abs(X) ** 2)
    den = torch.sum(torch.abs(X - X_hat) ** 2)
    return 10.0 * torch.log10(num / torch.clamp_min(den, torch.finfo(torch.float32).tiny))


def ssnr_spatial(x_hat, x) -> torch.Tensor:
    """SSNR computed from spatial fields (FFTs applied internally)."""
    return ssnr(torch.fft.fftn(_t(x_hat)), torch.fft.fftn(_t(x)))


def psnr(x_hat, x) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (spatial-domain metric).

    A constant reference field has ``range(x) == 0``; the range is clamped
    like the MSE term so the metric degrades to a finite (very low) value
    instead of ``-inf``/NaN.
    """
    x_hat, x = _t(x_hat), _t(x)
    tiny = torch.finfo(torch.float32).tiny
    rng = torch.clamp_min(torch.max(x) - torch.min(x), tiny)
    mse = torch.mean((x_hat - x) ** 2)
    return 20.0 * torch.log10(rng) - 10.0 * torch.log10(torch.clamp_min(mse, tiny))


def relative_frequency_error(X_hat, X) -> torch.Tensor:
    """RFE per component: |delta_k| / max_k |X_k| (paper §V-A).

    The denominator is clamped so an all-zero reference spectrum yields
    zeros (exact reconstruction) or large-but-finite values instead of NaN.
    """
    X_hat, X = _t(X_hat), _t(X)
    den = torch.clamp_min(torch.max(torch.abs(X)), torch.finfo(torch.float32).tiny)
    return torch.abs(X_hat - X) / den


def power_spectrum_relative_error(x_hat, x) -> Tuple[np.ndarray, np.ndarray]:
    """(P_hat(k) - P(k)) / P(k) per shell (paper Fig. 10 lower row)."""
    k, p = power_spectrum(x)
    _, p_hat = power_spectrum(x_hat)
    p = p.cpu().numpy()
    p_hat = p_hat.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(p > 0, (p_hat - p) / p, 0.0)
    return k.cpu().numpy(), rel


def _power_spectrum_np64(x: np.ndarray) -> np.ndarray:
    """Float64 numpy mirror of :func:`power_spectrum` (same conventions:
    mean-normalized fluctuations, ``fftshift``, integer radial shells,
    ``k_max = min(shape)//2``) for the exact verify-after-polish recheck."""
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean()
    xp = (x - mean) / (mean if mean != 0 else 1.0)
    X = np.fft.fftshift(np.fft.fftn(xp))
    power = np.abs(X) ** 2
    grids = np.meshgrid(*[np.arange(n) - n // 2 for n in x.shape], indexing="ij")
    r = np.sqrt(sum(g.astype(np.float64) ** 2 for g in grids))
    k_max = min(x.shape) // 2
    shell = np.rint(r).astype(np.int64)
    pk = np.zeros(k_max + 1)
    np.add.at(pk, np.clip(shell, 0, k_max), np.where(shell <= k_max, power, 0.0))
    return pk


def shell_ratio_error(x_hat, x) -> float:
    """max over shells of ``|P_hat(k)/P(k) - 1|``, computed in float64.

    The derived-quantity verify for ``pspec_rel`` bounds.  Dead shells
    (``P(k) <= 1e-12 * max_k P``) carry no ratio claim and are skipped; an
    exact reconstruction (or all-dead spectrum) returns 0.0.
    """
    p = _power_spectrum_np64(x)
    p_hat = _power_spectrum_np64(x_hat)
    live = p > 1e-12 * (p.max() if p.size else 0.0)
    if not live.any():
        return 0.0
    return float(np.max(np.abs(p_hat[live] / p[live] - 1.0)))


def bitrate(compressed_bytes: int, n_values: int) -> float:
    """Bits per value (the paper's bitrate axis)."""
    return 8.0 * compressed_bytes / n_values
