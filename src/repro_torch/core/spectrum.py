"""Frequency-domain metrics: power spectrum, SSNR, RFE, PSNR (paper §III, §V-A).

Tensor functions take torch tensors on any device (numpy arrays are
converted on the CPU); :func:`shell_ratio_error` and
:func:`power_spectrum_relative_error` are host float64 / numpy rechecks.
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
    """
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
