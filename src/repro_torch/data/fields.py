"""Synthetic scientific fields with controlled spectra (paper Table I analogues)."""

from __future__ import annotations

import numpy as np

from repro_torch.configs.ffcz_fields import FIELDS, FieldConfig


def make_field(name_or_cfg) -> np.ndarray:
    cfg: FieldConfig = FIELDS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
    rng = np.random.default_rng(cfg.seed)
    if cfg.kind == "lognormal":
        # Nyx-like baryon density: lognormal transform of a power-law GRF
        # (captures the real field's huge dynamic range, which is what makes
        # trial-and-error bound tightening expensive on the real data)
        g = _grf(cfg.shape, cfg.alpha, rng)
        return np.exp(1.5 * g).astype(np.float32)
    if cfg.kind == "powerlaw":
        return _grf(cfg.shape, cfg.alpha, rng) + 3.0
    if cfg.kind == "exponential":
        return _smooth_exp(cfg.shape, cfg.alpha, rng)
    if cfg.kind == "spots":
        return _spots(cfg.shape, rng)
    if cfg.kind == "pink":
        return _grf(cfg.shape, cfg.alpha, rng)
    raise ValueError(cfg.kind)


def _kgrid(shape):
    axes = [np.fft.fftfreq(n) * n for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.sqrt(sum(g.astype(np.float64) ** 2 for g in grids))


def _grf(shape, alpha, rng) -> np.ndarray:
    """Gaussian random field with P(k) ~ k^-alpha (Nyx/EEG-like)."""
    k = _kgrid(shape)
    with np.errstate(divide="ignore"):
        amp = np.where(k > 0, k ** (-alpha / 2.0), 0.0)
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.fft.ifftn(amp * noise).real
    return (f / (f.std() + 1e-30)).astype(np.float32)


def _smooth_exp(shape, k0, rng) -> np.ndarray:
    """Smooth field with exponentially decaying spectrum (S3D-like)."""
    k = _kgrid(shape)
    amp = np.exp(-k / max(k0, 1e-3))
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.fft.ifftn(amp * noise).real
    return (f / (f.std() + 1e-30)).astype(np.float32) + 1.0


def _spots(shape, rng, n_spots: int = 60) -> np.ndarray:
    """Sparse bright diffraction spots on a weak noise floor (HEDM-like)."""
    f = rng.standard_normal(shape).astype(np.float32) * 1e-3
    coords = [rng.integers(2, n - 2, n_spots) for n in shape]
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    for i in range(n_spots):
        c = [cc[i] for cc in coords]
        r2 = sum((g - ci) ** 2 for g, ci in zip(grids, c))
        f += rng.uniform(0.5, 5.0) * np.exp(-r2 / 2.0).astype(np.float32)
    return f


def error_pencils(device, rows: int, block: int, seed: int = 3):
    """``rows`` pencils of ``block`` quantization-like errors for the pencil
    engines, made on ``device`` from ``seed``: ``(errors, Es, Deltas)``.

    Three tensors (uniform in +-E for E = 1, 0.5, 2; the second not a whole
    number of pencils), each with a Delta of three standard deviations of a
    pencil's spectrum components, so that most pencils need correcting.
    """
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = (rows // 2 * block, rows // 4 * block + 100, (rows - rows // 2 - rows // 4 - 1) * block)
    Es = (1.0, 0.5, 2.0)
    errs = [(2 * torch.rand(n, generator=gen, device=device) - 1) * E for n, E in zip(sizes, Es)]
    return errs, list(Es), [3.0 * E * (block / 6) ** 0.5 for E in Es]
