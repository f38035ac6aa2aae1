"""The paper's own experiment configurations (Table I datasets + §V bounds).

Synthetic analogues of the benchmark datasets (DESIGN.md §6) at
container-feasible resolutions, with the spectral character of the originals:

  nyx-like    3D Gaussian random field, power-law P(k) ~ k^-alpha (cosmology)
  s3d-like    3D smooth field, exponential spectrum (combustion)
  hedm-like   2D sparse diffraction spots on noise floor
  eeg-like    1D 1/f noise series
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    name: str
    shape: Tuple[int, ...]
    kind: str  # powerlaw | exponential | spots | pink
    alpha: float = 2.0
    seed: int = 0


FIELDS = {
    "nyx-like": FieldConfig("nyx-like", (64, 64, 64), "lognormal", alpha=2.0),
    "nyx-like-128": FieldConfig("nyx-like-128", (128, 128, 128), "lognormal", alpha=2.0),
    # 256^3 float32 (64 MiB): the full-size field chip_smoke.py drives
    "nyx-like-256": FieldConfig("nyx-like-256", (256, 256, 256), "lognormal", alpha=2.0),
    "grf-like": FieldConfig("grf-like", (64, 64, 64), "powerlaw", alpha=2.0),
    "s3d-like": FieldConfig("s3d-like", (64, 64, 64), "exponential", alpha=8.0),
    "hedm-like": FieldConfig("hedm-like", (256, 256), "spots"),
    "eeg-like": FieldConfig("eeg-like", (31_000,), "pink", alpha=1.0),
}

#: paper §V-B: relative spatial bound 0.1%; RFE bounds chosen to cut the max
#: frequency error of the base compressor by ~100x.
DEFAULT_E_REL = 1e-3
DEFAULT_DELTA_REL = 1e-3
PSPEC_REL = 1e-3  # Fig. 10: 0.1% relative power-spectrum bound
