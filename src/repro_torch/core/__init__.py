"""FFCz core: dual-domain error bounding via alternating projection (paper §IV).

Modules: ``bounds``, ``cubes``, ``spectrum`` (math on tensors), ``pocs`` (the
loop), ``engine`` (PLAN / EXECUTE / ENCODE), ``ffcz`` (the codec and its wire
format), ``temporal`` (the stream codec), ``edits`` and ``errors``.  The
reference's ``repro.core`` names are re-exported lazily (PEP 562): a name's
module is imported on first access, so the kernels can import
``core.cubes`` without importing the engine.
"""

import importlib

_EXPORTS = {
    "TemporalCodec": "temporal",
    "TemporalConfig": "temporal",
    "TemporalStream": "temporal",
    "DualBounds": "bounds",
    "power_spectrum_delta": "bounds",
    "project_fcube": "cubes",
    "project_scube": "cubes",
    "alternating_projection": "pocs",
    "AlternatingProjectionResult": "pocs",
    "CorrectionEngine": "engine",
    "default_engine": "engine",
    "FFCz": "ffcz",
    "FFCzConfig": "ffcz",
    "power_spectrum": "spectrum",
    "ssnr": "spectrum",
    "psnr": "spectrum",
    "relative_frequency_error": "spectrum",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
