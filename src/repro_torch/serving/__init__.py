"""Serving: the LM's batched decode engine and the fault-tolerant FFCz service.

Names resolve lazily (PEP 562): importing the package loads no submodule, so
the FFCz service (``ffcz_service``, ``sessions``) is importable without the
LM engine's model code, and the LM engine without the service.
"""

import importlib

_EXPORTS = {
    "ServingEngine": "engine",
    "ServeConfig": "engine",
    "FFCzService": "ffcz_service",
    "ServiceConfig": "ffcz_service",
    "ServiceResponse": "ffcz_service",
    "RequestStats": "ffcz_service",
    "decode_pencil_blob": "ffcz_service",
    "StreamSessionManager": "sessions",
    "SessionStats": "sessions",
    "FrameReceipt": "sessions",
    "MemoryJournal": "sessions",
    "FileJournal": "sessions",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
