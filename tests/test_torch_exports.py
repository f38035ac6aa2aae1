"""The port's packages export the reference's public names that it has.

For each package of the reference with an ``__all__``, every name that the
port has ported is importable from the port's package of the same name and
listed in its ``__all__``; the names still missing are exactly the ones the
ROADMAP's queues carry (a name ported later moves from ``MISSING`` to the
tested set, and this file says so).
"""

import importlib

import pytest

PACKAGES = ("core", "serving", "checkpoint", "optim", "runtime", "data", "compressors", "coding", "kernels")

#: reference names the port does not have yet, by package (ROADMAP.md Queue 1)
MISSING = {
    "core": {"TemporalCodec", "TemporalConfig", "TemporalStream"},
    "serving": {"FFCzService", "ServiceConfig", "ServiceResponse", "RequestStats", "decode_pencil_blob",
                "StreamSessionManager", "SessionStats", "FrameReceipt", "MemoryJournal", "FileJournal"},
}


def _reference_all(pkg):
    return list(getattr(importlib.import_module(f"repro.{pkg}"), "__all__", []))


CASES = [(pkg, name) for pkg in PACKAGES for name in _reference_all(pkg)
         if name not in MISSING.get(pkg, set())]


@pytest.mark.parametrize("pkg,name", CASES, ids=[f"{p}.{n}" for p, n in CASES])
def test_reference_name_is_exported(pkg, name):
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert name in port.__all__
    obj = getattr(port, name)
    ref = getattr(importlib.import_module(f"repro.{pkg}"), name)
    assert callable(obj) == callable(ref)
    assert not obj.__module__.startswith("repro.")


@pytest.mark.parametrize("pkg", sorted(MISSING))
def test_missing_names_are_the_queued_ones(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = set(_reference_all(pkg))
    assert MISSING[pkg] <= ref
    assert {n for n in ref if not hasattr(port, n)} == MISSING[pkg]


def test_core_resolves_names_lazily():
    """``repro_torch.core`` imports no submodule until a name is asked for,
    so the kernels can import ``core.cubes`` without the engine."""
    import subprocess
    import sys

    code = ("import sys, repro_torch.core as c\n"
            "assert 'repro_torch.core.engine' not in sys.modules\n"
            "c.FFCz\n"
            "assert 'repro_torch.core.ffcz' in sys.modules\n"
            "from repro_torch.core import FFCz, FFCzConfig, CorrectionEngine, default_engine\n"
            "try:\n    c.nothing\nexcept AttributeError:\n    pass\nelse:\n    raise SystemExit(1)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
