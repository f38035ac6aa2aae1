"""The port's packages export every public name of the reference's.

For each package of the reference with an ``__all__``, every name is
importable from the port's package of the same name and listed in its
``__all__``; no reference name is missing from the port (the temporal codec
and the FFCz service, the last ones queued, landed with the service slice).
"""

import importlib

import pytest

PACKAGES = ("core", "serving", "checkpoint", "optim", "runtime", "data", "compressors", "coding", "kernels")



def _reference_all(pkg):
    return list(getattr(importlib.import_module(f"repro.{pkg}"), "__all__", []))


CASES = [(pkg, name) for pkg in PACKAGES for name in _reference_all(pkg)]


@pytest.mark.parametrize("pkg,name", CASES, ids=[f"{p}.{n}" for p, n in CASES])
def test_reference_name_is_exported(pkg, name):
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert name in port.__all__
    obj = getattr(port, name)
    ref = getattr(importlib.import_module(f"repro.{pkg}"), name)
    assert callable(obj) == callable(ref)
    assert not obj.__module__.startswith("repro.")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_reference_name_is_missing(pkg):
    """Catches a name the reference adds later: the cases above are drawn
    from its ``__all__`` too, but this one fails by name if any is absent."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = set(_reference_all(pkg))
    assert {n for n in ref if not hasattr(port, n)} == set()
    assert ref <= set(port.__all__)


def test_serving_resolves_names_lazily():
    """``repro_torch.serving`` imports the FFCz service without the LM
    engine's model code, and the LM engine without the service."""
    import subprocess
    import sys

    code = ("import sys, repro_torch.serving as s\n"
            "assert 'repro_torch.serving.ffcz_service' not in sys.modules\n"
            "s.FFCzService, s.MemoryJournal\n"
            "assert 'repro_torch.serving.engine' not in sys.modules\n"
            "assert 'repro_torch.models' not in sys.modules\n"
            "s.ServingEngine\n"
            "assert 'repro_torch.serving.engine' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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
