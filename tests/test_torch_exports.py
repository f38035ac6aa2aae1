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


def _defined_in(module):
    """The public functions and classes a reference module defines itself."""
    mod = importlib.import_module(module)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and callable(v) and getattr(v, "__module__", None) == module)


#: the LM modules of the moe/ssm/hybrid and vlm/audio slices: every public
#: name the reference defines in ``models.moe`` and ``models.ssm``, and the
#: blocks, layers and model entry points the slices port; a reference
#: ``*_init``/``*_apply`` pair is one module class in the port
MODEL_NAMES = ([("models.moe", n, n) for n in _defined_in("repro.models.moe")]
               + [("models.ssm", n, n) for n in _defined_in("repro.models.ssm")]
               + [("models.transformer", n, p) for n, p in (
                   ("remat_wrap", "remat_wrap"), ("moe_group_init", "MoEGroup"), ("moe_group_apply", "MoEGroup"),
                   ("zamba_shared_init", "ZambaShared"), ("zamba_group_init", "ZambaGroup"),
                   ("zamba_group_apply", "ZambaGroup"), ("encoder_block_init", "EncoderBlock"),
                   ("encoder_block_apply", "EncoderBlock"), ("decoder_xblock_init", "DecoderXBlock"),
                   ("decoder_xblock_apply", "DecoderXBlock"), ("cross_kv_from_encoder", "cross_kv_from_encoder"))]
               + [("models.layers", n, n) for n in ("sinusoidal_embed", "sinusoidal_positions", "gelu_mlp_init",
                                                   "gelu_mlp")]
               + [("models.attention", "qkv_slices", "qkv_slices")]
               + [("models.model", n, n) for n in ("build_model", "ModelBundle")])


@pytest.mark.parametrize("module,name,port_name", MODEL_NAMES, ids=[f"{m}.{n}" for m, n, _ in MODEL_NAMES])
def test_model_module_name_is_ported(module, name, port_name):
    assert callable(getattr(importlib.import_module(f"repro.{module}"), name))
    obj = getattr(importlib.import_module(f"repro_torch.{module}"), port_name)
    assert callable(obj) and obj.__module__.startswith("repro_torch.")


#: the distribution names of the reference's ``repro.sharding`` (its
#: ``dist_fft`` half; ``rules.py`` belongs to ROADMAP Queue 1 item 5d) and of
#: ``repro.runtime.elastic``, with the port module that carries them
DIST_NAMES = ([("sharding", n) for n in ("DistSpec", "ShardedField", "classify_parity", "pencil_rfftn",
                                          "pencil_irfftn", "validate_pencil_shape")]
              + [("sharding.dist_fft", n) for n in _defined_in("repro.sharding.dist_fft")]
              + [("runtime.elastic", n) for n in _defined_in("repro.runtime.elastic")]
              + [("optim", "compressed_psum"), ("core.spectrum", "power_spectrum_sharded"),
                 ("core.ffcz", "ShardedField")])


@pytest.mark.parametrize("module,name", DIST_NAMES, ids=[f"{m}.{n}" for m, n in DIST_NAMES])
def test_distribution_name_is_ported(module, name):
    ref = getattr(importlib.import_module(f"repro.{module}"), name)
    port_module = importlib.import_module(f"repro_torch.{module}")
    obj = getattr(port_module, name)
    assert callable(obj) == callable(ref)
    assert obj.__module__.startswith("repro_torch.")
    if module == "sharding":
        assert name in port_module.__all__
