"""The port's error taxonomy: its own device-code faults are permanent.

A kernel that cannot be built (no ``nvcc``, an ``nvcc`` that fails or cannot
be started, a build directory that cannot be made) or whose library does not
load, a launcher that returns a ``cudaError_t``, ``torch.AcceleratorError``
and CUDA's sticky errors (which poison the context) classify as :class:`PermanentError`: no
retry, and no lower ``fft_impl`` rung that would complete the request
without the kernel.  The fault injector's dispatch error (a plain
``RuntimeError``, the reference's and the port's) stays transient, so
fault-injected runs walk the reference's retries and rungs.
"""

import pytest
import torch

from repro.core.errors import classify_exception as ref_classify
from repro.runtime.faults import InjectedDispatchError as RefInjectedDispatchError
from repro_torch.core.errors import (
    DeviceDispatchError,
    PermanentError,
    ResourceExhausted,
    classify_exception,
    is_kernel_fault,
)
from repro_torch.kernels import build
from repro_torch.runtime.faults import InjectedDispatchError, InjectedOOM


def _permanent(exc):
    err = classify_exception(exc, "execute")
    assert type(err) is PermanentError, err
    assert not err.transient and not err.retryable and err.disposition == "reject"
    assert err.stage == "execute" and err.cause is exc
    return err


def test_missing_nvcc_is_a_permanent_kernel_error(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(build.KernelError, match="nvcc not found") as ei:
        build.nvcc()
    assert isinstance(ei.value, RuntimeError)  # callers catching RuntimeError are unchanged
    _permanent(ei.value)


def test_failed_nvcc_is_a_permanent_kernel_error(monkeypatch, tmp_path):
    # a compiler that exits 1: the build path as it runs, into a scratch dir
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    with pytest.raises(build.KernelError, match="nvcc failed for csrc/scube.cu") as ei:
        build._finish("scube", build._start("scube"))
    assert not list(tmp_path.glob("*.tmp")) and not list(tmp_path.glob("*.so"))
    _permanent(ei.value)


def _unbuildable(how, monkeypatch, tmp_path):
    """Make ``build.library`` fail with an ``OSError`` of one kind, on the
    path it runs: the build directory cannot be made, ``nvcc`` cannot be
    started, or the built library does not load."""
    monkeypatch.setattr(build, "_libs", {})
    if how == "mkdir":
        (tmp_path / "file").write_text("")
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "file" / "build")
        return
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    if how == "exec":
        nvcc = tmp_path / "nvcc"
        nvcc.write_text("#!/bin/sh\n")
        nvcc.chmod(0o644)  # not executable
        monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    elif how == "load":
        for name in build.SOURCES:
            build.library_path(name).write_bytes(b"not a shared library")


@pytest.mark.parametrize("how", ["mkdir", "exec", "load"])
def test_an_unbuildable_or_unloadable_library_is_a_permanent_kernel_error(how, monkeypatch, tmp_path):
    _unbuildable(how, monkeypatch, tmp_path)
    with pytest.raises(build.KernelError, match="csrc/scube.cu") as ei:
        build.library("scube")
    assert isinstance(ei.value.__cause__, OSError)
    assert "scube" not in build._libs and not list(tmp_path.glob("*.tmp"))
    _permanent(ei.value)
    # the OSError alone would be a transient host fault
    assert classify_exception(ei.value.__cause__, "execute").transient
    if how != "load":
        with pytest.raises(build.KernelError, match="cannot build the kernel libraries"):
            build.build_all()


@pytest.mark.parametrize("code", [1, 2, 700, 719])
def test_launcher_error_is_a_permanent_kernel_error(code):
    with pytest.raises(build.KernelError, match=f"cudaError_t {code}") as ei:
        build.check(code, "scube")
    _permanent(ei.value)
    build.check(0, "scube")  # success raises nothing


def test_accelerator_error_is_permanent():
    if not hasattr(torch, "AcceleratorError"):
        pytest.skip("this torch has no AcceleratorError")
    exc = torch.AcceleratorError("CUDA error: an error the runtime reports")
    assert is_kernel_fault(exc)
    _permanent(exc)


@pytest.mark.parametrize("message", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
])
def test_sticky_cuda_errors_are_permanent(message):
    exc = RuntimeError(message)
    assert is_kernel_fault(exc)
    _permanent(exc)
    # the reference has no card, so no such rule: it retries them
    assert ref_classify(exc, "execute").transient


@pytest.mark.parametrize("exc_type", [InjectedDispatchError, RefInjectedDispatchError])
def test_injected_dispatch_error_stays_transient(exc_type):
    exc = exc_type("injected dispatch fault (uid=req-1)")
    err = classify_exception(exc, "execute")
    assert type(err) is DeviceDispatchError and err.transient and err.retryable
    assert type(err).__name__ == type(ref_classify(exc, "execute")).__name__


def test_other_runtime_errors_stay_transient_and_oom_bisects():
    assert type(classify_exception(RuntimeError("cuFFT plan failed"), "execute")) is DeviceDispatchError
    oom = classify_exception(InjectedOOM(), "execute")
    assert type(oom) is ResourceExhausted and oom.disposition == "bisect"
    assert type(classify_exception(torch.cuda.OutOfMemoryError("CUDA out of memory"), "execute")) is ResourceExhausted
