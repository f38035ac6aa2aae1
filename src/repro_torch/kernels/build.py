"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(``extern "C"`` launchers returning the ``cudaError_t`` of
``cudaGetLastError()``), compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

plus the source's own flags in :data:`SOURCE_FLAGS`, into ``build/repro_torch/``
at the root of the checkout.  The library's file name carries a hash of its
source, every ``csrc/*.cuh`` header and its flags, so an edited source or
header rebuilds and an unchanged one loads as is; the compiler's output is
kept beside it (:func:`build_log`).  Nothing builds at import: the first
launch of a kernel builds its library (or :func:`build_all` builds every one,
one ``nvcc`` process per source, all started together).

The module also holds the launch plumbing every wrapper shares: operand
checks (:func:`check_cuda`), aligned copies (:func:`aligned`), bound operands
(:func:`bound_operand`) and the error check after a launch (:func:`check`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
#: one shared library per source (each includes csrc/common.cuh or csrc/sm90.cuh)
SOURCES = ("scube", "fcube", "rfft", "flash_attention", "quantize", "block_transform")
#: flags of one source only: ptxas's register and spill report of the flash and
#: block-transform kernels (``chip_smoke.py`` reads it from :func:`build_log`)
SOURCE_FLAGS = {"flash_attention": ("-Xptxas", "-v"), "block_transform": ("-Xptxas", "-v")}

_P, _F, _I, _L = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
#: argtypes of each library's launchers (pointers and the stream as c_void_p)
SIGNATURES = {
    "scube": {"scube_launch": (_P, _P, _F, _I, _L, _P, _P, _L, _P)},
    "fcube": {
        "fcube_launch": (_P, _P, _F, _I, _F, _F, _L, _I, _I, _P, _P, _P, _L, _P),
        "fcube_rows_launch": (_P, _P, _F, _I, _F, _F, _L, _L, _I, _I, _P, _P, _P, _P),
    },
    "rfft": {
        "rfft_fwd_epilogue_launch": (
            _P, _P, _F, _I, _P, _F, _F, _I, _L, _L, _L, _L, _P, _P, _P, _P, _P,
        ),
        "rfft_fwd_epilogue_rows_launch": (
            _P, _P, _F, _I, _P, _F, _F, _I, _L, _L, _P, _P, _P, _P, _P,
        ),
    },
    "quantize": {"quantize_launch": (_P, _P, _F, _I, _F, _P, _P, _L, _P)},
    "block_transform": {"block_transform_launch": (_P, _P, _F, _I, _L, _P, _P)},
    "flash_attention": {
        "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P)
    },
}

#: the kernels index in 32 bits
MAX_NUMEL = 2**31 - 1

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("repro_torch: nvcc not found (needs the CUDA toolkit)")
    return found


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags of source ``name``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built for its current sources."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc printed when it built library ``name`` (building it first
    if needed)."""
    library(name)
    return library_path(name).with_suffix(".log").read_text()


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for ``name`` unless its library is built; (proc, tmp, out)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name, suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started: Optional[tuple]) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"repro_torch: nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file


def build_all() -> float:
    """Build every library whose sources changed, one nvcc per source in
    parallel; returns the wall seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, s in started.items():
            _finish(name, s)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its launchers' ``argtypes`` set,
    building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} launch failed with cudaError_t {err}")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    element count fits the kernels' 32-bit index space."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() > MAX_NUMEL:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels take < 2^31")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its first element is 16-byte aligned, else a contiguous copy
    of it (a fresh allocation, which is): a view at an odd storage offset
    cannot feed a bulk copy or a 16-byte vector load."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def is_row_bound(b, shape) -> bool:
    """True when ``b`` is one bound per row of ``shape``: an array of shape
    ``shape[:-1] + (1,)`` (the per-pencil layout of the batched loop)."""
    return getattr(b, "ndim", 0) > 0 and len(shape) > 0 and (
        tuple(b.shape) == tuple(shape[:-1]) + (1,)
    )


def bound_operand(b, shape, device, rows: bool = False) -> Tuple[Optional[torch.Tensor], float, int]:
    """``(operand, scalar, mode)`` kernel operands of a scalar or array bound.

    A scalar bound (mode 0) is passed by value, rounded to float32 (a Python
    float costs nothing; a 0-d CUDA tensor is read back, which waits for the
    device — the POCS loop keeps its scalar bounds on the host).  With
    ``rows`` an array bound must be one value per row (:func:`is_row_bound`)
    and becomes a contiguous float32 vector of ``prod(shape[:-1])`` values
    (mode 2); otherwise it becomes a contiguous float32 grid of ``shape``
    (mode 1).  All on ``device``.
    """
    if getattr(b, "ndim", 0) == 0:
        return None, float(np.float32(float(b))), 0
    t = torch.as_tensor(b, dtype=torch.float32, device=device)
    if rows:
        if not is_row_bound(t, shape):
            raise ValueError(f"a per-row bound must have shape {tuple(shape[:-1]) + (1,)}, "
                             f"got {tuple(t.shape)}")
        return t.reshape(-1).contiguous(), 0.0, 2
    return torch.broadcast_to(t, shape).contiguous(), 0.0, 1
