"""Causal GQA flash-attention forward: CUDA kernel wrapper + twin.

Replaces ``repro/kernels/flash_attention`` (the ``_flash_kernel`` Pallas
kernel and its ``flash_attention`` wrapper).  The kernels are in
``csrc/flash_attention.cu``, both on the tensor cores (wgmma fed by TMA):
bfloat16 directly, float32 in split TF32 (each operand as a TF32 hi + lo
pair, three products a product) after a prologue that writes the split
operands into scratch this wrapper allocates; their plain twin is
:func:`ref.attention_ref`.  The reference pads sq and sk up to its block
sizes; the kernels mask the ragged edges themselves, so the wrapper copies
nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches by wrapper (reset it to 0 to count a run's launches)
launches = {"flash_attention": 0}

#: head dims the kernels are instantiated for, by dtype (16, the smoke
#: configs' head dim, on the float32 kernel only)
HEAD_DIMS = {torch.float32: (16, 64, 112, 128), torch.bfloat16: (64, 112, 128)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA attention; shapes (b, hq, sq, d) / (b, hkv, sk, d).

    CPU tensors take :func:`attention_ref`; CUDA tensors launch the kernel
    (float32 or bfloat16, contiguous, d in the dtype's :data:`HEAD_DIMS`; bfloat16
    operands 16-byte aligned, as TMA reads them) or raise.  The kernel has no
    backward: a call that autograd would have to differentiate raises
    instead of returning an output with no gradient.
    """
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError("suffix-causal attention requires sq <= sk")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention has no backward kernel; call it under torch.no_grad()")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(t, name, q.dtype)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (b, hkv, sk, {d}) with b={b}, got {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS[q.dtype]:
        raise NotImplementedError(f"head_dim {d}: the {q.dtype} kernel is built for {HEAD_DIMS[q.dtype]}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA requires hq % hkv == 0, got hq={hq}, hkv={hkv}")
    if sk == 0:
        raise ValueError("attention over an empty kv sequence")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the TMA loads, "
                                 f"got address {t.data_ptr():#x}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("flash_attention")
    dtype = _DTYPES[q.dtype]
    # float32: the split operands (q, k hi/lo; v transposed, hi/lo)
    n_scratch = lib.flash_attention_scratch_floats(b, hq, hkv, sq, sk, d, dtype)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device) if n_scratch else None
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, n_scratch,
        b, hq, hkv, sq, sk, d, dtype, scale, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err < 0:
        raise build.KernelError(f"repro_torch: flash_attention: cuTensorMapEncodeTiled failed with CUresult {-err}")
    build.check(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
