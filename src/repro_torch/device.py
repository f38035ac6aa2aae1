"""Device resolution for the port's entry points: explicit, never a fallback."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return the device a caller asked for; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is requested (explicitly or by
    default) and PyTorch sees none — the port never silently runs on the CPU.
    Pass ``device="cpu"`` to run the kernels' plain PyTorch twins.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
