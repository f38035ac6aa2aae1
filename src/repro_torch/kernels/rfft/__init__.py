"""Pack-trick rFFT transforms + the loop's fused forward/inverse epilogues."""

from repro_torch.kernels.rfft.ops import (
    fwd_epilogue_fused,
    fwd_epilogue_plain,
    mirror_half_spectrum,
    packed_irfft,
    packed_irfftn,
    packed_rfftn,
    supports_packed,
    twiddle_plan,
    unpack_sclip_fused,
    unpack_sclip_plain,
)

__all__ = [
    "fwd_epilogue_fused",
    "fwd_epilogue_plain",
    "mirror_half_spectrum",
    "packed_irfft",
    "packed_irfftn",
    "packed_rfftn",
    "supports_packed",
    "twiddle_plan",
    "unpack_sclip_fused",
    "unpack_sclip_plain",
]
