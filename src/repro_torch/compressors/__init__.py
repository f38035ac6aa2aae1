"""Error-bounded base compressors, reimplemented in numpy (paper §V-A).

All compressors satisfy the pointwise contract ``|decompress(compress(x, E)) -
x| <= E`` and are pluggable into :class:`repro_torch.core.ffcz.FFCz`.
"""

from repro_torch.compressors.identity import IdentityCompressor
from repro_torch.compressors.szlike import SZLikeCompressor
from repro_torch.compressors.zfplike import SperrLikeCompressor, ZFPLikeCompressor

_REGISTRY = {
    "szlike": SZLikeCompressor,
    "zfplike": ZFPLikeCompressor,
    "sperrlike": SperrLikeCompressor,
    "identity": IdentityCompressor,
}


def get_compressor(name: str, **kwargs):
    """Instantiate a registered base compressor by name."""
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown base compressor {name!r}; have {sorted(_REGISTRY)}") from None


__all__ = [
    "SZLikeCompressor",
    "ZFPLikeCompressor",
    "SperrLikeCompressor",
    "IdentityCompressor",
    "get_compressor",
]
