"""Entropy coding and bit packing for FFCz edit streams and base compressors."""

from repro_torch.coding.bitpack import pack_bits, unpack_bits
from repro_torch.coding.huffman import huffman_decode, huffman_encode
from repro_torch.coding.lossless import lossless_compress, lossless_decompress
from repro_torch.coding.quantize import dequantize_uniform, quantize_uniform

__all__ = [
    "pack_bits",
    "unpack_bits",
    "huffman_encode",
    "huffman_decode",
    "lossless_compress",
    "lossless_decompress",
    "quantize_uniform",
    "dequantize_uniform",
]
