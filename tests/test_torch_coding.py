"""The port's host codecs are byte-identical copies of the reference's.

Seeded numpy inputs go through ``repro.coding`` / ``repro.core.edits`` and
their ``repro_torch`` counterparts; every output must match byte for byte
(encoders) or element for element (decoders), and each package must decode
the other's bytes.
"""

import numpy as np
import pytest

from repro.coding import bitpack as r_bitpack
from repro.coding import huffman as r_huffman
from repro.coding import lossless as r_lossless
from repro.coding import quantize as r_quantize
from repro.core import edits as r_edits
from repro_torch.coding import bitpack as t_bitpack
from repro_torch.coding import huffman as t_huffman
from repro_torch.coding import lossless as t_lossless
from repro_torch.coding import quantize as t_quantize
from repro_torch.core import edits as t_edits


def _symbols(seed, n=3000):
    rng = np.random.default_rng(seed)
    return np.rint(rng.standard_normal(n) * 40).astype(np.int64)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 1001])
def test_bitpack_identical(n):
    flags = np.random.default_rng(n).random(n) < 0.3
    packed = r_bitpack.pack_bits(flags)
    assert t_bitpack.pack_bits(flags) == packed
    assert np.array_equal(t_bitpack.unpack_bits(packed, n), r_bitpack.unpack_bits(packed, n))


@pytest.mark.parametrize("seed", [0, 1])
def test_huffman_identical_both_ways(seed):
    s = _symbols(seed)
    data = r_huffman.huffman_encode(s)
    assert t_huffman.huffman_encode(s) == data
    assert np.array_equal(t_huffman.huffman_decode(data), s)
    assert np.array_equal(r_huffman.huffman_decode(t_huffman.huffman_encode(s)), s)


@pytest.mark.parametrize("codec", ["huffman+zlib", "zlib"])
def test_lossless_identical(codec):
    s = _symbols(7)
    data = r_lossless.lossless_compress(s, codec=codec)
    assert t_lossless.lossless_compress(s, codec=codec) == data
    assert np.array_equal(t_lossless.lossless_decompress(data), s)


@pytest.mark.parametrize("m", [8, 16, 30])
def test_quantize_identical(m):
    rng = np.random.default_rng(m)
    v = rng.uniform(-1, 1, 500)
    bound = rng.uniform(0.5, 1.0, 500)
    for b in (0.75, bound):
        codes = r_quantize.quantize_uniform(v, b, m)
        assert np.array_equal(t_quantize.quantize_uniform(v, b, m), codes)
        assert np.array_equal(
            t_quantize.dequantize_uniform(codes, b, m), r_quantize.dequantize_uniform(codes, b, m)
        )


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("codec", ["huffman+zlib", "zlib"])
def test_edits_identical(complex_, codec):
    rng = np.random.default_rng(3)
    e = rng.standard_normal((12, 9)) * (rng.random((12, 9)) < 0.2)
    if complex_:
        e = e + 1j * rng.standard_normal((12, 9)) * (rng.random((12, 9)) < 0.2)
    bound = 2.5
    enc_r = r_edits.encode_edits(e, bound, m=14, codec=codec, half_spectrum=complex_)
    enc_t = t_edits.encode_edits(e, bound, m=14, codec=codec, half_spectrum=complex_)
    assert enc_t.to_bytes() == enc_r.to_bytes()
    back = t_edits.EncodedEdits.from_bytes(enc_r.to_bytes())
    assert np.array_equal(t_edits.decode_edits(back, bound), r_edits.decode_edits(enc_r, bound))
