"""The port's base compressors write the reference's bytes exactly."""

import numpy as np
import pytest

from repro.compressors import get_compressor as r_get
from repro_torch.compressors import get_compressor as t_get


@pytest.mark.parametrize("name", ["identity", "szlike", "zfplike", "sperrlike"])
@pytest.mark.parametrize("shape", [(24, 24, 24), (40, 35), (16, 16, 17)], ids=str)
def test_base_blobs_identical(name, shape):
    rng = np.random.default_rng(sum(shape))
    x = np.ascontiguousarray((rng.standard_normal(shape) * 0.5 + 4.0).cumsum(axis=0), np.float32)
    E = float(np.ptp(x)) * 1e-3
    blob = r_get(name).compress(x, E)
    assert t_get(name).compress(x, E) == blob
    dec = t_get(name).decompress(blob)
    assert np.array_equal(dec, r_get(name).decompress(blob))
    assert np.abs(dec.astype(np.float64) - x).max() <= E


def test_unknown_compressor_raises():
    with pytest.raises(ValueError, match="unknown base compressor"):
        t_get("nope")
