"""Quickstart through the PyTorch port: dual-domain error-bounded compression
of a cosmology-like field.

    PYTHONPATH=src:. python examples/quickstart_torch.py                  # on the card
    PYTHONPATH=src:. python examples/quickstart_torch.py --device cpu --quick

Compresses a synthetic Nyx-like Gaussian random field (power-law spectrum)
with SZ3-like base + FFCz correction, prints both guarantees and the storage
breakdown, and verifies the power spectrum stays in the ribbon.  On the card
``--fft-impl pallas`` (the default there) runs the POCS loop's fused CUDA
kernels.  The same run through the JAX reference is ``examples/quickstart.py``.
"""

import argparse

import numpy as np

from repro_torch.compressors import get_compressor
from repro_torch.configs.ffcz_fields import FieldConfig
from repro_torch.core import FFCz, FFCzConfig
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.spectrum import bitrate, power_spectrum_relative_error, psnr, ssnr_spatial
from repro_torch.data.fields import make_field


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="small field + one base compressor")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fft-impl", default=None, choices=["xla", "packed", "pallas"],
                    help="POCS transforms (default: pallas on the card, xla on the CPU)")
    args = ap.parse_args()
    fft_impl = args.fft_impl or ("pallas" if args.device != "cpu" else "xla")
    engine = CorrectionEngine(device=args.device)

    if args.quick:
        x = make_field(FieldConfig("quick", (24, 24, 24), "powerlaw", alpha=2.0))
        bases, max_iters = ("szlike",), 300
    else:
        x = make_field("nyx-like")
        bases, max_iters = ("szlike", "zfplike", "sperrlike"), 1500
    print(f"field: {'quick' if args.quick else 'nyx-like'} {x.shape} "
          f"({x.nbytes/1e6:.1f} MB float32) on {engine.device}, fft_impl={fft_impl}")

    for base_name in bases:
        codec = FFCz(get_compressor(base_name),
                     FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, max_iters=max_iters, fft_impl=fft_impl),
                     engine=engine)
        xh, blob = codec.roundtrip(x)
        st = blob.stats
        print(f"\n=== base={base_name} ===")
        print(f"  POCS iterations      : {st.iterations} (converged={st.converged})")
        print(f"  active edits         : {st.n_active_spatial} spatial, {st.n_active_frequency} frequency")
        print(f"  bytes                : base={st.base_bytes}, edits={st.edit_bytes} "
              f"({100*st.edit_bytes/st.total_bytes:.1f}% overhead)")
        print(f"  compression ratio    : {x.nbytes/st.total_bytes:.1f}x  "
              f"(bitrate {bitrate(st.total_bytes, x.size):.4f} bits/value)")
        print(f"  spatial margin       : {st.spatial_margin:.3e} (>=0 -> |eps| <= E everywhere)")
        print(f"  frequency margin     : {st.frequency_margin:.3e} (>=0 -> |Re/Im delta| <= Delta everywhere)")
        print(f"  PSNR / SSNR          : {float(psnr(xh, x)):.1f} dB / {float(ssnr_spatial(xh, x)):.1f} dB")

    # power-spectrum-preserving mode (paper Observation 4)
    codec = FFCz(get_compressor("szlike"),
                 FFCzConfig(E_rel=1e-3, Delta_rel=None, pspec_rel=1e-3,
                            max_iters=300 if args.quick else 2500, fft_impl=fft_impl),
                 engine=engine)
    xh, blob = codec.roundtrip(x)
    _, rel = power_spectrum_relative_error(xh, x)
    print("\n=== power-spectrum mode (pspec_rel=0.1%) ===")
    print(f"  max |P_hat(k)-P(k)|/P(k) over shells: {np.abs(rel[1:]).max():.2e} "
          f"(ribbon: 1.0e-03) -> {'WITHIN' if np.abs(rel[1:]).max() <= 1.05e-3 else 'OUTSIDE'}")


if __name__ == "__main__":
    main()
