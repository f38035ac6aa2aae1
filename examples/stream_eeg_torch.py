"""Stream a multi-channel EEG recording through the port's temporal codec.

    PYTHONPATH=src:. python examples/stream_eeg_torch.py                          # on the card
    PYTHONPATH=src:. python examples/stream_eeg_torch.py --quick --device cpu     # tiny, no card

The PyTorch twin of ``examples/stream_eeg.py``.  Each frame is ``(channels,
samples)``, so the stream routes through the engine's pencil path with one
pencil per channel row.  The demo:

1. synthesizes a slowly evolving multi-channel recording (per-channel 1/f
   "pink" noise plus a drifting shared component),
2. compresses it with ``TemporalCodec`` (linear predictor, keyframe every 8
   frames, ``warm_start=True``; on the card ``fft_impl="pallas"`` runs the
   per-pencil CUDA kernels of the POCS loop),
3. rechecks BOTH claimed bounds on every decoded frame in float64 against
   the stream header's (E, Delta),
4. seeks to a frame through the ``FFCS`` index and checks the seek decode
   is bitwise the sequential decode,
5. prints per-frame POCS iterations (residual frames warm-start from the
   previous frame's edit spectrum, which stays on the device).
"""

import argparse

import numpy as np

from repro_torch.compressors import get_compressor
from repro_torch.configs.ffcz_fields import FieldConfig
from repro_torch.core import FFCzConfig, TemporalCodec, TemporalConfig, TemporalStream
from repro_torch.core.engine import CorrectionEngine
from repro_torch.data.fields import make_field


def make_eeg_frames(n_frames: int, channels: int, samples: int, seed: int = 0):
    """Coherent synthetic EEG: per-channel pink noise + a drifting shared mode
    (``examples/stream_eeg.py``'s recording, value for value)."""
    rng = np.random.default_rng(seed)
    chans = np.stack([
        make_field(FieldConfig(f"ch{c}", (samples,), "pink", alpha=1.0, seed=seed + c))
        for c in range(channels)
    ])
    shared = make_field(FieldConfig("shared", (samples,), "pink", alpha=1.0, seed=seed + 999))
    drift = 0.03 * rng.standard_normal((channels, 1)).astype(np.float32)
    frames = []
    for t in range(n_frames):
        wobble = 0.01 * rng.standard_normal((channels, samples)).astype(np.float32)
        frames.append((chans + (t * drift) * shared + wobble).astype(np.float32))
    return frames


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="tiny stream")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--fft-impl", default=None, choices=["xla", "packed", "pallas"],
                    help="POCS transforms (default: pallas on the card, xla on the CPU)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    args = ap.parse_args()

    n_frames = args.frames or (6 if args.quick else 24)
    channels = args.channels or (4 if args.quick else 16)
    samples = args.samples or (64 if args.quick else 512)
    fft_impl = args.fft_impl or ("pallas" if args.device != "cpu" else "xla")

    frames = make_eeg_frames(n_frames, channels, samples)
    raw_bytes = sum(f.nbytes for f in frames)
    engine = CorrectionEngine(device=args.device)
    print(f"stream: {n_frames} frames x ({channels} ch, {samples} samples) "
          f"= {raw_bytes/1e3:.1f} kB float32 on {engine.device}, fft_impl={fft_impl}")

    codec = TemporalCodec(
        get_compressor("szlike"),
        FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, max_iters=300, warm_start=True, fft_impl=fft_impl),
        # block=0 -> one pencil per channel row (the EEG routing)
        stream=TemporalConfig(mode="pencils", predictor="linear", keyframe_interval=8),
        engine=engine,
    )
    enc = codec.open_stream()
    for f in frames:
        enc.add_frame(f)
    blob = enc.finish()
    print(f"FFCS container: {len(blob)} bytes ({raw_bytes/len(blob):.1f}x)")

    stream = TemporalStream.from_bytes(blob)
    E0, D0 = stream.E, stream.Delta
    decoded = codec.decompress_stream(blob)
    worst_e = worst_d = 0.0
    for t, (x, xh) in enumerate(zip(frames, decoded)):
        eps = xh.astype(np.float64) - x.astype(np.float64)
        flat = eps.reshape(-1)
        tiles = np.pad(flat, (0, (-flat.size) % stream.block)).reshape(-1, stream.block)
        d = np.fft.rfft(tiles, axis=-1)
        e, dm = np.abs(eps).max(), max(np.abs(d.real).max(), np.abs(d.imag).max())
        worst_e, worst_d = max(worst_e, e), max(worst_d, dm)
        kind = "KEY" if stream.is_keyframe(t) else "res"
        print(f"  frame {t:2d} [{kind}]  pocs_iters={enc.frame_stats[t]['iterations']:3d}  "
              f"|eps|={e:.3e}  |dhat|={dm:.3e}")
        assert e <= E0 and dm <= D0, f"frame {t} violated the stream bound"
    print(f"bounds held on every frame: worst |eps|={worst_e:.3e} <= E={E0:.3e}, "
          f"worst |dhat|={worst_d:.3e} <= Delta={D0:.3e}")

    t_seek = n_frames - 2
    k = stream.latest_keyframe(t_seek)
    assert np.array_equal(codec.decode_frame(blob, t_seek), decoded[t_seek])
    print(f"seek to frame {t_seek}: decoded {t_seek - k + 1} frames "
          f"(keyframe {k} -> {t_seek}), bitwise == sequential decode")

    cold = [s["iterations"] for s in enc.frame_stats if s["keyframe"]]
    warm = [s["iterations"] for s in enc.frame_stats if not s["keyframe"]]
    if warm:
        print(f"POCS iterations: keyframes (cold) mean {np.mean(cold):.1f}, "
              f"residuals (warm) mean {np.mean(warm):.1f}")


if __name__ == "__main__":
    main()
