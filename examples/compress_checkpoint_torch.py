"""FFCz as training infrastructure, through the PyTorch port: compress a real
model checkpoint with dual-domain bounds and measure size + restore fidelity.

    PYTHONPATH=src:. python examples/compress_checkpoint_torch.py
    PYTHONPATH=src:. python examples/compress_checkpoint_torch.py --device cpu
    PYTHONPATH=src:. python examples/compress_checkpoint_torch.py --fft-impl pallas

The same run through the JAX reference is ``examples/compress_checkpoint.py``:
the smoke qwen2-7b config, its parameters in the reference's tree layout
(``convert.lm_params_to_reference``: the checkpoint restores in either
package), the same codec settings and printed lines.  ``--device`` defaults
to ``cuda`` (the port does not fall back to the CPU); ``--fft-impl pallas``
runs the codec's batched correction through kernels 3p/4p.  After the
reference's lines it prints whether every compressed leaf restored within
the E stored in its header, and the hand-written kernels' launches.
"""

import argparse
import os
import struct
import tempfile

import torch

from repro_torch import tree
from repro_torch.checkpoint.codec import CheckpointCodec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_to_reference
from repro_torch.core.engine import CorrectionEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counters
from repro_torch.models.model import build_model


def stored_E(step_dir: str, i: int):
    """The E a compressed (``B``) leaf's header stores; None for a raw one."""
    with open(os.path.join(step_dir, f"{i}.bin"), "rb") as f:
        data = f.read(1 + struct.calcsize("<BddIB"))
    return struct.unpack_from("<BddIB", data, 1)[1] if data[:1] == b"B" else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fft-impl", default="xla", choices=["xla", "packed", "pallas"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke_config("qwen2-7b")
    model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    params = lm_params_to_reference({k: v.detach() for k, v in model.state_dict().items()}, cfg)
    leaves = tree.leaves(params)
    raw_bytes = sum(l.numel() * l.element_size() for l in leaves)
    engine = CorrectionEngine(fft_impl=args.fft_impl, device=dev)
    before = {k: n for c in launch_counters() for k, n in c.items()}

    within = []
    for enabled, label in ((False, "raw"), (True, "ffcz(E_rel=1e-4)")):
        codec = CheckpointCodec(enabled=enabled, E_rel=1e-4, Delta_rel=1e-4, engine=engine)
        with tempfile.TemporaryDirectory() as td:
            mgr = CheckpointManager(td, codec=codec)
            mgr.save(0, params)
            stored = sum(
                os.path.getsize(os.path.join(td, d, f))
                for d in os.listdir(td)
                for f in os.listdir(os.path.join(td, d))
            )
            got = tree.leaves(mgr.restore(0, tree.map_leaves(lambda t: t.to("meta"), params)))
            errs = [float((a.detach().cpu().double() - b.double()).abs().max()) for a, b in zip(leaves, got)]
            err = max(errs)
            if enabled:
                step_dir = os.path.join(td, os.listdir(td)[0])
                Es = [stored_E(step_dir, i) for i in range(len(leaves))]
                within = [(e, E) for e, E in zip(errs, Es) if E is not None]
        print(f"{label:20s}: {stored/1e6:7.2f} MB (raw {raw_bytes/1e6:.2f} MB, "
              f"{raw_bytes/stored:.2f}x), max restore err {err:.2e}")
    print("note: random-init weights are near-incompressible (max-entropy); on trained\n"
          "checkpoints the prediction/transform stages find structure — the dual-domain\n"
          "guarantee (pointwise + spectral) is the point, the ratio follows the data.")
    worst = max(e / E for e, E in within) if within else 0.0
    print(f"compressed leaves: {len(within)}, every restore error within its stored E: "
          f"{all(e <= E for e, E in within)} (worst err/E {worst:.4f})")
    launched = {k: n - before[k] for c in launch_counters() for k, n in c.items() if n != before[k]}
    print(f"fft_impl={args.fft_impl} kernel launches: {launched}")


if __name__ == "__main__":
    main()
