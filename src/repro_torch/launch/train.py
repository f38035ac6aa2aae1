"""Train entry point: the fault-tolerant Trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --preset smoke \\
        --steps 100 --ckpt-dir <dir> --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --preset full \\
        --seq-len 2048 --global-batch 4 --steps 10 --grad-compression
    PYTHONPATH=src python -m repro_torch.launch.train --arch llava-next-mistral-7b --preset full \\
        --n-layers 4 --seq-len 4928 --global-batch 2 --steps 3 --grad-compression

Every arch of ``repro_torch.configs.ARCH_IDS`` trains (all six families).  A
vlm's ``--seq-len`` counts its ``vision_tokens`` patch positions and must
exceed them (SMOKE llava has 16, the full one 2880).  ``--n-layers`` cuts
the depth of a full-width model so its training state fits one card;
llama4-maverick trains at SMOKE only (its full width needs the sharded
port).  The FFCz corrections of the gradients and checkpoints run through
a ``fft_impl="pallas"`` engine: the per-pencil CUDA kernels (their plain
twins on the CPU).  ``--device`` defaults to ``cuda`` (the port does not
fall back to the CPU).
Restart-from-checkpoint, straggler tracking, and FFCz gradient / checkpoint
compression are wired through the same Trainer the tests use.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import CompressionConfig, get_config, get_smoke_config
from repro_torch.core.engine import CorrectionEngine
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_run"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-compression", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None, help="cut the depth (widths stay the preset's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    depth = {} if args.n_layers is None else {"n_layers": args.n_layers}
    cfg = get_config(args.arch, **depth) if args.preset == "full" else get_smoke_config(args.arch, **depth)
    cfg = dataclasses.replace(
        cfg,
        compression=CompressionConfig(
            grad_compression=args.grad_compression,
            checkpoint_compression=args.ckpt_compression,
        ),
    )
    run = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, inject_failure_at=args.inject_failure_at,
    )
    tr = Trainer(cfg, run, device=args.device, engine=CorrectionEngine(fft_impl="pallas", device=args.device))
    out = tr.train(args.steps)
    print(f"done: step={out['final_step']} loss={out['final_loss']:.4f} "
          f"stragglers={len(out['straggler_events'])}")


if __name__ == "__main__":
    main()
