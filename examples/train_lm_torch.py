"""End-to-end training through the PyTorch port: the fault-tolerant
runtime, optional FFCz gradient + checkpoint compression.

    # fast CPU demo (reduced config):
    PYTHONPATH=src:. python examples/train_lm_torch.py --arch qwen2-0.5b --steps 50 --device cpu

    # ~100M-param run on the card:
    PYTHONPATH=src:. python examples/train_lm_torch.py --arch qwen2-0.5b --preset 100m --steps 300

    # the full published config on one card:
    PYTHONPATH=src:. python examples/train_lm_torch.py --arch qwen2-0.5b --preset full \\
        --seq-len 2048 --global-batch 4 --steps 20 --grad-compression

``--device`` defaults to ``cuda`` (the port does not fall back to the CPU).
The same run through the JAX reference is ``examples/train_lm.py``.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import CompressionConfig, get_config, get_smoke_config
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def build_cfg(arch: str, preset: str, grad_comp: bool, ckpt_comp: bool):
    if preset == "smoke":
        cfg = get_smoke_config(arch)
    elif preset == "100m":
        # ~100M params in the arch's own family
        cfg = dataclasses.replace(
            get_smoke_config(arch),
            n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab=32000, dtype="float32",
        )
    elif preset == "full":
        cfg = get_config(arch)
    else:
        raise SystemExit(f"unknown preset {preset}")
    comp = CompressionConfig(
        grad_compression=grad_comp, checkpoint_compression=ckpt_comp,
        grad_E_rel=1e-2, grad_Delta_rel=1e-1, ckpt_E_rel=1e-5, ckpt_Delta_rel=1e-5,
    )
    return dataclasses.replace(cfg, compression=comp)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = build_cfg(args.arch, args.preset, args.grad_compression, args.ckpt_compression)
    run = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=10,
    )
    tr = Trainer(cfg, run, device=args.device)
    print(f"training {args.arch} [{args.preset}] on {tr.device} from step {tr.start_step} for {args.steps} steps")
    out = tr.train(args.steps)
    for m in out["metrics"]:
        print(f"  step {m['step']:6d}  loss {m['loss']:.4f}  ({m['dt']*1e3:.0f} ms/step)")
    print(f"final step {out['final_step']}, loss {out['final_loss']:.4f}; "
          f"straggler events: {len(out['straggler_events'])}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
