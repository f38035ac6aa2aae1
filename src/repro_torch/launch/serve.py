"""Serve entry point: batched greedy decode over a stream of random prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-mistral-7b --preset full \
        --kv-compression

``--arch`` takes every arch of the registry (dense, moe, ssm, hybrid, vlm,
audio); ``--preset full`` is the published config with random weights from
a seed, ``smoke`` the reduced one.  The vlm and audio requests carry zero
patches or frames (the engine's stubs).  ``--device`` defaults to ``cuda``
(the port does not fall back to the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import PORTED_ARCH_IDS, CompressionConfig, get_config, get_smoke_config
from repro_torch.serving.engine import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=PORTED_ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--kv-compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.preset == "full" else get_smoke_config(args.arch)
    cfg = dataclasses.replace(
        cfg, compression=CompressionConfig(kv_cache_compression=args.kv_compression)
    )
    eng = ServingEngine(cfg, ServeConfig(max_batch=args.max_batch), device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 20))),
                   max_new_tokens=args.max_new_tokens)
    served = 0
    while eng.queue:
        for r in eng.step():
            served += 1
            print(f"uid={r['uid']}: {r['tokens']}")
    print(f"served {served} requests")


if __name__ == "__main__":
    main()
