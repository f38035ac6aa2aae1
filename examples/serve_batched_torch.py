"""End-to-end serving driver through the PyTorch port: batched requests
through the decode engine, with and without FFCz KV-cache compression.

    PYTHONPATH=src:. python examples/serve_batched_torch.py --arch qwen2-0.5b --requests 6
    PYTHONPATH=src:. python examples/serve_batched_torch.py --device cpu
    PYTHONPATH=src:. python examples/serve_batched_torch.py --attention-impl pallas --fft-impl pallas

The same run through the JAX reference is ``examples/serve_batched.py``:
the same arguments, smoke configs, request stream (numpy seed 0) and
printed lines.  ``--device`` defaults to ``cuda`` (the port does not fall
back to the CPU).  ``--attention-impl pallas`` runs the prefill's attention
through the flash kernel, ``--fft-impl pallas`` the KV compression's
correction through kernels 3p/4p (the defaults, ``xla_flash`` and ``xla``,
are the reference's).  The last line gives the hand-written kernels'
launches in the run.
"""

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import CompressionConfig, get_smoke_config
from repro_torch.core.engine import CorrectionEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counters
from repro_torch.serving.engine import ServeConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--attention-impl", default="xla_flash", choices=["xla_flash", "pallas", "naive"])
    ap.add_argument("--fft-impl", default="xla", choices=["xla", "packed", "pallas"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    base = get_smoke_config(args.arch, attention_impl=args.attention_impl)
    engine = CorrectionEngine(fft_impl=args.fft_impl, device=dev)
    before = {k: n for c in launch_counters() for k, n in c.items()}

    for kv_comp in (False, True):
        if kv_comp and base.family == "ssm":
            print("kv compression inapplicable to attention-free arch (no KV cache); skipping")
            continue
        cfg = dataclasses.replace(
            base, compression=CompressionConfig(kv_cache_compression=kv_comp,
                                                kv_E_rel=1e-3, kv_Delta_rel=1e-2)
        )
        eng = ServingEngine(cfg, ServeConfig(max_batch=args.max_batch), rng_seed=0, device=dev, engine=engine)
        for i in range(args.requests):
            plen = int(rng.integers(4, 16))
            eng.submit(rng.integers(0, cfg.vocab, plen), max_new_tokens=args.max_new_tokens)
        t0 = time.perf_counter()
        done = []
        while eng.queue:
            done += eng.step()
        dt = time.perf_counter() - t0
        tok_s = sum(len(r["tokens"]) for r in done) / dt
        print(f"kv_compression={kv_comp}: served {len(done)} requests, "
              f"{tok_s:.1f} tok/s")
        for r in done[:3]:
            print(f"  uid={r['uid']}: {r['tokens']}")
    launched = {k: n - before[k] for c in launch_counters() for k, n in c.items() if n != before[k]}
    print(f"attention_impl={args.attention_impl} fft_impl={args.fft_impl} kernel launches: {launched}")


if __name__ == "__main__":
    main()
