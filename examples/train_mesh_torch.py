"""Training over a data mesh through the PyTorch port: FSDP over N ranks.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        examples/train_mesh_torch.py [--arch qwen2-0.5b] [--preset full|smoke] [--n-layers L] \\
        [--seq-len S] [--global-batch B] [--steps K] [--grad-compression] \\
        [--digest params|state|none] [--device cpu] [--out FILE]

Every rank runs this script (``torchrun`` sets the rank, the world size and
``LOCAL_RANK``); the process group is NCCL on ``cuda:{LOCAL_RANK}``, or gloo
with ``--device cpu``.  The mesh is ``make_host_mesh()``: (N, 1) over
("data", "model").  ``launch/steps.make_step`` builds the train step: each
rank holds its shards of the parameters (the rules' "data" placements) and
of AdamW's moments, gathers one layer's parameters at a time, and takes
its rows of the global batch; with ``--grad-compression`` the gradients are
FFCz-compressed over the mesh through a pallas engine (kernels 3p/4p on
the card).  The weights are random, drawn
from ``--seed`` exactly as the one-device model's, and the batches come
from the counter-mode token pipeline.

Rank 0 prints one JSON line (and writes it to ``--out``): the world size,
the card, the losses, a SHA-256 of the gathered parameters (``--digest
state``: with the moments; ``none``: skipped), each step's seconds, the
seconds of the mesh gradient compression, and every rank's peak device
memory (over all steps, and each step's) and the bytes of state it holds
against the rules' share.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import CorrectionEngine
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamW


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def digest(layout, trees) -> str:
    """SHA-256 of whole tensors (gathered to rank 0 one shard at a time),
    name by name; '' on the other ranks."""
    h = hashlib.sha256()
    for tree in trees:
        for name in sorted(tree):
            full = layout.gather_to_rank0(name, tree[name])
            if full is not None:
                if full.dtype == torch.bfloat16:
                    full = full.view(torch.int16)
                h.update(name.encode())
                h.update(full.contiguous().numpy().tobytes())
    return h.hexdigest() if layout.rank == 0 else ""


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="full", choices=["full", "smoke"])
    ap.add_argument("--n-layers", type=int, default=None, help="cut depth (default: the published depth)")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--grad-Delta-rel", type=float, default=5e-5,
                    help="below 2^-grad_bits, or the correction never acts")
    ap.add_argument("--digest", default="params", choices=["params", "state", "none"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="also write rank 0's JSON line to this file")
    args = ap.parse_args()

    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_host_mesh()
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")

    overrides = {"n_layers": args.n_layers} if args.n_layers else {}
    cfg = (get_config if args.preset == "full" else get_smoke_config)(args.arch, **overrides)
    cfg = dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, grad_compression=args.grad_compression, grad_Delta_rel=args.grad_Delta_rel))
    engine = CorrectionEngine(fft_impl="pallas", device=dev)
    step, _args, _in, _out = steps.make_step(cfg, "train_4k", mesh, optimizer=AdamW(warmup_steps=10),
                                             engine=engine)
    layout = step.layout
    pipeline = pipeline_for(cfg, args.seq_len, args.global_batch, seed=args.seed)

    sync(dev)
    t0 = time.perf_counter()
    params, opt_state = step.init_state(torch.Generator(device=dev).manual_seed(args.seed))
    sync(dev)
    init_s = time.perf_counter() - t0

    compress_s = []
    compress = grad_compress.compress_sharded_gradients

    def timed(*a, **kw):
        sync(dev)
        t = time.perf_counter()
        got = compress(*a, **kw)
        sync(dev)
        compress_s.append(time.perf_counter() - t)
        return got

    grad_compress.compress_sharded_gradients = timed
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, peaks = [], [], []
    for i in range(args.steps):
        batch = pipeline.batch_at(i)
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        sync(dev)
        step_s.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
    grad_compress.compress_sharded_gradients = compress
    peak = max(peaks) if peaks else None
    held = layout.state_bytes(params) + layout.state_bytes(opt_state)

    t0 = time.perf_counter()
    trees = {"params": [params], "state": [params, opt_state["m"], opt_state["v"]], "none": []}[args.digest]
    sha = digest(layout, trees)
    digest_s = time.perf_counter() - t0
    per_rank = [None] * world
    dist.all_gather_object(per_rank, {"rank": rank, "peak_memory_bytes": peak, "step_peak_memory_bytes": peaks,
                                      "state_bytes": held,
                                      "rules_share_bytes": layout.share_bytes(), "step_seconds": step_s,
                                      "compress_seconds": compress_s})
    ok = all(r["state_bytes"] == r["rules_share_bytes"] for r in per_rank) and all(
        map(lambda v: v == v and abs(v) != float("inf"), losses))
    if rank == 0:
        out = {"world_size": world, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
               "tokens": [args.global_batch, args.seq_len], "grad_compression": args.grad_compression,
               "grad_Delta_rel": args.grad_Delta_rel,
               "params": sum(int(torch.Size(s).numel()) for s in layout.shapes.values()),
               "init_seconds": init_s, "losses": losses, "step_seconds": step_s,
               "compress_seconds": compress_s, "digest": args.digest, "sha256": sha, "digest_seconds": digest_s,
               "ranks": per_rank, "ok": ok}
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    dist.destroy_process_group()
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
