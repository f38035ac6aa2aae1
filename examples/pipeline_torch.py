"""GPipe over a "pipe" mesh axis through the PyTorch port: a dense LM's layer
stack split into contiguous stages, one a card, microbatches streamed
through ``repro_torch.sharding.pipeline.pipeline_apply``.

    python -m torch.distributed.run --standalone --nproc-per-node S \\
        examples/pipeline_torch.py [--arch qwen2-0.5b] [--preset full|smoke] [--n-layers L] \\
        [--micro M] [--rows B] [--seq-len T] [--reps K] [--device cpu] [--out FILE]

Every rank runs this script (``torchrun`` sets the rank, the world size and
``LOCAL_RANK``); the process group is NCCL on ``cuda:{LOCAL_RANK}``, or gloo
with ``--device cpu``.  The mesh is (S, 1) over ("pipe", "data").  Rank
``idx`` builds only its stage's ``DenseBlock``s (layers ``idx * L / S`` up
to ``(idx + 1) * L / S``) and the embedding, drawing them from ``--seed``
exactly as the one-device model's initialization does
(``fsdp.draw_init``).  The input is the embedding of ``--rows`` x
``--seq-len`` random tokens, cut into ``--micro`` microbatches of
``rows / micro`` rows; the forward runs with ``attention_impl="pallas"``
(the flash kernel, one launch a layer a microbatch), under
``torch.no_grad``.

Rank 0 prints one JSON line (and writes it to ``--out``): the mesh, the
card's name and power limit, the seconds of the pipelined forward (the best
of ``--reps`` after a warm-up) and of one card's sequential forward over
the same layers (rank 0 builds the whole stack for it, after the pipelined
runs), ``bubble_fraction(S, M)`` and the measured bubble (from ``--reps``
runs of their own, where the card is synchronized around each stage call
to time it: a rank's share of such a run's seconds outside its stage's
compute), the seconds of the schedule alone (the same call with stages that
return their input: the stream check, the sends and the broadcast), the
flash launches of each rank in
one pipelined forward, and the final hidden states' largest difference
against the one-card forward of the whole batch beside the LM gate's bf16
bar: 2e-2 above the floor between two correct one-card forwards (the
``xla_flash`` attention path against ``pallas``).  It also says whether
the output is bitwise the one-card forward run microbatch by microbatch.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import lm_class
from repro_torch.models.transformer import DenseBlock
from repro_torch.sharding import dist_fft
from repro_torch.sharding.fsdp import draw_init
from repro_torch.sharding.pipeline import block_stage, bubble_fraction, pipeline_apply


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nvidia_smi():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def build_blocks(cfg, layers, seed, dev):
    """The embedding and the ``DenseBlock``s of ``layers`` with the one-device
    initialization's values (``build_model(cfg).init`` seeded ``seed``)."""
    want = {}

    def take(name, value):
        head, _, rest = name.partition(".")
        if name == "embed" or (head == "layers" and int(rest.split(".")[0]) in layers):
            want[name] = value.to(dtype_of(cfg.dtype))

    draw_init(lm_class(cfg)(cfg, device="meta"), cfg, torch.Generator(device=dev).manual_seed(seed), take)
    blocks = []
    for i in layers:
        block = DenseBlock(cfg, device=dev)
        prefix = f"layers.{i}."
        missing, unexpected = block.load_state_dict(
            {k[len(prefix):]: v for k, v in want.items() if k.startswith(prefix)}, strict=False)
        if unexpected or any(not k.endswith("scale") for k in missing):
            raise RuntimeError(f"layer {i}: missing {missing}, unexpected {unexpected}")
        blocks.append(block)
    return want["embed"], blocks


def sequential(blocks, cfg, h):
    for block in blocks:
        h = block(h, cfg)[0]
    return h


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="full", choices=["full", "smoke"])
    ap.add_argument("--n-layers", type=int, default=None, help="cut depth (default: the published depth)")
    ap.add_argument("--micro", type=int, default=4, help="microbatches M")
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="also write rank 0's JSON line to this file")
    args = ap.parse_args()

    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    world = dist.get_world_size()
    mesh = make_mesh((world, 1), ("pipe", "data"))
    _group, S, idx = dist_fft.mesh_axis(mesh, "pipe")
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")

    overrides = {"attention_impl": "pallas", **({"n_layers": args.n_layers} if args.n_layers else {})}
    cfg = (get_config if args.preset == "full" else get_smoke_config)(args.arch, **overrides)
    if cfg.family != "dense":
        raise SystemExit(f"{args.arch} is a {cfg.family} model: this example stages DenseBlocks")
    if args.rows % args.micro:
        raise SystemExit(f"--micro {args.micro} does not divide --rows {args.rows}")
    L, M = cfg.n_layers, args.micro
    mine = range(idx * L // S, (idx + 1) * L // S)
    embed, blocks = build_blocks(cfg, mine, args.seed, dev)
    tokens = torch.randint(0, cfg.vocab, (args.rows, args.seq_len), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    h0 = torch.nn.functional.embedding(tokens, embed)
    micro = h0.reshape((M, args.rows // M) + tuple(h0.shape[1:]))
    stage_fn, stage_params = block_stage(blocks, cfg)
    busy = []

    def timed_stage(p, h):
        sync(dev)
        t = time.perf_counter()
        out = stage_fn(p, h)
        sync(dev)
        busy.append(time.perf_counter() - t)
        return out

    runs, synced = [], []
    with torch.no_grad():
        out = pipeline_apply(stage_fn, stage_params, micro, mesh)  # warm-up (cuBLAS, flash build)
        for _ in range(args.reps):
            flash_ops.launches["flash_attention"] = 0
            dist.barrier()
            sync(dev)
            t = time.perf_counter()
            out = pipeline_apply(stage_fn, stage_params, micro, mesh)
            sync(dev)
            runs.append((time.perf_counter() - t, flash_ops.launches["flash_attention"]))
        for _ in range(args.reps):  # the bubble: stage calls timed apart, the card synchronized around each
            busy.clear()
            dist.barrier()
            sync(dev)
            t = time.perf_counter()
            pipeline_apply(timed_stage, stage_params, micro, mesh)
            sync(dev)
            synced.append((time.perf_counter() - t, sum(busy)))
        schedule = []
        for _ in range(args.reps):  # the schedule's own cost: stages that compute nothing
            dist.barrier()
            sync(dev)
            t = time.perf_counter()
            pipeline_apply(lambda p, h: h, stage_params, micro, mesh)
            sync(dev)
            schedule.append(time.perf_counter() - t)
    seconds, launches = min(runs)
    synced_s, busy_s = min(synced)
    per_rank = [None] * world
    dist.all_gather_object(per_rank, {"pipe": idx, "layers": [mine.start, mine.stop], "seconds": seconds,
                                      "synced_seconds": synced_s, "busy_seconds": busy_s,
                                      "bubble": 1.0 - busy_s / synced_s, "flash_launches": launches,
                                      "schedule_seconds": min(schedule)})
    if dist.get_rank() == 0:
        del blocks
        _, whole = build_blocks(cfg, range(L), args.seed, dev)
        with torch.no_grad():
            want = sequential(whole, cfg, h0)  # warm-up
            times = []
            for _ in range(args.reps):
                sync(dev)
                t = time.perf_counter()
                want = sequential(whole, cfg, h0)
                sync(dev)
                times.append(time.perf_counter() - t)
            per_micro = torch.stack([sequential(whole, cfg, m) for m in micro])
            other = sequential(whole, dataclasses.replace(cfg, attention_impl="xla_flash"), h0)
        got = out.reshape(h0.shape)
        diff = float((got.float() - want.float()).abs().max())
        floor = float((other.float() - want.float()).abs().max())
        line = {"arch": cfg.name, "n_layers": L, "dtype": cfg.dtype, "world_size": world, "mesh": [S, 1],
                "mesh_axes": ["pipe", "data"], "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu", "nvidia_smi": nvidia_smi() if dev.type == "cuda" else None,
                "rows": args.rows, "seq_len": args.seq_len, "micro": M,
                "pipelined_seconds": max(r["seconds"] for r in per_rank), "one_card_seconds": min(times),
                "synchronized_pipelined_seconds": max(r["synced_seconds"] for r in per_rank),
                "schedule_seconds": max(r["schedule_seconds"] for r in per_rank),
                "bubble_fraction": bubble_fraction(S, M),
                "measured_bubble": [r["bubble"] for r in per_rank],
                "flash_launches_per_rank": [r["flash_launches"] for r in per_rank],
                "stages": [r["layers"] for r in per_rank],
                "max_abs_diff": diff, "floor": floor, "bar": 2e-2 + floor, "within_bar": diff <= 2e-2 + floor,
                "bitwise_per_microbatch": bool(torch.equal(out, per_micro)),
                "hidden_max_abs": float(want.float().abs().max())}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
