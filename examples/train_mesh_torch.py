"""Training and serving over a mesh through the PyTorch port: FSDP over
"data", tensor and expert parallelism over "model".

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        examples/train_mesh_torch.py [--arch qwen2-0.5b] [--preset full|smoke] [--n-layers L] \\
        [--model-parallel M] [--seq-len S] [--global-batch B] [--steps K] [--grad-compression] \\
        [--digest params|state|none] [--device cpu] [--out FILE] \\
        [--serve [--decode-steps K] [--logits FILE] [--compare FILE]]

Every rank runs this script (``torchrun`` sets the rank, the world size and
``LOCAL_RANK``); the process group is NCCL on ``cuda:{LOCAL_RANK}``, or gloo
with ``--device cpu``.  The mesh is ``make_host_mesh(model_parallel=M)``:
(N / M, M) over ("data", "model").  ``launch/steps.make_step`` builds the
train step: each rank holds its (data, model) blocks of the parameters (the
rules' placements) and of AdamW's moments, gathers one layer's parameters
at a time as its compute reads them (its heads, MLP columns, experts and
vocab block over "model"), and takes its rows of the global batch; with
``--grad-compression`` the gradients are FFCz-compressed over the mesh
through a pallas engine (kernels 3p/4p on the card).  The weights are
random, drawn from ``--seed`` exactly as the one-device model's, and the
batches come from the counter-mode token pipeline.

Rank 0 prints one JSON line (and writes it to ``--out``): the world size,
the mesh, the card, the losses, the global gradient norm AdamW clips by at each step
(before the clip), a SHA-256 of the gathered parameters
(``--digest state``: with the moments; ``none``: skipped), each step's
seconds, the seconds of the mesh gradient compression, and every rank's
peak device memory (over all steps, and each step's) and the bytes of state
it holds against the rules' share.

``--serve`` runs ``make_step``'s prefill (``--global-batch`` prompts of
``--seq-len`` tokens; ``attention_impl="pallas"``: the flash kernel on each
rank's heads) and ``--decode-steps`` decode steps (``MeshServe``) instead of
training, and prints their seconds and peak memory.  Rank 0 gathers each
step's logits (every rank returns its rows and vocab block): ``--logits``
writes them (``.npy``, with a second path's, ``attention_impl=
"xla_flash"``, beside them at a model size of 1: their largest difference
is the floor between two correct paths), and ``--compare`` reads such a
file and reports the largest difference against it, the floor and the bar
(2e-2 above the floor for bf16, as the LM gate's).
"""

import argparse
import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import CorrectionEngine
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.fsdp import init_shards
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
    ap.add_argument("--model-parallel", type=int, default=1, help="ranks on the mesh's 'model' axis")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"], help="the blocks' dtype")
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
    ap.add_argument("--serve", action="store_true", help="prefill and decode instead of training")
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--logits", default=None, help="--serve: write the gathered logits (.npy) here")
    ap.add_argument("--compare", default=None, help="--serve: compare the logits with this --logits file")
    args = ap.parse_args()

    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_host_mesh(model_parallel=args.model_parallel)
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")

    overrides = {"n_layers": args.n_layers} if args.n_layers else {}
    if args.dtype:
        overrides["dtype"] = args.dtype
    cfg = (get_config if args.preset == "full" else get_smoke_config)(args.arch, **overrides)
    if args.serve:
        raise SystemExit(serve(args, cfg, mesh, dev))
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
    grad_norms, norm_terms = [], step.norm_terms

    def norms(names):
        reduce = norm_terms(names)

        def terms_of(terms):
            terms = reduce(terms) if reduce is not None else terms
            grad_norms.append(float(torch.sqrt(sum(terms))))
            return terms
        return terms_of

    step.norm_terms = norms
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
        out = {"world_size": world, "mesh": list(mesh.shape),
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
               "tokens": [args.global_batch, args.seq_len], "grad_compression": args.grad_compression,
               "grad_Delta_rel": args.grad_Delta_rel,
               "params": sum(int(torch.Size(s).numel()) for s in layout.shapes.values()),
               "init_seconds": init_s, "losses": losses, "grad_norms": grad_norms, "step_seconds": step_s,
               "compress_seconds": compress_s, "digest": args.digest, "sha256": sha, "digest_seconds": digest_s,
               "ranks": per_rank, "ok": ok}
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    dist.destroy_process_group()
    raise SystemExit(0 if ok else 1)


def gathered_logits(layout, split, logits):
    """Every rank's (rows, vocab) block of one step's logits, whole on rank
    0 (float32 numpy; ``None`` elsewhere)."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (split.rows(split.size * logits.shape[0]), layout.data_rank, layout.model_rank,
                                   logits.float().cpu().numpy()))
    if dist.get_rank() != 0:
        return None
    rows = {}
    for sl, d, m, block in parts:
        rows.setdefault((sl.start, sl.stop), {})[m] = block
    return np.concatenate([np.concatenate([v[m] for m in sorted(v)], axis=-1)
                           for _, v in sorted(rows.items())], axis=0)


def serve(args, cfg, mesh, dev) -> int:
    """``--serve``: prefill and decode through ``MeshServe`` (module
    docstring); returns the exit code."""
    rank = dist.get_rank()
    runs = [("pallas", dataclasses.replace(cfg, attention_impl="pallas"))]
    if args.logits and mesh.shape[1] == 1:
        runs.append(("xla_flash", dataclasses.replace(cfg, attention_impl="xla_flash")))
    rows, prompt, new = args.global_batch, args.seq_len, args.decode_steps
    toks = torch.randint(0, cfg.vocab, (rows, prompt + new), generator=torch.Generator().manual_seed(args.seed + 1))
    results = {}
    for impl, c in runs:
        pre = steps.make_step(c, "prefill_32k", mesh)[0]
        dec = steps.make_step(c, "decode_32k", mesh)[0]
        layout = pre.layout
        params = init_shards(layout, torch.Generator(device=dev).manual_seed(args.seed))
        cache = pre.init_cache(rows, prompt + new + 1)
        split = layout.batch_split(rows)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        logits, cache = pre(params, {"tokens": toks[:, :prompt]}, cache)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        seq, decode_s = [gathered_logits(layout, split, logits)], []
        for t in range(prompt, prompt + new):
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = dec(params, toks[:, t : t + 1], cache)
            sync(dev)
            decode_s.append(time.perf_counter() - t0)
            seq.append(gathered_logits(layout, split, logits))
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, {"rank": rank, "peak_memory_bytes": peak,
                                          "state_bytes": layout.state_bytes(params),
                                          "rules_share_bytes": layout.share_bytes(moments=False),
                                          "cache_bytes": layout.state_bytes(cache)})
        results[impl] = {"logits": seq, "prefill_seconds": prefill_s, "decode_seconds": decode_s, "ranks": per_rank}
        del params, cache, pre, dec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ok = all(r["state_bytes"] == r["rules_share_bytes"] for r in results["pallas"]["ranks"])
    if rank == 0:
        got = np.stack(results["pallas"]["logits"])
        ok &= bool(np.isfinite(got).all())
        out = {"mode": "serve", "world_size": dist.get_world_size(), "mesh": list(mesh.shape),
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "rows": rows, "prompt": prompt,
               "decode_steps": new, "logits_shape": list(got.shape),
               **{k: v for k, v in results["pallas"].items() if k != "logits"}}
        if "xla_flash" in results:
            out["floor"] = float(np.abs(got - np.stack(results["xla_flash"]["logits"])).max())
        if args.logits:
            np.save(args.logits, got)
            if "floor" in out:
                np.save(args.logits + ".floor.npy", np.float64(out["floor"]))
        if args.compare:
            want = np.load(args.compare)
            floor = float(np.load(args.compare + ".floor.npy"))
            bar = (2e-2 if cfg.dtype == "bfloat16" else 1e-4) + floor
            diff = float(np.abs(got - want).max())
            out.update(compare=args.compare, max_abs_diff=diff, decode_max_abs_diff=float(np.abs(
                got[1:] - want[1:]).max()), floor=floor, bar=bar, within_bar=diff <= bar)
            ok &= diff <= bar
        out["ok"] = ok
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    box = [ok]
    dist.broadcast_object_list(box, src=0)
    dist.destroy_process_group()
    return 0 if box[0] else 1


if __name__ == "__main__":
    main()
