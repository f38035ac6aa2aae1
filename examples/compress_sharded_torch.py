"""Sharded FFCz through the PyTorch port: one field slab-sharded over N ranks.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        examples/compress_sharded_torch.py [--field nyx-like-128] [--device cpu] [--out FILE]

Every rank runs this script (``torchrun`` sets the rank, the world size and
``LOCAL_RANK``); the process group is NCCL on ``cuda:{LOCAL_RANK}``, or gloo
with ``--device cpu``.  The field is made from its seed on every rank and
sharded along axis 0 over a 1-D mesh ``("data",)``.  Then:

- ``FFCz.compress(ShardedField)`` with ``fft_impl="packed"`` (the POCS loop's
  distributed mode), twice (the first call builds the transforms' plans and
  opens the group's collectives), the second after a barrier: both stored
  bounds rechecked in float64, ``decompress_sharded`` bitwise
  ``decompress``, every rank's blob the same;
- each rank's host memory over the steady compress: its resident set
  sampled every 5 ms by a thread, the largest sample less the one taken
  just before the call; and how many times each rank ran each host stage
  there (``engine.host_stages``: the host stages run on rank 0 alone, so
  the other ranks' resident sets grow by a few slabs, rank 0's by the
  field's host stages);
- the loop alone (``execute_field_async``), twice, each after a barrier;
- on the card, each rank's peak device memory over the steady compress and
  over ``to_host`` beyond what it held before, in slabs (one rank's
  ``S0 x N1 x N2`` float32 rows): ``to_host`` moves the field one slab at a
  time, so its peak must stay within one slab (2 MiB of allocator rounding
  allowed);
- ``pencil_rfftn`` of the field, gathered;
- ``power_spectrum`` of the sharded field;
- the engine's ``sharded`` backend (``fft_impl="pallas"`` on the card:
  kernels 3p/4p on every rank's rows) on ``--pencils`` pencils of
  ``--block``, against the batched backend on the same inputs.

Rank 0 prints one JSON line (and writes it to ``--out``): the world size,
the card's name, SHA-256 digests of the blob's payload, the gathered
spectrum, the power spectrum and the pencils' results, the seconds (the
steady compress's stages and the loop's for every rank) and the peaks.  Runs
at different world sizes are bitwise the same exactly when their digests
are equal.  Exit code 1 when a check fails.
"""

import argparse
import hashlib
import json
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.compressors import get_compressor
from repro_torch.core import engine as engine_module
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.ffcz import FFCz, FFCzConfig
from repro_torch.core.spectrum import power_spectrum
from repro_torch.data.fields import error_pencils, make_field
from repro_torch.sharding import ShardedField, pencil_rfftn


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
        if isinstance(a, torch.Tensor):
            a = torch.view_as_real(a) if a.is_complex() else a
            a = a.numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def peak_start(dev):
    """Reset the card's peak-memory counter; the bytes held now (None on the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def peak_read(dev, held):
    """The card's peak allocation since :func:`peak_start`, beyond ``held``."""
    return None if held is None else torch.cuda.max_memory_allocated(dev) - held


def resident_bytes() -> int:
    """This process's resident set now (Linux ``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class ResidentGrowth:
    """While the context is open, a thread samples :func:`resident_bytes`
    every ``period`` seconds; ``growth`` is then the largest sample less the
    one taken on entry, in MiB."""

    def __init__(self, period: float = 0.005):
        self.period, self.growth = period, None

    def _sample(self):
        while not self._done.wait(self.period):
            self._peak = max(self._peak, resident_bytes())

    def __enter__(self):
        self._done = threading.Event()
        self._base = self._peak = resident_bytes()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        self.growth = (max(self._peak, resident_bytes()) - self._base) / 2**20


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--field", default="nyx-like-128")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--pencils", type=int, default=49152, help="pencils of the sharded backend's batch")
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--out", default=None, help="also write rank 0's JSON line to this file")
    args = ap.parse_args()

    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = init_device_mesh(args.device, (world,), mesh_dim_names=("data",))
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")
    ok, out = True, {"world_size": world, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "field": args.field}
    x = make_field(args.field)
    codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="packed",
                                                     max_iters=3000), device=args.device)
    field = ShardedField.shard(x, mesh)
    first = codec.compress(field).stats.stage_seconds
    slab_bytes = field.local.numel() * field.local.element_size()
    # the host stages' counters (a library without them reports None)
    stages = getattr(engine_module, "host_stages", None)
    before = dict(stages or {})
    sync(dev)
    dist.barrier()
    held = peak_start(dev)
    with ResidentGrowth() as resident:
        blob = codec.compress(field)
    compress_peak = peak_read(dev, held)
    ran = None if stages is None else {k: stages[k] - before[k] for k in stages}
    dec = codec.decompress(blob)
    eps = dec.astype(np.float64) - x.astype(np.float64)
    d = np.fft.rfftn(eps)
    margins = (float(blob.E - np.abs(eps).max()),
               float(blob.Delta_scalar - np.maximum(np.abs(d.real), np.abs(d.imag)).max()))
    same_decode = bool(np.array_equal(codec.decompress_sharded(blob, mesh).to_host(), dec))
    payload = hashlib.sha256(blob.payload_bytes()).hexdigest()

    plan = codec.engine.plan_field(field, codec.config)
    x_hat = np.asarray(codec.base.decompress(codec.base.compress(x, plan.E_proj)), dtype=np.float32)
    eps0 = ShardedField.shard(x_hat - x, mesh)
    loop_s = []
    for _ in range(2):
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        codec.engine.execute_field_async(eps0, plan)  # the loop; its host polish is not run
        sync(dev)
        loop_s.append(time.perf_counter() - t0)
    del eps0

    fresh = ShardedField.shard(x, mesh)
    sync(dev)
    held = peak_start(dev)
    fresh.to_host()
    to_host_peak = peak_read(dev, held)
    del fresh
    mine = {"stage_seconds": blob.stats.stage_seconds, "loop_seconds": loop_s, "payload": payload,
            "compress_peak_slabs": None if compress_peak is None else compress_peak / slab_bytes,
            "to_host_peak_bytes": to_host_peak, "host_stages": ran, "host_growth_mib": resident.growth}
    every = [None] * world
    dist.all_gather_object(every, mine)
    same_blob = len({r["payload"] for r in every}) == 1
    to_host_ok = to_host_peak is None or to_host_peak <= slab_bytes + (2 << 20)
    ok &= blob.stats.converged and min(margins) >= 0 and same_decode and same_blob and to_host_ok
    out["codec"] = {"iterations": blob.stats.iterations, "margins": margins, "payload_sha256": payload,
                    "same_blob_on_every_rank": same_blob,
                    "decompress_sharded_bitwise": same_decode, "pad_meta": blob.pad_meta is not None,
                    "stage_seconds": blob.stats.stage_seconds, "first_call_stage_seconds": first,
                    "loop_seconds": loop_s}
    out["by_rank"] = {k: [r[k] for r in every] for k in ("stage_seconds", "loop_seconds", "compress_peak_slabs",
                                                         "to_host_peak_bytes", "host_stages", "host_growth_mib")}
    if ran is not None:
        out["polished_on"] = [i for i, r in enumerate(every) if r["host_stages"]["polish"]]
        ok &= out["polished_on"] == [0] and every[0]["host_stages"]["polish"] == 1
    out["memory"] = {"slab_bytes": slab_bytes, "field_bytes": x.nbytes, "to_host_within_one_slab": to_host_ok}

    spectrum = field.freq_to_host(pencil_rfftn(field))
    out["spectrum_sha256"] = digest(spectrum)
    power_spectrum(field)
    sync(dev)
    t0 = time.perf_counter()
    _, pk = power_spectrum(field)
    sync(dev)
    out["power_spectrum"] = {"seconds": time.perf_counter() - t0, "sha256": digest(pk)}

    errs, Es, Ds = error_pencils(dev, args.pencils, args.block)
    impl = "pallas" if dev.type == "cuda" else "xla"
    sharded = CorrectionEngine(backend="sharded", fft_impl=impl, mesh=mesh)
    batched = CorrectionEngine(backend="batched", fft_impl=impl, device=dev)
    seconds = {}
    results = {}
    for label, engine in (("batched", batched), ("sharded", sharded), ("sharded", sharded),
                          ("batched", batched)):
        sync(dev)
        t0 = time.perf_counter()
        results[label] = engine.correct(errs, Es, Ds, block=args.block, return_edits=True)
        sync(dev)
        seconds.setdefault(label, []).append(time.perf_counter() - t0)

    def flat(res):
        corrected, edits, stats = res
        return [*corrected, *(t for e in edits for t in e), stats.block_iterations, stats.block_converged]

    bitwise = all(torch.equal(a, b) for a, b in zip(flat(results["sharded"]), flat(results["batched"])))
    ok &= bitwise
    out["pencils"] = {"fft_impl": impl, "pencils": args.pencils, "block": args.block,
                      "sha256": digest(*flat(results["sharded"])), "bitwise_vs_batched": bitwise,
                      "seconds": seconds}
    flags = [None] * world
    dist.all_gather_object(flags, bool(ok))
    dist.destroy_process_group()
    out["ok"] = all(flags)
    if rank == 0:
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    raise SystemExit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
