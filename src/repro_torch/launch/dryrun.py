"""Multi-pod dry run: count one step of every (arch x shape x mesh) cell.

The reference (``src/repro/launch/dryrun.py``) lowers and compiles each
cell's step over 512 fake XLA devices and records XLA's memory analysis and
its trip-count-aware HLO cost.  torch has no SPMD compile, so the port runs
one rank's step instead:

  * a single-process fake process group (``torch.distributed``'s
    ``FakeStore``, imported here only, inside :func:`fake_group`) of 256 or
    512 ranks, with ``make_production_mesh`` over it: the 16x16
    (data, model) mesh and the 2x16x16 (pod, data, model) one;
  * ``launch/steps.make_step`` builds the cell's step with the rank's
    tensors on the ``meta`` device: rank 0's parameter and moment shards
    (``MeshLayout``'s blocks of the rules' placements), the global batch,
    the rank's cache;
  * the step runs once under :mod:`repro_torch.launch.hlo_cost`'s counter.
    Collectives over the fake group return at once; nothing is computed
    (meta tensors), so the count takes seconds a cell, and a step that
    needs a value (a data-dependent op) fails its cell.

Each record keeps the reference's keys where a counterpart exists:
``flops``, ``bytes_accessed``, ``collective_bytes`` and
``unknown_trip_whiles`` (always 0: every loop runs) from the counter;
``memory.argument_size_bytes`` the rank's arguments (its parameter and
moment shards, ``MeshLayout.share_bytes``, plus its rows of the batch and
its cache), ``output_size_bytes`` the step's result, ``temp_size_bytes``
the peak of live tensor bytes the step allocated beyond its arguments (an
estimate: ``memory.temp_size_is_estimate``).  ``count_s`` replaces
``lower_s`` and ``compile_s``.  The ``*_bodyonce`` keys (XLA's own
cost analysis, which visits a loop body once) and
``generated_code_size_bytes`` have no counterpart and are left out;
``kernels`` lists hand-written kernel launches (none on meta).  The step
runs the config's default attention path (``xla_flash``), as the
reference's dry run does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out dryrun_results_torch.json [--resume]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch.hlo_cost import counted, tree_bytes


def fake_group(world: int) -> None:
    """Make the default process group a single-process fake group of
    ``world`` ranks (this process is rank 0); a default group of another
    kind or size is destroyed first."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def step_args(step, args, seq: int, kind: str):
    """This rank's arguments of a ``make_step`` step on the meta device:
    ``(call args, argument bytes)``.  The batch (or tokens) is the global
    one, as the step takes it; its bytes count the rank's rows only.  The
    cache (``MeshServe.init_cache``) holds ``seq`` positions, as
    ``launch/specs.input_specs``'s."""
    L = step.layout
    params = {k: _meta(L.local_shape(k), L.dtypes[k]) for k in L.shapes}
    if kind == "train":
        opt_state = step.optimizer.init(params)
        batch = args[2]
        split = L.batch_split(int(batch["tokens"].shape[0]))
        call = (params, opt_state, batch)
        return call, tree_bytes((params, opt_state)) + tree_bytes(batch) // split.size
    inputs = args[1]
    rows = int((inputs["tokens"] if isinstance(inputs, dict) else inputs).shape[0])
    split = L.batch_split(rows)
    cache = step.init_cache(rows, seq)
    return (params, inputs, cache), tree_bytes(params) + tree_bytes(inputs) // split.size + tree_bytes(cache)


def count_step(cfg, shape_id: str, mesh):
    """Build the cell's step over ``mesh`` with this rank's tensors on meta
    and run it once under the counter: ``(Cost, record fields)``."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import make_step

    seq, _batch, kind = SHAPES[shape_id]
    step, args, _in, _out = make_step(cfg, shape_id, mesh, device="meta")
    call, arg_bytes = step_args(step, args, seq, kind)
    out, cost = counted(step, *call)
    memory = {"argument_size_bytes": int(arg_bytes), "output_size_bytes": int(tree_bytes(out)),
              "temp_size_bytes": int(cost.peak_temp_bytes), "temp_size_is_estimate": True}
    return cost, memory


def run_cell(arch: str, shape_id: str, multi_pod: bool, extra_cfg=None):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch, **(extra_cfg or {}))
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    cost, memory = count_step(cfg, shape_id, mesh)
    return {
        "arch": arch,
        "shape": shape_id,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": True,
        "count_s": round(time.time() - t0, 1),
        "flops": cost.flops,
        "bytes_accessed": cost.bytes,
        "collective_bytes": cost.collectives,
        "unknown_trip_whiles": cost.unknown_trips,
        "kernels": cost.kernels,
        "memory": memory,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--resume", action="store_true", help="skip cells already in --out")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS, get_config

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    for arch in archs:
        cfg = get_config(arch)
        shapes = list(cfg.cells()) if args.shape == "all" else args.shape.split(",")
        for shape_id in shapes:
            if shape_id not in cfg.cells():
                results.append(
                    {"arch": arch, "shape": shape_id, "skipped": True,
                     "reason": "full-attention arch: long_500k requires sub-quadratic decode state"}
                )
                continue
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                if (arch, shape_id, mesh_name) in done:
                    continue
                label = f"{arch} x {shape_id} x {mesh_name}"
                print(f"[dryrun] {label} ...", flush=True)
                try:
                    r = run_cell(arch, shape_id, multi)
                    print(
                        f"[dryrun] {label} OK count={r['count_s']}s "
                        f"flops={r['flops']:.3e} coll={sum(r['collective_bytes'].values()):.3e}B",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 — record and continue
                    r = {
                        "arch": arch, "shape": shape_id, "mesh": mesh_name,
                        "ok": False, "error": f"{type(e).__name__}: {e}",
                    }
                    print(f"[dryrun] {label} FAIL: {r['error']}", flush=True)
                    if args.verbose:
                        traceback.print_exc()
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results if r.get("ok"))
    n_fail = sum(1 for r in results if r.get("ok") is False)
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped -> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
