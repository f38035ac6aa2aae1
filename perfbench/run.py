"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root.  Set-up makes the cell's inputs on the card from
the seed, builds or loads the kernels and warms up every shape the cell
uses; the window then calls the cell's entry in a closed loop (each call
starts when the last one has returned and synchronised) for ``--seconds``
seconds.  Once it has closed, the calls that the check sampled are judged
against the plain reference (``perfbench/reference``) and the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.

``--control bf16`` puts the reference's correction, computed on a bfloat16
state, in the program's engine's place: the check has to refuse it.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
# growable segments: the calls' sizes vary, and fixed segments strand free blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: those loaded)."""
    return sorted({m.split(".")[0] for m in list(sys.modules if modules is None else modules)} & set(FORBIDDEN))


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", control=None):
    """One run of cell ``name``; returns the result object."""
    import numpy as np
    import torch

    from perfbench import generate, recorder
    from perfbench import trace as tracing
    from perfbench.reference import judge
    from perfbench.reference.control import Bfloat16Engine

    cell = spec.cell(name)
    config, traffic, limits = spec.config(cell), spec.traffic(cell), spec.limits(cell)
    metrics = spec.metrics(cell, trace)
    readers = {m["name"]: spec.metric(m["name"]) for m in metrics}
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    from repro_torch.core import engine as program_engine
    from repro_torch.core.engine import CorrectionEngine

    if control == "bf16":
        engine = Bfloat16Engine()
    elif control is None:
        engine = CorrectionEngine(**config["engine"], device=device)
    else:
        raise ValueError(f"unknown control {control!r}")
    rec = recorder.Recorder(engine, fenced=trace, sync=sync)
    stages = {"imports": time.perf_counter() - STARTED}
    inputs = spec.inputs(config).make(config, traffic, seed, device)
    entry = spec.entry(config).Entry(config, traffic, inputs, device)
    sync()
    stages["inputs"] = time.perf_counter() - STARTED - stages["imports"]
    for i in entry.warmup():
        rec.begin(False)
        entry(i, rec)
        sync()
        rec.end()
    rec.calls = []
    sample = sorted(set(entry.sample(np.random.default_rng(generate.seeds(seed, 3)[2]))))
    setup_s = time.perf_counter() - STARTED
    stages["warmup"] = setup_s - stages["imports"] - stages["inputs"]

    # the codec's host stages (the float64 polish, base, encode, verify,
    # decode) that the window and the traced cycle run
    for k in program_engine.host_stages:
        program_engine.host_stages[k] = 0
    latencies, kept = [], {}
    n_bytes = attempted = failed = 0
    t_start = t_end = time.perf_counter()
    i = 0
    while t_end - t_start < seconds or i <= sample[-1]:
        t0 = time.perf_counter()
        rec.begin(i in sample and entry.KEEP_CORRECTIONS)
        attempted += 1
        try:
            out = entry(i, rec)
            sync()
        except (RuntimeError, MemoryError) as e:
            failed += 1
            say(f"call {i} failed: {e!r}")
            out = None
        got = rec.end()
        t_end = time.perf_counter()
        latencies.append(t_end - t0)
        if out is not None:
            n_bytes += entry.bytes_in(i)
            if i in sample:
                kept[i] = (out, got)
        del out, got
        i += 1
    window_s = t_end - t_start
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    window_calls, timeline, profiled, profiled_bytes = rec.calls, None, [], 0
    if trace and on_card:
        rec.calls = []
        todo = range(i, i + entry.profile_calls())

        def calls(mark):
            for j in todo:
                with mark():
                    rec.begin(False)
                    entry(j, rec)
                    sync()
                    rec.end()

        timeline = tracing.profile(calls)
        profiled = [c for call in rec.calls for c in call]
        profiled_bytes = sum(entry.client_bytes(j) for j in todo)

    host_stages = sum(program_engine.host_stages.values())
    entry.release(set(kept))
    del engine, rec
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    tally = judge.Tally()
    for j in sorted(kept):
        entry.judge(tally, j, *kept[j])
    stages["check"] = time.perf_counter() - t_check
    numbers = tally.numbers()
    if "host_stages" in limits:
        numbers["host_stages"] = host_stages
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and sorted(kept) == sample and all(c["value"] <= c["limit"] for c in checks.values())

    run = SimpleNamespace(cell=cell, config=config, traffic=traffic, setup_s=setup_s, window_s=window_s,
                          latencies=latencies, bytes=n_bytes, window_calls=window_calls, timeline=timeline,
                          profiled=profiled, profiled_client_bytes=profiled_bytes)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": values, "device": dev}
    if timeline is not None:
        dev.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in timeline.device_ops],
                               "idle_gaps": [list(x) for x in timeline.idle_gaps]}
    say(f"cell {name} seed {seed}: {attempted} calls in {window_s} s, {tally.pencils} pencils judged "
        f"in {len(kept)} calls ({tally.unconverged} not converged in the reference), sampled {sample}; "
        f"seconds by stage {stages}; call seconds by decile "
        f"{statistics.quantiles(latencies, n=10, method='inclusive') if len(latencies) > 1 else latencies}")
    for k, c in checks.items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    args = ap.parse_args(argv)

    from perfbench.spec import Spec

    spec = Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"cell {args.workload} needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), control=args.control)
    found = forbidden_modules()
    if found:
        say(f"modules that the benchmark may not load were loaded: {found}")
        return 1
    say(f"card: {power_limit()}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
