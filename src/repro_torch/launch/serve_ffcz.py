"""FFCz compression service entry point with a built-in load generator.

Drives :class:`repro_torch.serving.ffcz_service.FFCzService` with a synthetic
mixed workload (whole-field + pencil compressions + decodes, optionally a
``--session-frac`` slice of live-session frame appends with duplicate
retries, a fraction of decodes deliberately corrupted) under optional
deterministic fault injection, then prints the outcome table, latency
percentiles, stage timers, and the service's failure-machinery counters.
Session write-ahead journals are in-memory unless ``--session-journal-dir``
points at a directory for file-backed WALs.

    PYTHONPATH=src python -m repro_torch.launch.serve_ffcz --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve_ffcz --requests 32 \
        --p-codec 0.3 --p-dispatch 0.3 --p-oom 0.5 --p-slow 0.1 --slow-s 120 \
        --corrupt-frac 0.25 --seed 7
    # serial (un-pipelined) execution for A/B comparison:
    PYTHONPATH=src python -m repro_torch.launch.serve_ffcz --requests 32 --pipeline-depth 1
    # without a card: the kernels' plain twins on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_ffcz --requests 16 --device cpu

The service runs on ``--device`` (default ``cuda``; without a card it
raises rather than falling back).  On the card its engine and its request
configs take ``fft_impl="pallas"``, so field and pencil requests run the
port's CUDA kernels, and the printout ends with their launch counts; on the
CPU they keep the reference's default transform.  ``--device`` sits outside
the three shared flag groups, so :func:`flag_table` is the reference's,
character for character.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.compressors import get_compressor
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.errors import ResourceExhausted
from repro_torch.core.ffcz import FFCzConfig
from repro_torch.core.temporal import TemporalConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.fcube import ops as fcube_ops
from repro_torch.kernels.rfft import ops as rfft_ops
from repro_torch.kernels.scube import ops as scube_ops
from repro_torch.runtime.faults import FaultConfig, FaultInjector
from repro_torch.serving.ffcz_service import FFCzService, ServiceConfig


def add_service_args(ap: argparse.ArgumentParser) -> None:
    """Service-construction flags (the reference launcher's, unchanged)."""
    ap.add_argument("--seed", type=int, default=0, help="workload + fault stream seed")
    ap.add_argument("--base", default="szlike", help="base compressor name")
    ap.add_argument("--max-batch", type=int, default=8, help="pencil requests fused per step")
    ap.add_argument("--block", type=int, default=128, help="pencil length")
    ap.add_argument("--deadline-s", type=float, default=30.0, help="per-request deadline")
    ap.add_argument("--max-retries", type=int, default=3, help="transient retry budget")
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="in-flight units: 1 = serial, >=2 overlaps host ENCODE with device EXECUTE",
    )
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission cap on queued requests (0 = unbounded)")
    ap.add_argument("--max-sessions", type=int, default=8,
                    help="admission cap on live stream sessions")
    ap.add_argument("--session-lease", type=float, default=60.0,
                    help="session lease seconds, refreshed on append")
    ap.add_argument("--session-journal-dir", default="",
                    help="directory for file-backed session WAL journals (default: in-memory)")


def add_workload_args(ap: argparse.ArgumentParser) -> None:
    """Synthetic-workload flags (the reference launcher's, unchanged)."""
    ap.add_argument("--field-size", type=int, default=24, help="whole-field edge length")
    ap.add_argument("--e-rel", type=float, default=1e-3, help="relative spatial bound")
    ap.add_argument("--delta-rel", type=float, default=1e-3, help="relative spectral bound")
    ap.add_argument("--crc", action="store_true", help="append CRC tails to field blobs")
    ap.add_argument("--pencil-frac", type=float, default=0.5,
                    help="fraction of compressions taking the blockwise path")
    ap.add_argument("--corrupt-frac", type=float, default=0.0,
                    help="fraction of decode requests fed corrupted bytes")
    ap.add_argument("--session-frac", type=float, default=0.0,
                    help="fraction of requests arriving as live-session frame appends")
    ap.add_argument("--session-frames", type=int, default=3,
                    help="frames per generated session (plus a duplicate retry + finalize)")


def add_fault_args(ap: argparse.ArgumentParser) -> None:
    """Fault-injection flags (all off by default; the reference launcher's)."""
    ap.add_argument("--p-codec", type=float, default=0.0, help="host codec fault probability")
    ap.add_argument("--p-dispatch", type=float, default=0.0, help="device dispatch fault probability")
    ap.add_argument("--p-oom", type=float, default=0.0, help="device OOM probability")
    ap.add_argument("--p-slow", type=float, default=0.0, help="slow-request probability")
    ap.add_argument("--slow-s", type=float, default=0.0, help="injected slowness (seconds)")
    ap.add_argument("--p-session-append", type=float, default=0.0,
                    help="session append fault probability (pre-encode)")
    ap.add_argument("--p-session-journal", type=float, default=0.0,
                    help="session WAL write fault probability (post-encode)")
    ap.add_argument("--max-per-site", type=int, default=2,
                    help="fire cap per (fault site, request)")


def flag_table() -> str:
    """Markdown table of every flag the shared ``add_*_args`` builders define.

    docs/serving.md embeds the reference launcher's table between its
    ``FLAG_TABLE`` markers; this one is equal to it character for character
    (``tests/test_torch_service.py`` holds them equal), so the page documents
    both launchers.
    """
    rows = [
        "| flag | group | default | meaning |",
        "| --- | --- | --- | --- |",
    ]
    for build in (add_service_args, add_workload_args, add_fault_args):
        group = build.__name__.removeprefix("add_").removesuffix("_args")
        ap = argparse.ArgumentParser(add_help=False)
        build(ap)
        for act in ap._actions:
            flag = ", ".join(f"`{s}`" for s in act.option_strings)
            default = "off" if act.const is True else f"`{act.default}`"
            rows.append(f"| {flag} | {group} | {default} | {act.help or ''} |")
    return "\n".join(rows)


def build_injector(args) -> Optional[FaultInjector]:
    if not (args.p_codec or args.p_dispatch or args.p_oom or args.p_slow
            or args.p_session_append or args.p_session_journal):
        return None
    return FaultInjector(
        FaultConfig(
            p_codec=args.p_codec,
            p_dispatch=args.p_dispatch,
            p_oom=args.p_oom,
            p_slow=args.p_slow,
            slow_s=args.slow_s,
            p_session_append=args.p_session_append,
            p_session_journal=args.p_session_journal,
            max_per_site=args.max_per_site,
        ),
        seed=args.seed,
    )


def build_service(args, pipeline_depth: Optional[int] = None, device=None) -> FFCzService:
    """One service from parsed flags; ``pipeline_depth`` overrides the flag
    (matched serial/pipelined pairs are built this way).  ``device``: where
    the service's engine runs (None means ``"cuda"``); on the card the
    engine's transform is ``"pallas"``, the port's kernels."""
    dev = resolve_device(device)
    fft_impl = "pallas" if dev.type == "cuda" else FFCzConfig.fft_impl
    return FFCzService(
        get_compressor(args.base),
        config=ServiceConfig(
            max_batch=args.max_batch,
            block=args.block,
            deadline_s=args.deadline_s,
            max_retries=args.max_retries,
            seed=args.seed,
            pipeline_depth=args.pipeline_depth if pipeline_depth is None else pipeline_depth,
            max_queue=args.max_queue,
            max_sessions=args.max_sessions,
            session_lease_s=args.session_lease,
            session_journal_dir=args.session_journal_dir,
        ),
        injector=build_injector(args),
        engine=CorrectionEngine(fft_impl=fft_impl, device=dev),
    )


def field_config(args, svc: FFCzService) -> FFCzConfig:
    """Whole-field request config; its transform is the service engine's."""
    return FFCzConfig(E_rel=args.e_rel, Delta_rel=args.delta_rel, max_iters=300,
                      verify=False, crc=args.crc, fft_impl=svc.engine.fft_impl)


def kernel_launches() -> dict:
    """Launches of the correction kernels so far (each wrapper counts its own;
    the CPU twins count none)."""
    counts = {**scube_ops.launches, **fcube_ops.launches, **rfft_ops.launches}
    return {k: v for k, v in counts.items() if v}


def submit_session(svc: FFCzService, rng: np.random.Generator, args) -> List[str]:
    """Queue one live session's workload: ``--session-frames`` coherent
    appends, one duplicate retry of the last frame, and a finalize.  Falls
    back to a whole-field request when session admission rejects."""
    cfg = field_config(args, svc)
    edge = args.field_size
    try:
        sid = svc.open_session(cfg, TemporalConfig(mode="field", keyframe_interval=4))
    except ResourceExhausted:
        return [svc.submit_compress(rng.standard_normal((edge, edge)).astype(np.float32), cfg)]
    uids = []
    x = rng.standard_normal((edge, edge)).astype(np.float32)
    n_frames = max(1, args.session_frames)
    for t in range(n_frames):
        last = x
        uids.append(svc.submit_append(sid, t, x))
        x = x + 0.05 * rng.standard_normal((edge, edge)).astype(np.float32)
    # a client retry after an ambiguous failure: same seq, same content
    uids.append(svc.submit_append(sid, n_frames - 1, last))
    uids.append(svc.submit_finalize(sid))
    return uids


def submit_mixed(svc: FFCzService, rng: np.random.Generator, args, n: int) -> List[str]:
    """Queue ``n`` mixed compression requests drawn from the workload flags."""
    cfg = field_config(args, svc)
    edge = args.field_size
    uids = []
    for _ in range(n):
        draw = rng.random()
        if draw < args.session_frac:
            uids.extend(submit_session(svc, rng, args))
        elif draw < args.session_frac + (1 - args.session_frac) * args.pencil_frac:
            size = int(rng.integers(args.block // 2, 4 * args.block))
            uids.append(svc.submit_pencils(rng.standard_normal(size).astype(np.float32),
                                           args.e_rel, args.delta_rel))
        else:
            uids.append(svc.submit_compress(rng.standard_normal((edge, edge)).astype(np.float32),
                                            cfg))
    return uids


def main():
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "Full flag reference (with the serving error taxonomy and "
            "degradation ladder): docs/serving.md — its flag table is "
            "this module's flag_table(), equal to the reference launcher's."
        ),
    )
    ap.add_argument("--requests", type=int, default=16, help="total requests to generate")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default; raises without a card) or cpu")
    add_service_args(ap)
    add_workload_args(ap)
    add_fault_args(ap)
    args = ap.parse_args()

    svc = build_service(args, device=args.device)
    injector = svc.injector
    rng = np.random.default_rng(args.seed)
    submit_mixed(svc, rng, args, args.requests)
    responses = dict(svc.drain())

    # feed a sample of the produced blobs back through decode (session
    # appends ack with receipts, not bytes — only containers decode)
    blobs = [r.payload for r in responses.values() if r.ok and isinstance(r.payload, bytes)]
    for i, blob in enumerate(blobs):
        if args.corrupt_frac and rng.random() < args.corrupt_frac:
            blob = injector.corrupt_blob(blob) if injector else blob[: len(blob) // 2]
        responses[svc.submit_decompress(blob, uid=f"dec-{i}")] = None
    responses.update(svc.drain())
    svc.close()

    lat = []
    for uid in responses:  # drain() already ordered by submission
        r = responses[uid]
        if r is None:
            continue
        lat.append(r.stats.latency_s)
        rungs = ",".join(r.stats.rungs) or "-"
        if r.ok:
            if isinstance(r.payload, bytes):
                size = len(r.payload)
            elif hasattr(r.payload, "n_bytes"):  # session FrameReceipt
                size = r.payload.n_bytes
            elif hasattr(r.payload, "size"):  # decompressed ndarray
                size = r.payload.size
            else:  # flush byte counts, abort acks
                size = r.payload
            print(f"{uid:>8}  ok        rungs={rungs}  bytes/elems={size}")
        else:
            print(f"{uid:>8}  REJECTED  rungs={rungs}  {r.error['type']}: {r.error['message']}")
    lat = np.sort(np.asarray(lat))
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"\n{len(lat)} requests drained  p50={p50 * 1e3:.1f}ms  p99={p99 * 1e3:.1f}ms")
    print("counters:", dict(svc.counters))
    print("stage timers (s):", {k: round(v, 4) for k, v in svc.timers.items()})
    print(f"fft_impl={svc.engine.fft_impl}  kernel launches:", kernel_launches())


if __name__ == "__main__":
    main()
