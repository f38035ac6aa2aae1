#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
(into ``build/``), holds each kernel against its plain PyTorch twin on the
card at the main path's shapes, then drives ``FFCz.compress`` /
``FFCz.decompress`` with ``FFCzConfig(fft_impl="pallas")`` at full size and
rechecks both stored bounds in float64.  Phases, one JSON line each:

  1 device    card name, count, nvidia-smi name and power limit
  2 build     nvcc wall seconds (one process per source, in parallel)
  3 kernels   each kernel vs its twin: bitwise (Z of the forward epilogue
              within 2 ulp), CUDA-event times of kernel and twin, bound
  4 even      nyx-like-256 (256^3), szlike base: kernels 3 and 4 launch
  5 odd       the same field cropped to 256x256x255: kernels 1 and 2 launch
  6 pointwise pspec_rel (pointwise Delta) and an E_roi mask (pointwise E)
  7 golden    the three blobs in tests/data decode to their stored outputs
  8 summary   the kernels line, the nvidia-smi line, then {"ok": true, ...}

Any failure exits non-zero before the last line.  The script needs a CUDA
card and the repository around it: without either it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# phase 6 runs at 128^3, not the 256^3 of phases 4-5: the pspec bound makes
# every frequency component an edit (~8.5M at 256^3), and the host Huffman
# coder (a byte-identical copy of the reference's) would not finish in the
# smoke's time limit
CUTS = ["phase 6 (pspec_rel, E_roi) at 128^3 instead of 256^3: host Huffman coding of the "
        "dense pspec edit stream is the limit"]


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_ulp(a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    import torch

    ia = torch.view_as_real(a).contiguous().view(torch.int32).to(torch.int64)
    ib = torch.view_as_real(b).contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(torch.max(torch.abs(ia - ib)))


def same(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def phase_kernels(dev):
    """Each kernel against its twin at the main path's shapes; returns the
    per-kernel records of the summary line (launches filled in later)."""
    import torch

    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)

    even, odd = (256, 256, 256), (256, 256, 255)
    tol, slack = 1e-5, 0.5
    records = {}
    layouts = {}

    def produced(name, t):
        """Record the strides cuFFT handed back (the loop makes every
        transform output contiguous before a kernel sees it)."""
        layouts[name] = {"shape": list(t.shape), "stride": list(t.stride()),
                         "contiguous": t.is_contiguous()}
        return t.contiguous()

    def bound(case, bytes_moved, flops):
        """Add the least time the card could take for the case's work: the
        bytes each input read once and each output written once over HBM
        bandwidth, or its float32 operations over the FP32 peak."""
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        case.update(bytes=bytes_moved, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        return case

    def record(name, source, replaces, cases):
        # the summary line carries the scalar-bound case: the bound kind of
        # the main path's Delta_rel runs (phases 4 and 5)
        main = cases[0]
        records[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
        }
        emit("kernels", kernel=name, cases=cases)

    # row 1: s-cube on the odd-axis fallback's field, scalar and pointwise E
    x = randn(odd)
    cases = []
    for label, E in (("scalar", 1.0), ("pointwise", uniform(odd, 0.5, 1.5))):
        got = scube_ops.project_scube_fused(x, E)
        want = scube_ops.project_scube_plain(x, E)
        require(all(same(g, w) for g, w in zip(got, want)), f"scube {label}: kernel != twin")
        n = x.numel()
        cases.append(bound({
            "bound": label, "bitwise": True, "max_abs_err": 0.0,
            "ms": cuda_time_ms(lambda: scube_ops.project_scube_fused(x, E)),
            "plain_ms": cuda_time_ms(lambda: scube_ops.project_scube_plain(x, E)),
        }, bytes_moved=4 * n + (4 * n if label == "pointwise" else 4) + 8 * n, flops=3 * n))
    record("scube", "src/repro_torch/csrc/scube.cu", "src/repro/kernels/scube/kernel.py:19", cases)

    # row 2: f-cube + count on the odd field's half-spectrum (256x256x128)
    delta = produced("rfftn 256x256x255", torch.fft.rfftn(randn(odd)))
    d_scalar = float(delta.real.std())
    cases = []
    for label, D in (("scalar", d_scalar), ("pointwise", uniform(delta.shape, 0.5, 1.5) * d_scalar)):
        got = fcube_ops.project_fcube_fused(delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)
        want = fcube_ops.project_fcube_plain(delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)
        require(all(same(g, w) for g, w in zip(got, want)), f"fcube {label}: kernel != twin")
        require(0 < int(got[2]) < 2 * delta.numel(), f"fcube {label}: degenerate count {int(got[2])}")
        n = delta.numel()
        cases.append(bound({
            "bound": label, "bitwise": True, "violations": int(got[2]), "max_abs_err": 0.0,
            "ms": cuda_time_ms(lambda: fcube_ops.project_fcube_fused(
                delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)),
            "plain_ms": cuda_time_ms(lambda: fcube_ops.project_fcube_plain(
                delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)),
        }, bytes_moved=8 * n + (4 * n if label == "pointwise" else 4) + 16 * n + 4, flops=12 * n))
    record("fcube", "src/repro_torch/csrc/fcube.cu", "src/repro/kernels/fcube/kernel.py:36", cases)

    # row 3: forward epilogue on the even field's half-spectrum (256x256x129)
    delta = produced("rfftn 256x256x256", torch.fft.rfftn(randn(even)))
    d_scalar = float(delta.real.std())
    cases = []
    for label, D in (("scalar", d_scalar), ("pointwise", uniform(delta.shape, 0.5, 1.5) * d_scalar)):
        got = rfft_ops.fwd_epilogue_fused(delta, D, weighted=True, check_tol=tol, check_slack=slack)
        want = rfft_ops.fwd_epilogue_plain(delta, D, weighted=True, check_tol=tol, check_slack=slack)
        for i, part in ((0, "clipped"), (1, "displacement"), (3, "violations")):
            require(same(got[i], want[i]), f"rfft_fwd_epilogue {label}: {part} kernel != twin")
        z_bitwise = same(got[2], want[2])
        ulp = 0 if z_bitwise else max_ulp(got[2], want[2])
        require(got[2].shape == want[2].shape and ulp <= 2, f"rfft_fwd_epilogue {label}: Z off by {ulp} ulp")
        n, h = delta.numel(), delta.shape[-1]
        nz = n // h * (h - 1)  # Z covers the first Nh of the Nh + 1 columns
        cases.append(bound({
            "bound": label, "bitwise": z_bitwise, "z_max_ulp": ulp, "violations": int(got[3]),
            "max_abs_err": float(torch.max(torch.abs(got[2] - want[2]))),
            "ms": cuda_time_ms(lambda: rfft_ops.fwd_epilogue_fused(
                delta, D, weighted=True, check_tol=tol, check_slack=slack)),
            "plain_ms": cuda_time_ms(lambda: rfft_ops.fwd_epilogue_plain(
                delta, D, weighted=True, check_tol=tol, check_slack=slack)),
        }, bytes_moved=8 * n + (4 * n if label == "pointwise" else 4) + 8 * h + 16 * n + 8 * nz + 4,
            flops=12 * n + 20 * nz))
    record("rfft_fwd_epilogue", "src/repro_torch/csrc/rfft.cu",
           "src/repro/kernels/rfft/kernel.py:50", cases)

    # row 4: s-clip of the half-length ifftn output (256x256x128 complex)
    z = produced("ifftn 256x256x128",
                 torch.fft.ifftn(torch.complex(randn((256, 256, 128)), randn((256, 256, 128)))))
    produced("irfftn 256x256x255", torch.fft.irfftn(delta[..., :128], s=odd))
    e_scalar = float(z.real.std())
    cases = []
    for label, E in (("scalar", e_scalar), ("pointwise", uniform(even, 0.5, 1.5) * e_scalar)):
        got = rfft_ops.unpack_sclip_fused(z, E, even)
        want = rfft_ops.unpack_sclip_plain(z, E, even)
        require(all(same(g, w) for g, w in zip(got, want)), f"unpack_sclip {label}: kernel != twin")
        n = 2 * z.numel()
        cases.append(bound({
            "bound": label, "bitwise": True, "max_abs_err": 0.0,
            "ms": cuda_time_ms(lambda: rfft_ops.unpack_sclip_fused(z, E, even)),
            "plain_ms": cuda_time_ms(lambda: rfft_ops.unpack_sclip_plain(z, E, even)),
        }, bytes_moved=4 * n + (4 * n if label == "pointwise" else 4) + 8 * n, flops=3 * n))
    record("unpack_sclip", "src/repro_torch/csrc/scube.cu",
           "src/repro/kernels/rfft/kernel.py:151", cases)
    emit("fft_layouts", outputs=layouts)
    return records


def reset_launches():
    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    for counters in (scube_ops.launches, fcube_ops.launches, rfft_ops.launches):
        for k in counters:
            counters[k] = 0
    return lambda: {**scube_ops.launches, **fcube_ops.launches, **rfft_ops.launches}


def recheck(x, dec, blob):
    """Float64 margins of ``dec`` against the bounds ``blob`` STORES."""
    import numpy as np

    from repro_torch.core.cubes import rfft_shape

    eps = dec.astype(np.float64) - np.asarray(x, np.float32).astype(np.float64)
    if blob.roi_bound is not None:
        E = np.frombuffer(blob.roi_bound, np.float32).reshape(blob.shape).astype(np.float64)
    else:
        E = blob.E
    d = np.fft.rfftn(eps)
    if blob.pointwise_delta is not None:
        D = np.frombuffer(blob.pointwise_delta, np.float32).reshape(rfft_shape(blob.shape))
        D = D.astype(np.float64)
    else:
        D = blob.Delta_scalar
    spatial = float(np.min(E - np.abs(eps)))
    frequency = float(np.min(D - np.maximum(np.abs(d.real), np.abs(d.imag))))
    return spatial, frequency


def run_case(phase, label, x, cfg, dev, must_launch):
    """Drive compress + decompress once with the launch counts zeroed just
    before and read just after; recheck the stored bounds in float64."""
    from repro_torch.compressors import get_compressor
    from repro_torch.core.ffcz import FFCz

    codec = FFCz(get_compressor("szlike"), cfg, device=dev)
    read = reset_launches()
    blob = codec.compress(x)
    t0 = time.perf_counter()
    dec = codec.decompress(blob)
    decode_s = time.perf_counter() - t0
    counts = read()
    spatial, frequency = recheck(x, dec, blob)
    st = blob.stats
    emit(phase, case=label, shape=list(x.shape), iterations=st.iterations, converged=st.converged,
         spatial_margin=spatial, frequency_margin=frequency, stage_seconds=st.stage_seconds,
         decode_seconds=decode_s, launches=counts, total_bytes=st.total_bytes,
         n_active_spatial=st.n_active_spatial, n_active_frequency=st.n_active_frequency)
    require(dec.shape == tuple(x.shape) and bool((dec == dec).all()), f"{label}: bad decode")
    require(st.converged, f"{label}: POCS did not converge in {st.iterations} iterations")
    require(spatial >= 0 and frequency >= 0, f"{label}: stored bound violated")
    for k in must_launch:
        require(counts[k] > 0, f"{label}: kernel {k} never launched on the main path")
    return counts, st.iterations


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from repro_torch.compressors import get_compressor
    from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig
    from repro_torch.data.fields import make_field
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, cuts=CUTS)

    emit("build", seconds=build.build_all(), nvcc=build.nvcc(), flags=list(build.NVCC_FLAGS))

    records = phase_kernels(dev)

    # 4: the main path, even last axis — the fused epilogues (kernels 3, 4)
    x = make_field("nyx-like-256")
    cfg = FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas", max_iters=3000)
    counts, iters = run_case("even", "nyx-like-256 Delta_rel", x, cfg, dev,
                             ("rfft_fwd_epilogue", "unpack_sclip"))
    for k in ("rfft_fwd_epilogue", "unpack_sclip"):
        records[k]["launches"] = counts[k]
        records[k]["launches_per_iteration"] = counts[k] / iters

    # 5: odd last axis — the static fallback to the fcube/scube kernels
    x_odd = np.ascontiguousarray(x[..., :255])
    counts, iters = run_case("odd", "nyx-like-256[..., :255] Delta_rel", x_odd, cfg, dev,
                             ("fcube", "scube"))
    for k in ("fcube", "scube"):
        records[k]["launches"] = counts[k]
        records[k]["launches_per_iteration"] = counts[k] / iters

    # 6: pointwise bounds — Delta_k grid (pspec) and an E_n grid (ROI mask)
    x128 = make_field("nyx-like-128")
    run_case("pointwise", "nyx-like-128 pspec_rel", x128,
             FFCzConfig(E_rel=1e-3, Delta_rel=None, pspec_rel=1e-3, fft_impl="pallas", max_iters=3000),
             dev, ("rfft_fwd_epilogue", "unpack_sclip"))
    mask = np.zeros(x128.shape, dtype=bool)
    mask[32:96, 32:96, 32:96] = True
    run_case("pointwise", "nyx-like-128 E_roi", x128,
             FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, E_roi=mask, fft_impl="pallas", max_iters=3000),
             dev, ("rfft_fwd_epilogue", "unpack_sclip"))

    # 7: golden fixtures written by the reference package decode bitwise
    data = ROOT / "tests" / "data"
    codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-3, Delta_rel=1e-3), device=dev)
    for blob_name, out_name in (("legacy_blob_v0.bin", "legacy_blob_v0_output.npy"),
                                ("padfree_v1_blob.bin", "padfree_v1_output.npy"),
                                ("uneven_v1_blob.bin", "uneven_v1_output.npy")):
        got = codec.decompress(FFCzBlob.from_bytes((data / blob_name).read_bytes()))
        want = np.load(data / out_name)
        require(got.dtype == want.dtype and np.array_equal(got, want), f"golden {blob_name} differs")
        emit("golden", blob=blob_name, bitwise=True)

    # 8: summary
    kernels = [records[k] for k in ("scube", "fcube", "rfft_fwd_epilogue", "unpack_sclip")]
    for r in kernels:
        require(r["launches"] > 0, f"{r['name']} has no launches on the main path")
    emit("summary", seconds=time.perf_counter() - t_start,
         kernels=[{"name": r["name"], "launches": r["launches"], "ok": True} for r in kernels])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        emit("failed", error=str(e))
        sys.exit(1)
