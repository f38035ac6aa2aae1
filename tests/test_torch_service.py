"""The port's FFCz service on the CPU engine, held against the reference's.

* ``pipeline_depth`` 1 and 2 give byte-identical responses and stats (the
  contract of ``tests/test_service_pipeline.py``), over every request kind.
* Under a seeded ``FaultInjector`` the per-request dispositions, rungs,
  attempts and the service's counters equal the reference service's on the
  same workload (small fields, which both packages converge).
* Corrupt blobs reject as ``BlobCorruptError``; an OOM bisect evicts the
  staging buffer first.
* A failure of the port's own device code (a kernel that does not build or
  launch, a sticky CUDA error) rejects the request: it is never completed
  on a lower ``fft_impl`` rung.  An injected dispatch error still walks the
  reference's ladder.
* ``flag_table()`` is the reference launcher's; the service and the launcher
  raise without a card unless given the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.launch.serve_ffcz as ref_launch
import repro.runtime.faults as ref_faults
import repro.serving.ffcz_service as ref_service
from repro.compressors import get_compressor as r_get
from repro.core.ffcz import FFCz as RefFFCz
from repro.core.ffcz import FFCzBlob as RefBlob
from repro.core.ffcz import FFCzConfig as RefConfig
from repro.core.temporal import TemporalConfig as RefStream
from repro_torch.compressors import get_compressor
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.errors import BlobCorruptError
from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig
from repro_torch.core.temporal import TemporalConfig, TemporalStream
from repro_torch.kernels import build
from repro_torch.kernels.rfft import ops as rfft_ops
from repro_torch.launch import serve_ffcz
from repro_torch.runtime.faults import FaultConfig, FaultInjector
from repro_torch.serving import FFCzService, ServiceConfig, decode_pencil_blob

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 20260809
FIELD_KW = dict(E_rel=1e-3, Delta_rel=1e-3, max_iters=300, verify=False)
STREAM_KW = dict(mode="field", keyframe_interval=2)


def _service(depth=2, injector=None, engine=None, **cfg_kw):
    cfg = dict(max_batch=4, block=64, deadline_s=30.0, seed=SEED, pipeline_depth=depth)
    cfg.update(cfg_kw)
    return FFCzService(get_compressor("szlike"), engine=engine or CorrectionEngine(device="cpu"),
                       config=ServiceConfig(**cfg), injector=injector)


def _ref_service(depth=2, injector=None, **cfg_kw):
    cfg = dict(max_batch=4, block=64, deadline_s=30.0, seed=SEED, pipeline_depth=depth)
    cfg.update(cfg_kw)
    return ref_service.FFCzService(r_get("szlike"), config=ref_service.ServiceConfig(**cfg), injector=injector)


def _workload(svc, ref: bool, seed=SEED, fft_impl="pallas"):
    """Fields (even and odd last axes), pencils, a stream, a live session with
    a duplicate retry and a finalize; returns the uids in submission order."""
    Config, Stream = (RefConfig, RefStream) if ref else (FFCzConfig, TemporalConfig)
    cfg = Config(**FIELD_KW, fft_impl=fft_impl)
    rng = np.random.default_rng(seed)
    uids = []
    for shape in ((12, 12), (16, 15), (10, 10)):
        uids.append(svc.submit_compress(rng.standard_normal(shape).astype(np.float32), cfg))
    for _ in range(6):
        size = int(rng.integers(40, 300))
        uids.append(svc.submit_pencils(rng.standard_normal(size).astype(np.float32), 1e-3, 1e-3))
    frames = [(rng.standard_normal((12, 12)) * 0.1 + np.arange(12.0)).astype(np.float32) for _ in range(3)]
    uids.append(svc.submit_stream(frames, cfg, Stream(**STREAM_KW)))
    sid = svc.open_session(Config(**FIELD_KW), Stream(**STREAM_KW), session_id="live")
    for t, f in enumerate(frames):
        uids.append(svc.submit_append(sid, t, f))
    uids.append(svc.submit_append(sid, 2, frames[2]))  # a client's retry
    uids.append(svc.submit_finalize(sid))
    return uids


def _decode_round(svc, responses):
    """Submit every produced blob for decode (every other one flipped)."""
    uids = []
    blobs = [r.payload for r in responses.values() if r.ok and isinstance(r.payload, bytes)]
    for i, blob in enumerate(blobs):
        bad = bytearray(blob)
        if i % 2:
            bad[len(bad) // 2] ^= 0x40
        uids.append(svc.submit_decompress(bytes(bad), uid=f"dec-{i}"))
    return uids, blobs


def _summary(responses):
    out = {}
    for uid, r in responses.items():
        err = None if r.ok else (r.error["type"], r.error["disposition"], r.error["stage"])
        out[uid] = (r.ok, r.stats.rungs, r.stats.attempts, r.stats.fft_impl, r.stats.converged, err)
    return out


def _payload_bytes(r):
    p = r.payload
    if isinstance(p, bytes):
        return p
    if isinstance(p, np.ndarray):
        return p.tobytes()
    return repr(p).encode()


# -- depth parity ------------------------------------------------------------------


def test_depths_give_byte_identical_responses_and_stats():
    runs = []
    for depth in (1, 2):
        svc = _service(depth)
        uids = _workload(svc, ref=False)
        res = svc.drain()
        dec_uids, _ = _decode_round(svc, res)
        res.update(svc.drain())
        svc.close()
        assert list(res) == uids + dec_uids  # submission order
        runs.append(({u: (_payload_bytes(r), _summary({u: r})[u]) for u, r in res.items()},
                     dict(svc.counters), svc.sessions.counters))
    assert runs[0] == runs[1]
    summary, counters, _ = runs[0]
    assert all(summary[u][1][0] for u in summary if not u.startswith("dec-"))
    assert counters["rejected"] == sum(1 for u in summary if not summary[u][1][0])


def test_chaos_responses_are_byte_identical_across_depths():
    runs = []
    for depth in (1, 2):
        inj = FaultInjector(FaultConfig(p_codec=0.3, p_dispatch=0.3, p_oom=0.5, max_per_site=2), seed=7)
        svc = _service(depth, injector=inj)
        _workload(svc, ref=False)
        res = svc.drain()
        svc.close()
        runs.append(({u: (_payload_bytes(r), _summary({u: r})[u]) for u, r in res.items()}, dict(svc.counters)))
    assert runs[0] == runs[1]


# -- against the reference service ---------------------------------------------------


@pytest.mark.parametrize("seed", [7, SEED])
def test_fault_dispositions_rungs_and_counters_are_the_references(seed):
    cfg = dict(p_codec=0.3, p_dispatch=0.3, p_oom=0.5, max_per_site=2)
    port = _service(2, injector=FaultInjector(FaultConfig(**cfg), seed=seed))
    ref = _ref_service(2, injector=ref_faults.FaultInjector(ref_faults.FaultConfig(**cfg), seed=seed))
    got_uids, want_uids = _workload(port, ref=False, seed=seed), _workload(ref, ref=True, seed=seed)
    got, want = port.drain(), ref.drain()
    port.close()
    ref.close()
    assert got_uids == want_uids and list(got) == list(want)
    assert _summary(got) == _summary(want)
    assert port.counters == ref.counters
    assert port.sessions.counters == ref.sessions.counters
    rungs = [g for r in got.values() for g in r.stats.rungs]
    assert any(g.startswith("retry:") for g in rungs) and "bisect" in rungs


def test_clean_run_takes_no_rung_and_matches_the_references_decodes():
    port, ref = _service(2), _ref_service(2)
    _workload(port, ref=False)
    _workload(ref, ref=True)
    got, want = port.drain(), ref.drain()
    assert _summary(got) == _summary(want)
    assert all(not r.stats.rungs for r in got.values())
    assert all(r.stats.fft_impl == "pallas" for u, r in got.items() if r.stats.fft_impl is not None)
    # every completed compression decodes, in the reference too, within its bounds
    for r in got.values():
        if not (r.ok and isinstance(r.payload, bytes)):
            continue
        data = r.payload
        if data[:4] == b"FFSB":
            assert np.array_equal(decode_pencil_blob(data, get_compressor("szlike")),
                                  ref_service.decode_pencil_blob(data, r_get("szlike")))
        elif data[:4] == b"FFCS":
            assert TemporalStream.from_bytes(data).n_frames == 3
        else:
            got_dec = FFCz(get_compressor("szlike"), FFCzConfig(**FIELD_KW), device="cpu").decompress(
                FFCzBlob.from_bytes(data))
            want_dec = RefFFCz(r_get("szlike"), RefConfig(**FIELD_KW)).decompress(RefBlob.from_bytes(data))
            assert np.array_equal(got_dec, want_dec)
    port.close()
    ref.close()


# -- rejections, bisect, the port's kernel faults -------------------------------------


def test_corrupt_blobs_reject_as_blob_corrupt():
    svc = _service(1)
    rng = np.random.default_rng(1)
    blob = FFCz(get_compressor("szlike"), FFCzConfig(**FIELD_KW, crc=True), device="cpu").compress(
        rng.standard_normal((10, 10)).astype(np.float32)).to_bytes()
    inj = FaultInjector(seed=2)
    uids = [svc.submit_decompress(blob), svc.submit_decompress(inj.flip_bit(blob, 40)),
            svc.submit_decompress(inj.truncate(blob, 30)), svc.submit_decompress(b"\x00garbage"),
            svc.submit_decompress(b"FFSB\x01" + b"\x00" * 12), svc.submit_decompress(b"FFCS\x01\x00")]
    res = svc.drain()
    assert res[uids[0]].ok
    for u in uids[1:]:
        assert not res[u].ok and res[u].error["type"] == "BlobCorruptError" and res[u].error["disposition"] == "reject"
    with pytest.raises(BlobCorruptError):
        decode_pencil_blob(b"FFSB", get_compressor("szlike"))


def test_oom_bisect_evicts_the_staging_buffer():
    inj = FaultInjector(FaultConfig(p_oom=1.0, max_per_site=1), seed=SEED)
    svc = _service(2, injector=inj)
    rng = np.random.default_rng(SEED)
    uids = [svc.submit_pencils(rng.standard_normal(150).astype(np.float32), 1e-3, 1e-3) for _ in range(4)]
    res = svc.drain()
    svc.close()
    assert all(res[u].ok and "bisect" in res[u].stats.rungs for u in uids)
    assert svc.counters["bisects"] >= 1 and svc.counters["buffer_evictions"] >= 1
    assert (4 * -(-150 // 64), 64) not in svc._staging


def _failing_epilogue(exc):
    def fail(*args, **kw):
        raise exc
    return fail


def _unloadable_epilogue(how, monkeypatch, tmp_path):
    """Kernel 3 as its wrapper starts on a CUDA tensor: it asks for its
    library, whose build or load fails with an ``OSError`` (an nvcc that
    cannot be started, a library file that does not load)."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    if how == "exec":
        nvcc = tmp_path / "nvcc"
        nvcc.write_text("#!/bin/sh\n")
        nvcc.chmod(0o644)  # not executable
        monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    else:
        build.library_path("rfft").write_bytes(b"not a shared library")

    def fail(*args, **kw):
        build.library("rfft")
        raise AssertionError("the library loaded")
    return fail


_FAILURES = {
    "launch": build.KernelError("repro_torch: rfft_fwd_epilogue launch failed with cudaError_t 700"),
    "build": build.KernelError("repro_torch: nvcc failed for csrc/rfft.cu:\nerror"),
    "sticky": RuntimeError("CUDA error: an illegal memory access was encountered"),
    "exec": None,
    "load": None,
}


@pytest.mark.parametrize("exc", list(_FAILURES))
@pytest.mark.parametrize("depth", [1, 2])
def test_a_failing_kernel_rejects_and_never_falls_back(monkeypatch, tmp_path, exc, depth):
    """Kernel 3 (the pallas loop's forward epilogue) fails: the request is
    rejected, not completed on packed or xla, and nothing is retried."""
    fail = (_failing_epilogue(_FAILURES[exc]) if _FAILURES[exc] is not None
            else _unloadable_epilogue(exc, monkeypatch, tmp_path))
    monkeypatch.setattr(rfft_ops, "fwd_epilogue_fused", fail)
    svc = _service(depth)
    x = np.random.default_rng(3).standard_normal((12, 12)).astype(np.float32)
    u = svc.submit_compress(x, FFCzConfig(**FIELD_KW, fft_impl="pallas"))
    r = svc.drain()[u]
    svc.close()
    assert not r.ok and r.error["type"] == "PermanentError" and r.error["disposition"] == "reject"
    assert r.stats.rungs == () and r.stats.attempts == 0 and r.stats.fft_impl == "pallas"
    assert svc.counters["fallbacks"] == 0 and svc.counters["retries"] == 0


def test_a_failing_kernel_rejects_its_whole_pencil_bucket(monkeypatch):
    monkeypatch.setattr(rfft_ops, "fwd_epilogue_fused",
                        _failing_epilogue(build.KernelError("repro_torch: launch failed with cudaError_t 719")))
    svc = _service(2, engine=CorrectionEngine(fft_impl="pallas", device="cpu"))
    rng = np.random.default_rng(4)
    uids = [svc.submit_pencils(rng.standard_normal(200).astype(np.float32), 1e-3, 1e-5) for _ in range(3)]
    res = svc.drain()
    svc.close()
    assert all(not res[u].ok and res[u].error["type"] == "PermanentError" for u in uids)
    assert svc.counters["retries"] == 0 and svc.counters["bisects"] == 0


def test_a_transient_dispatch_failure_still_walks_the_ladder(monkeypatch):
    """The contrast: an injected dispatch error (a plain RuntimeError) on the
    pallas rung is transient, so the request completes on packed."""
    monkeypatch.setattr(rfft_ops, "fwd_epilogue_fused",
                        _failing_epilogue(ref_faults.InjectedDispatchError("injected dispatch fault")))
    svc = _service(1, max_retries=1)
    x = np.random.default_rng(3).standard_normal((12, 12)).astype(np.float32)
    u = svc.submit_compress(x, FFCzConfig(**FIELD_KW, fft_impl="pallas"))
    r = svc.drain()[u]
    assert r.ok and r.stats.fft_impl == "packed"
    assert r.stats.rungs == ("retry:execute", "fallback:packed")


# -- the launcher, devices -------------------------------------------------------------


def test_flag_table_is_the_references():
    assert serve_ffcz.flag_table() == ref_launch.flag_table()


def test_service_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        assert FFCzService(get_compressor("szlike")).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FFCzService(get_compressor("szlike"))
    assert FFCzService(get_compressor("szlike"), device="cpu").engine.device.type == "cpu"
    with pytest.raises(ValueError, match="either an engine or a device"):
        FFCzService(get_compressor("szlike"), engine=CorrectionEngine(device="cpu"), device="cpu")


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_ffcz", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_launcher_runs_on_the_cpu_and_raises_without_a_card(tmp_path):
    out = _launch("--requests", "6", "--field-size", "12", "--block", "64", "--session-frac", "0.3",
                  "--corrupt-frac", "0.5", "--session-journal-dir", str(tmp_path), "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "requests drained" in out.stdout and "counters:" in out.stdout
    # the CPU keeps the reference's transform, and the twins count no launch
    assert "fft_impl=xla  kernel launches: {}" in out.stdout
    if not torch.cuda.is_available():
        out = _launch("--requests", "2")
        assert out.returncode != 0 and "CUDA" in out.stderr
