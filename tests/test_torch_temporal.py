"""The port's temporal stream codec, held against the reference's on the CPU.

Host parts byte for byte: the predictor, the residual-frame bounds (host
float64), the ``FFCS`` container (header, seek index, CRC) and the ``FFSB``
pencil envelope.  The stream's own contracts as ``tests/test_temporal.py``
sets them, in field and pencil modes on an odd last axis: seeks bitwise
equal to the sequential decode, every frame within the header's (E, Delta)
rechecked in float64, cold keyframes byte-identical to ``FFCz.compress``,
export/restore resuming to the uninterrupted bytes.  Across packages:
containers and exported encoder state cross both ways and decode within
their header bounds.

Where streams are byte-identical across the packages (``warm_start=False``):
the configurations of :data:`SAME_BYTES` (absolute bounds, field and pencil
modes, both fft_impls), in which neither package's POCS loop edits a
spectrum (every frame converges at its first check: 1 iteration), so a
stream is host stages only.  Where the loop edits, torch's and XLA's
float32 FFTs round differently and the bytes differ (the device stages are
held bound-class: ROADMAP.md, "How held against works here"); the iteration
counts still agree there (:func:`test_acting_loop_agrees_on_iterations`).
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

import repro.core.temporal as rt
from repro.compressors import get_compressor as r_get
from repro.core.ffcz import FFCzConfig as RefConfig
from repro_torch.compressors import get_compressor
from repro_torch.core import temporal as tt
from repro_torch.core.edits import EncodedEdits
from repro_torch.core.engine import CorrectionEngine, PencilPlan
from repro_torch.core.errors import BlobCorruptError
from repro_torch.core.ffcz import FFCz, FFCzConfig
from repro_torch.core.temporal import TemporalCodec, TemporalConfig, TemporalStream

SHAPE = (40, 35)  # odd last axis: the rfft N//2+1 edge and the fcube/scube kernels


def _frames(n, shape=SHAPE, seed=0, drift=0.05):
    """tests/test_temporal.py's coherent sequence: a fixed field, a drifting
    structured mode and small per-frame noise."""
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(shape) * 0.5 + 4.0).cumsum(axis=0)
    mode = np.cos(np.linspace(0, 2 * np.pi, base.size)).reshape(shape)
    return [np.ascontiguousarray(base + drift * t * mode + 0.01 * rng.standard_normal(shape), dtype=np.float32)
            for t in range(n)]


def _cfg(**kw):
    out = dict(E_rel=1e-3, Delta_rel=1e-3, max_iters=300)
    out.update(kw)
    return out


def _port(mode="field", interval=4, predictor="linear", block=0, **cfg):
    return TemporalCodec(get_compressor("szlike"), FFCzConfig(**_cfg(**cfg)),
                         TemporalConfig(mode=mode, predictor=predictor, keyframe_interval=interval, block=block),
                         device="cpu")


def _ref(mode="field", interval=4, predictor="linear", block=0, **cfg):
    return rt.TemporalCodec(r_get("szlike"), RefConfig(**_cfg(**cfg)),
                            rt.TemporalConfig(mode=mode, predictor=predictor, keyframe_interval=interval, block=block))


def _encode(codec, frames):
    enc = codec.open_stream()
    for x in frames:
        enc.add_frame(x)
    return enc, enc.finish()


def _assert_within_header(data, frames, decoded):
    """Every decoded frame within the header's E and Delta, in float64 (pencil
    mode: each block-pencil's own rfft spectrum)."""
    s = TemporalStream.from_bytes(data)
    assert len(decoded) == len(frames)
    for t, (x, d) in enumerate(zip(frames, decoded)):
        assert d.shape == x.shape and d.dtype == np.float32
        eps = d.astype(np.float64) - x.astype(np.float64)
        assert np.abs(eps).max() <= s.E, t
        if s.mode == "pencils":
            flat = eps.reshape(-1)
            spec = np.fft.rfft(np.pad(flat, (0, (-flat.size) % s.block)).reshape(-1, s.block), axis=-1)
        else:
            spec = np.fft.rfftn(eps)
        assert np.abs(spec.real).max() <= s.Delta and np.abs(spec.imag).max() <= s.Delta, t


# -- host parts, byte for byte -------------------------------------------------


@pytest.mark.parametrize("predictor", ["identity", "linear"])
@pytest.mark.parametrize("depth", [1, 2])
def test_predict_is_the_references(predictor, depth):
    history = _frames(depth, seed=4)
    got, want = tt._predict(history, predictor), rt._predict(history, predictor)
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("mode,block", [("field", 0), ("pencils", 0), ("pencils", 64)])
def test_residual_bounds_are_the_references(mode, block):
    x, prev, prev2 = _frames(3, seed=5)
    pred = tt._predict([prev2, prev], "linear")
    blk = block or SHAPE[-1]
    got = _port(mode, block=block)._residual_bounds(x, pred, 0.0125, 0.75, blk)
    want = _ref(mode, block=block)._residual_bounds(x, pred, 0.0125, 0.75, blk)
    assert got == want  # host float64: exact
    with pytest.raises(tt.InfeasibleBound):
        _port(mode, block=block)._residual_bounds(x, pred, 1e-12, 0.75, blk)


@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_container_parses_to_the_same_fields_and_reserialises(mode):
    frames = _frames(6, seed=1)
    data = _encode(_ref(mode, interval=3), frames)[1]
    got, want = TemporalStream.from_bytes(data), rt.TemporalStream.from_bytes(data)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [got.frame_payload(t) for t in range(6)] == [want.frame_payload(t) for t in range(6)]
    # the port's encoder restored from the reference's payloads writes the same container
    enc = _port(mode, interval=3).restore_stream(
        [(got.frame_payload(t), got.is_keyframe(t)) for t in range(6)],
        shape=got.shape, block=got.block, E0=got.E, Delta0=got.Delta)
    assert enc.finish() == data
    for bad in (b"XXCS" + data[4:], data[:12], data[:got.frames_base - 1]):
        with pytest.raises(BlobCorruptError):
            TemporalStream.from_bytes(bad)
    flipped = bytearray(data)
    flipped[8] ^= 0x10
    with pytest.raises(BlobCorruptError, match="CRC"):
        TemporalStream.from_bytes(bytes(flipped))


def test_pencil_envelope_is_the_references():
    data = _encode(_ref("pencils", interval=2), _frames(3, seed=2))[1]
    s = rt.TemporalStream.from_bytes(data)
    payload = s.frame_payload(0)
    assert payload[:4] == b"FFSB"
    got = tt.decode_pencil_blob(payload, get_compressor("szlike"))
    want = rt.decode_pencil_blob(payload, r_get("szlike"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # rebuild the envelope from its parsed sections: the same bytes
    E, Delta, block, ndim = struct.unpack_from("<ddIB", payload, 5)
    off = 5 + struct.calcsize("<ddIB")
    shape = struct.unpack_from(f"<{ndim}Q", payload, off)
    off += 8 * ndim
    nb, ns, nf = struct.unpack_from("<QQQ", payload, off)
    off += 24
    se = EncodedEdits.from_bytes(payload[off + nb:off + nb + ns])
    fe = EncodedEdits.from_bytes(payload[off + nb + ns:off + nb + ns + nf])
    plan = PencilPlan(block=block, quant_bits=0, E=E, Delta=Delta, E_proj=E, Delta_proj=Delta)
    assert tt._pencil_blob(shape, payload[off:off + nb], se, fe, plan, block) == payload
    for bad in (b"FFSX" + payload[4:], payload[:-1], payload[:7], payload[:4] + b"\x02" + payload[5:]):
        with pytest.raises(BlobCorruptError):
            tt.decode_pencil_blob(bad, get_compressor("szlike"))


# -- the stream's own contracts -------------------------------------------------


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_round_trip_seeks_and_bounds(mode, warm_start):
    frames = _frames(9, seed=3, drift=0.2)
    codec = _port(mode, interval=4, warm_start=warm_start, fft_impl="pallas")
    enc, data = _encode(codec, frames)
    s = TemporalStream.from_bytes(data)
    assert s.n_frames == 9 and s.shape == SHAPE and s.mode == mode
    assert [s.is_keyframe(t) for t in range(9)] == [t % 4 == 0 for t in range(9)]
    assert all(st["converged"] for st in enc.frame_stats)
    dec = codec.decompress_stream(data)
    _assert_within_header(data, frames, dec)
    for t in range(9):
        assert np.array_equal(codec.decode_frame(data, t), dec[t]), t
    with pytest.raises(IndexError):
        codec.decode_frame(data, 9)
    # the encoder's history is the decoder's output (the self-correction argument)
    assert np.array_equal(enc._history[-1], dec[-1])


@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_warm_spectrum_stays_a_device_tensor(mode):
    """The warm state between frames is a tensor on the engine's device (for
    fields the polish's spectrum, for pencils the loop's own), complex64."""
    codec = _port(mode, interval=8, warm_start=True, Delta_rel=1e-5)
    enc = codec.open_stream()
    for x in _frames(2, seed=6):
        enc.add_frame(x)
    warm = enc._warm
    assert isinstance(warm, torch.Tensor) and warm.dtype == torch.complex64
    assert warm.device == codec.engine.device
    # one half-spectrum row per field row, or per pencil (block = last axis)
    assert warm.shape == (SHAPE[0], SHAPE[1] // 2 + 1)


def test_engine_takes_a_warm_spectrum_as_array_or_tensor():
    """A warm spectrum seeds the loop the same as a host array (complex128,
    the polish's) or as a complex64 tensor; a cold plan ignores it."""
    x = _frames(1, seed=7)[0]
    eng = CorrectionEngine(device="cpu", fft_impl="pallas")
    plan = eng.plan_field(x, FFCzConfig(**_cfg(Delta_rel=1e-5, fft_impl="pallas", warm_start=True)))
    eps0 = (0.3 * plan.E * np.random.default_rng(7).standard_normal(x.shape)).astype(np.float32)
    first = eng.execute_field(eps0, plan)
    host = eng.execute_field(eps0, plan, warm_freq=first.freq)
    dev = eng.execute_field(eps0, plan, warm_freq=torch.from_numpy(first.freq.astype(np.complex64)))
    assert np.array_equal(host.freq, dev.freq) and host.iterations == dev.iterations
    cold_plan = dataclasses.replace(plan, warm_start=False)
    cold = eng.execute_field(eps0, cold_plan)
    ignored = eng.execute_field(eps0, cold_plan, warm_freq=first.freq)
    assert np.array_equal(cold.freq, ignored.freq) and cold.iterations == ignored.iterations


def test_cold_keyframes_are_the_codecs_blobs():
    frames = _frames(3, seed=9)
    cfg = FFCzConfig(**_cfg())
    data = _encode(_port("field", interval=1), frames)[1]
    s = TemporalStream.from_bytes(data)
    assert s.frame_payload(0) == FFCz(get_compressor("szlike"), cfg, device="cpu").compress(frames[0]).to_bytes()
    # later keyframes pin frame 0's bounds absolutely
    pinned = dataclasses.replace(cfg, E_rel=None, E_abs=s.E, Delta_rel=None, Delta_abs=s.Delta)
    for t in (1, 2):
        assert s.frame_payload(t) == FFCz(get_compressor("szlike"), pinned, device="cpu").compress(frames[t]).to_bytes()


@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_export_restore_resumes_to_the_same_bytes(mode):
    frames = _frames(7, seed=8)
    codec = _port(mode, interval=3)
    want = _encode(codec, frames)[1]
    enc = codec.open_stream()
    for x in frames[:5]:
        enc.add_frame(x)
    state = enc.export_state()
    enc2 = codec.restore_stream(state["frames"], shape=state["shape"], block=state["block"],
                                E0=state["E0"], Delta0=state["Delta0"])
    for x in frames[5:]:
        enc2.add_frame(x)
    assert enc2.finish() == want
    with pytest.raises(BlobCorruptError, match="different stream config"):
        _port(mode, interval=2).restore_stream(state["frames"], shape=state["shape"],
                                               E0=state["E0"], Delta0=state["Delta0"])


def test_encoder_terminal_state_and_validation():
    codec = _port()
    with pytest.raises(ValueError, match="empty"):
        codec.compress_stream([])
    enc = codec.open_stream()
    enc.add_frame(_frames(1)[0])
    with pytest.raises(ValueError, match="shape"):
        enc.add_frame(np.zeros((4, 4), np.float32))
    enc.finish()
    with pytest.raises(tt.StreamStateError):
        enc.add_frame(_frames(1)[0])
    with pytest.raises(tt.StreamStateError, match="twice"):
        enc.finish()
    with pytest.raises(ValueError, match="pspec"):
        TemporalCodec(get_compressor("szlike"), FFCzConfig(E_rel=1e-3, Delta_rel=None, pspec_rel=1e-3),
                      device="cpu")
    with pytest.raises(ValueError, match="either an engine or a device"):
        TemporalCodec(get_compressor("szlike"), engine=CorrectionEngine(device="cpu"), device="cpu")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert TemporalCodec(get_compressor("szlike")).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TemporalCodec(get_compressor("szlike"))


# -- across packages -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_containers_cross_both_ways(mode):
    frames = _frames(7, seed=10, drift=0.2)
    port, ref = _port(mode, interval=3, fft_impl="pallas"), _ref(mode, interval=3, fft_impl="pallas")
    port_data, ref_data = _encode(port, frames)[1], _encode(ref, frames)[1]
    for data in (port_data, ref_data):
        got, want = port.decompress_stream(data), ref.decompress_stream(data)
        _assert_within_header(data, frames, got)
        # decoding is the same host float64 code in both packages: bitwise
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert np.array_equal(port.decode_frame(data, 5), want[5])


@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_reference_encoder_state_continues_in_the_port(mode):
    frames = _frames(7, seed=11, drift=0.2)
    ref_enc = _ref(mode, interval=3).open_stream()
    for x in frames[:4]:
        ref_enc.add_frame(x)
    state = ref_enc.export_state()
    port = _port(mode, interval=3)
    enc = port.restore_stream(state["frames"], shape=state["shape"], block=state["block"],
                              E0=state["E0"], Delta0=state["Delta0"])
    for x in frames[4:]:
        enc.add_frame(x)
    data = enc.finish()
    _assert_within_header(data, frames, port.decompress_stream(data))
    _assert_within_header(data, frames, _ref(mode).decompress_stream(data))


SAME_BYTES = [(mode, impl, shape) for mode in ("field", "pencils") for impl in ("xla", "pallas")
              for shape in ((16, 16), SHAPE)]


def _abs_bounds(x, Delta_rel):
    d = float(np.abs(np.fft.rfftn(x)).max() * Delta_rel)
    return dict(E_rel=None, E_abs=float(np.ptp(x)) * 1e-3, Delta_rel=None, Delta_abs=d)


@pytest.mark.parametrize("mode,impl,shape", SAME_BYTES, ids=str)
def test_cold_streams_are_byte_identical_where_the_loop_does_not_edit(mode, impl, shape):
    frames = _frames(7, shape=shape, seed=3)
    kw = dict(_abs_bounds(frames[0], 1e-3), fft_impl=impl)
    enc, got = _encode(_port(mode, interval=3, **kw), frames)
    ref_enc, want = _encode(_ref(mode, interval=3, **kw), frames)
    assert [st["iterations"] for st in enc.frame_stats] == [1] * 7
    assert [st["iterations"] for st in ref_enc.frame_stats] == [1] * 7
    assert got == want


@pytest.mark.parametrize("mode", ["field", "pencils"])
def test_acting_loop_agrees_on_iterations(mode):
    """A tight absolute Delta makes the loop edit (2-5 iterations): the bytes
    are bound-class, the iteration counts the reference's."""
    frames = _frames(7, shape=SHAPE, seed=3)
    kw = dict(_abs_bounds(frames[0], 1e-5), fft_impl="pallas")
    enc, got = _encode(_port(mode, interval=3, **kw), frames)
    ref_enc, want = _encode(_ref(mode, interval=3, **kw), frames)
    iters = [st["iterations"] for st in enc.frame_stats]
    assert iters == [st["iterations"] for st in ref_enc.frame_stats] and max(iters) >= 2
    _assert_within_header(got, frames, _ref(mode).decompress_stream(got))
    _assert_within_header(want, frames, _port(mode).decompress_stream(want))


def test_eeg_example_runs_on_the_cpu():
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=f"{root / 'src'}{os.pathsep}{root}")
    out = subprocess.run([sys.executable, "examples/stream_eeg_torch.py", "--quick", "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "bounds held on every frame" in out.stdout and "bitwise == sequential decode" in out.stdout
