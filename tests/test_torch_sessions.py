"""The port's durable live sessions, held against the reference's on the CPU.

The ``FFJR`` journal is host bytes: the config record and the frame records
are byte-identical to the reference's, and a journal written by either
package recovers in the other's ``StreamSessionManager`` (``next_seq`` right,
a duplicate retry of a recovered seq answered from the recovered receipts).
Finalize after recovery is bitwise the same package's ``compress_stream``
over all the frames.  Leases (frozen clock), admission, the write-ahead
discipline under injected journal faults and the spill of idle history
follow ``tests/test_sessions.py``.
"""

import numpy as np
import pytest

import repro.serving.sessions as rs
from repro.compressors import get_compressor as r_get
from repro.core.ffcz import FFCzConfig as RefConfig
from repro.core.temporal import TemporalCodec as RefCodec
from repro.core.temporal import TemporalConfig as RefStream
from repro_torch.compressors import get_compressor
from repro_torch.core.engine import CorrectionEngine
from repro_torch.core.errors import (
    BlobCorruptError,
    ResourceExhausted,
    SessionError,
    SessionNotFound,
    SessionSequenceError,
)
from repro_torch.core.ffcz import FFCzConfig
from repro_torch.core.temporal import TemporalCodec, TemporalConfig, TemporalStream
from repro_torch.runtime.faults import FaultConfig, FaultInjector
from repro_torch.serving import sessions as ts
from repro_torch.serving.sessions import FileJournal, MemoryJournal, StreamSessionManager, parse_journal


def _frames(n, shape=(16, 16), seed=0, drift=0.05):
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(shape) * 0.5 + 4.0).cumsum(axis=0)
    mode = np.cos(np.linspace(0, 2 * np.pi, base.size)).reshape(shape)
    return [np.ascontiguousarray(base + drift * t * mode + 0.01 * rng.standard_normal(shape), dtype=np.float32)
            for t in range(n)]


FRAMES = _frames(6)
# warm_start stays False: recovery is bitwise because cold re-encodes are deterministic
CFG_KW = dict(E_rel=1e-3, Delta_rel=1e-3, max_iters=200)
STREAM_KW = dict(mode="field", predictor="linear", keyframe_interval=2)
CFG, STREAM = FFCzConfig(**CFG_KW), TemporalConfig(**STREAM_KW)
REF_CFG, REF_STREAM = RefConfig(**CFG_KW), RefStream(**STREAM_KW)


def _manager(**kw):
    return StreamSessionManager(get_compressor("szlike"), engine=CorrectionEngine(device="cpu"), **kw)


def _ref_manager(**kw):
    return rs.StreamSessionManager(r_get("szlike"), **kw)


def _codec():
    return TemporalCodec(get_compressor("szlike"), CFG, stream=STREAM, device="cpu")


@pytest.fixture(scope="module")
def port_container():
    return _codec().compress_stream(FRAMES)


def _partial(manager, cfg, stream, n=4):
    """Journal bytes of a session that appended frames 0..n-1 and crashed."""
    jrn = (MemoryJournal if isinstance(manager, StreamSessionManager) else rs.MemoryJournal)()
    sid = manager.open_session(cfg, stream, session_id="s", journal=jrn)
    receipts = [manager.append_frame(sid, t, FRAMES[t]) for t in range(n)]
    return jrn.read(), receipts


def _assert_bound(container, frames):
    s = TemporalStream.from_bytes(container)
    dec = _codec().decompress_stream(container)
    assert len(dec) == len(frames)
    for x, d in zip(frames, dec):
        assert np.max(np.abs(d.astype(np.float64) - x.astype(np.float64))) <= s.E


# -- the journal's bytes -------------------------------------------------------


def test_config_record_is_the_references():
    got = ts._record(ts._J_OPEN, ts._config_json(CFG, STREAM, "s"))
    want = rs._record(rs._J_OPEN, rs._config_json(REF_CFG, REF_STREAM, "s"))
    assert got == want
    assert ts._frame_record(3, True, b"\x07" * 32, 0.5, 2.25, (16, 17), 0, b"pay") == \
        rs._frame_record(3, True, b"\x07" * 32, 0.5, 2.25, (16, 17), 0, b"pay")
    with pytest.raises(ValueError, match="ROI"):
        ts._config_json(FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, E_roi=np.ones((4, 4), bool)), STREAM, "s")


def test_journals_are_byte_identical_where_the_streams_are():
    """A session's journal is its OPEN record plus one FRAME record per
    payload: the port's equals the reference's when the payloads do (these
    frames' loops do not edit; tests/test_torch_temporal.py, SAME_BYTES)."""
    got, got_receipts = _partial(_manager(), CFG, STREAM)
    want, want_receipts = _partial(_ref_manager(), REF_CFG, REF_STREAM)
    assert got == want
    assert [r.digest for r in got_receipts] == [r.digest for r in want_receipts]
    g, w = parse_journal(got), rs.parse_journal(want)
    assert (g.open_info, g.closed, g.damaged, g.n_records) == (w.open_info, w.closed, w.damaged, w.n_records)
    assert [f.payload for f in g.frames] == [f.payload for f in w.frames]


@pytest.mark.parametrize("keep", [0, 3, 10, 57, 200, -1])
def test_damaged_journal_parses_to_the_references_prefix(keep):
    data, _ = _partial(_manager(), CFG, STREAM)
    bad = data[:keep] if keep >= 0 else data[:-20] + bytes([data[-20] ^ 0x10]) + data[-19:]
    g, w = parse_journal(bad), rs.parse_journal(bad)
    assert (g.n_records, g.damaged, len(g.frames)) == (w.n_records, w.damaged, len(w.frames))


# -- recovery across packages --------------------------------------------------


def test_port_journal_recovers_in_the_reference(port_container):
    data, _ = _partial(_manager(), CFG, STREAM)
    mgr = _ref_manager()
    sid = mgr.recover(data)
    assert mgr.next_seq(sid) == 4 and mgr.counters["resyncs"] == 0
    dup = mgr.append_frame(sid, 1, FRAMES[1])
    assert dup.duplicate and dup.restored
    for t in (4, 5):
        mgr.append_frame(sid, t, FRAMES[t])
    container = mgr.finalize(sid)
    assert container == RefCodec(r_get("szlike"), REF_CFG, stream=REF_STREAM).compress_stream(FRAMES)
    _assert_bound(container, FRAMES)


def test_reference_journal_recovers_in_the_port(port_container):
    data, _ = _partial(_ref_manager(), REF_CFG, REF_STREAM)
    mgr = _manager()
    sid = mgr.recover(data)
    assert mgr.next_seq(sid) == 4
    assert mgr.counters["recoveries"] == 1 and mgr.counters["recovered_frames"] == 4
    dup = mgr.append_frame(sid, 1, FRAMES[1])
    assert dup.duplicate and dup.restored
    for t in (4, 5):
        assert not mgr.append_frame(sid, t, FRAMES[t]).restored
    container = mgr.finalize(sid)
    assert container == port_container  # bitwise the uninterrupted stream's
    _assert_bound(container, FRAMES)


def test_intact_port_journal_restores_bitwise(port_container):
    data, _ = _partial(_manager(), CFG, STREAM)
    mgr = _manager()
    sid = mgr.recover(data)
    for t in range(4, 6):
        mgr.append_frame(sid, t, FRAMES[t])
    assert mgr.finalize(sid) == port_container


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_damaged_tail_resumes_from_the_durable_prefix(damage):
    data, _ = _partial(_manager(), CFG, STREAM)
    bad = data[:-10] if damage == "truncate" else data[:-20] + bytes([data[-20] ^ 0x10]) + data[-19:]
    mgr = _manager()
    sid = mgr.recover(bad)
    assert mgr.next_seq(sid) == 3  # the last frame's record is gone
    for t in range(3, 6):
        mgr.append_frame(sid, t, FRAMES[t])
    _assert_bound(mgr.finalize(sid), FRAMES)


def test_recovery_rejects_closed_and_garbage_journals():
    mgr = _manager()
    jrn = MemoryJournal()
    sid = mgr.open_session(CFG, STREAM, journal=jrn)
    mgr.append_frame(sid, 0, FRAMES[0])
    mgr.finalize(sid)
    with pytest.raises(SessionNotFound, match="closed"):
        _manager().recover(jrn.read())
    with pytest.raises(BlobCorruptError, match="OPEN"):
        _manager().recover(b"\x00garbage")


# -- idempotency, write-ahead discipline ----------------------------------------


def test_idempotent_appends_and_sequence_errors():
    mgr = _manager()
    sid = mgr.open_session(CFG, STREAM)
    r0 = mgr.append_frame(sid, 0, FRAMES[0])
    assert mgr.append_frame(sid, 0, FRAMES[0]) == type(r0)(**{**r0.__dict__, "duplicate": True})
    for seq, frame in ((0, FRAMES[1]), (2, FRAMES[2]), (-1, FRAMES[1])):
        with pytest.raises(SessionSequenceError):
            mgr.append_frame(sid, seq, frame)
    assert mgr.session_stats(sid).sequence_rejects == 3
    with pytest.raises(SessionError, match="no frames"):
        mgr.finalize(mgr.open_session(CFG, STREAM))


def test_journal_fault_leaves_the_frame_pending_then_replays(port_container):
    inj = FaultInjector(FaultConfig(p_session_journal=1.0, max_per_site=1), seed=3)
    mgr = _manager(injector=inj)
    sid = mgr.open_session(CFG, STREAM)
    for t in range(6):
        with pytest.raises(OSError):
            mgr.append_frame(sid, t, FRAMES[t], fire_uid=f"a{t}")
        mgr.append_frame(sid, t, FRAMES[t], fire_uid=f"a{t}")  # re-journals, no re-encode
    assert mgr.session_stats(sid).pending_replays == 6
    with pytest.raises(OSError):  # the CLOSE record's write fails once
        mgr.finalize(sid, fire_uid="fin")
    assert mgr.finalize(sid, fire_uid="fin") == port_container  # no second finish()


# -- leases, admission, spill -----------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_lease_expiry_finalizes_a_partial_container():
    clk = _Clock()
    mgr = _manager(lease_s=10.0, clock=clk)
    sid = mgr.open_session(CFG, STREAM)
    for t, at in enumerate((0.0, 8.0)):
        clk.t = at
        mgr.append_frame(sid, t, FRAMES[t])
    clk.t = 17.0  # 9 s after the last append: still leased
    assert mgr.sweep() == []
    clk.t = 19.0
    assert mgr.sweep() == [sid] and mgr.counters["lease_evictions"] == 1
    with pytest.raises(SessionNotFound):
        mgr.append_frame(sid, 2, FRAMES[2])
    tomb = mgr.closed_info(sid)
    assert tomb["reason"] == "lease_expired" and tomb["n_frames"] == 2
    _assert_bound(tomb["container"], FRAMES[:2])
    empty = mgr.open_session(CFG, STREAM)
    clk.t = 40.0
    assert mgr.sweep() == [empty] and mgr.closed_info(empty)["container"] is None


def test_admission_is_bounded():
    mgr = _manager(max_sessions=2)
    a = mgr.open_session(CFG, STREAM)
    mgr.open_session(CFG, STREAM)
    with pytest.raises(ResourceExhausted) as ei:
        mgr.open_session(CFG, STREAM)
    assert ei.value.stage == "admit"
    data, _ = _partial(_manager(), CFG, STREAM, n=1)
    with pytest.raises(ResourceExhausted):
        mgr.recover(data)
    mgr.append_frame(a, 0, FRAMES[0])
    mgr.finalize(a)
    mgr.open_session(CFG, STREAM)  # the slot is free again


def test_spill_and_resume_is_bitwise_neutral():
    # one 16x16 float32 frame is 1 KiB of history and a session holds two:
    # 3000 bytes spills the idle session when a second one appends
    mgr = _manager(max_history_bytes=3000)
    s1 = mgr.open_session(CFG, STREAM)
    mgr.append_frame(s1, 0, FRAMES[0])
    mgr.append_frame(s1, 1, FRAMES[1])
    s2 = mgr.open_session(CFG, STREAM)
    mgr.append_frame(s2, 0, _frames(1, seed=9)[0])
    assert mgr.counters["spills"] == 1 and mgr.session_stats(s1).state == "spilled"
    assert mgr.append_frame(s1, 2, FRAMES[2]).seq == 2
    assert mgr.session_stats(s1).restores == 1
    assert mgr.finalize(s1) == _codec().compress_stream(FRAMES[:3])


def test_file_journal_is_durable_and_recovers(tmp_path, port_container):
    path = tmp_path / "s.wal"
    mgr = _manager()
    sid = mgr.open_session(CFG, STREAM, session_id="s", journal=FileJournal(str(path)))
    for t in range(4):
        mgr.append_frame(sid, t, FRAMES[t])
    assert mgr.flush(sid) == path.stat().st_size > 0
    data = path.read_bytes()
    assert data == _partial(_manager(), CFG, STREAM)[0]
    fresh = _manager()
    sid2 = fresh.recover(data, journal_out=FileJournal(str(tmp_path / "again.wal")))
    for t in (4, 5):
        fresh.append_frame(sid2, t, FRAMES[t])
    assert fresh.finalize(sid2) == port_container
