"""The port's checkpoint codec and manager against the reference's.

What is held, and how:
  * ``tree.flatten``: the leaf order and the rebuilt structure of
    ``jax.tree.flatten`` (dict keys sorted, sequences in order, ``None`` no
    leaf), exactly.
  * Tag ``R`` (raw): the bytes of the reference's encoder, exactly, bfloat16
    included (the reference's ``np.save`` writes it as ``'<V2'``).
  * Tags ``F`` and ``B``: the host stages are the reference's (bound
    resolution and the szlike base in float64/numpy), so a ``B`` leaf's
    header (dtype, E, Delta, block, shape) and base stream are byte-identical
    and only the edit streams (device FFTs) differ.  Every leaf decodes in
    both packages within the bounds it stores: |x' - x| <= E everywhere and,
    for ``B``, every full pencil's rfft within Delta * (1 + 1e-9) (the
    reference test's bar); for ``F``, the whole field's rfftn within Delta.
  * ``CheckpointManager``: a directory written by either package restores in
    the other (same manifest, raw leaves bitwise, compressed leaves within
    their stored bounds), and the reference's 13 ``tests/test_checkpoint.py``
    checks replayed on the port.
"""

import io
import json
import os
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.codec import CheckpointCodec as RCodec
from repro.checkpoint.manager import CheckpointManager as RManager
from repro.core.ffcz import FFCzBlob as RFFCzBlob
from repro_torch import tree
from repro_torch.checkpoint import CheckpointCodec, CheckpointManager
from repro_torch.core.engine import CorrectionEngine


def _codec(**kw):
    return CheckpointCodec(engine=CorrectionEngine(device="cpu"), **kw)


@pytest.fixture
def rng():
    """A fresh generator per test (the conftest's lives for the whole test run)."""
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# leaf order


TREES = [
    {"b": 1, "a": {"d": 2, "c": [3, 4, (5, 6)]}, "e": None},
    ({"z": 1, "m": {"y": 2, "x": 3}}, {"m": 4, "v": 5, "step": 6}),
    [1, None, {"k": (2,)}, [[3]]],
    {"layers": {"attn": {"wqkv": 1, "bqkv": 2, "wo": 3}, "ln_attn": {"scale": 4}}, "embed": 5},
]


@pytest.mark.parametrize("t", TREES, ids=range(len(TREES)))
def test_flatten_orders_leaves_as_jax(t):
    leaves, treedef = tree.flatten(t)
    assert leaves == jax.tree.leaves(t)
    assert tree.unflatten(treedef, leaves) == t
    assert tree.map_leaves(lambda x: x * 10, t) == jax.tree.map(lambda x: x * 10, t)
    assert tree.treedef_str(treedef).startswith("PyTreeDef(")


def test_unflatten_rejects_extra_leaves():
    _, treedef = tree.flatten({"a": 1})
    with pytest.raises(ValueError):
        tree.unflatten(treedef, [1, 2])


# ---------------------------------------------------------------------------
# codec: raw bytes


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


RAW_ARRAYS = {
    "int64": np.arange(10),
    "tiny_float": np.float32([1.5]),
    "int_matrix": np.zeros((3, 3), np.int64),
    "float64_scalar": np.float64(2.25),
    "int32_scalar": np.int32(7),
    "small_float32": np.linspace(0, 1, 100, dtype=np.float32).reshape(10, 10),
    "constant": np.full(5000, 3.0, np.float32),
    "bool": np.array([True, False, True]),
}


def _port_array(a):
    """The host array the port's manager hands its codec for this leaf."""
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16).view(np.dtype("V2"))
    return a


@pytest.mark.parametrize("name", list(RAW_ARRAYS) + ["bfloat16"])
def test_raw_bytes_are_the_references(name):
    a = _bf16(np.linspace(-2, 2, 24).reshape(4, 6)) if name == "bfloat16" else np.asarray(RAW_ARRAYS[name])
    want = RCodec(enabled=True).encode(a)
    ours = _codec(enabled=True)
    got = ours.encode(_port_array(a))
    assert want[:1] == b"R" and got == want
    assert ours.encode_batch([_port_array(a)]) == RCodec(enabled=True).encode_batch([a])
    back = ours.decode(got)
    assert back.tobytes() == a.tobytes() and back.shape == a.shape


def test_a_disabled_codec_needs_no_device():
    codec = CheckpointCodec(enabled=False)  # no engine: nothing to correct
    a = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    assert codec.encode_batch([a])[0][:1] == b"R"
    assert np.array_equal(codec.decode(codec.encode(a)), a)


# ---------------------------------------------------------------------------
# codec: F and B across the packages


def _field_margins(x, dec, blob):
    eps = dec.astype(np.float64) - x.astype(np.float32).astype(np.float64)
    d = np.fft.rfftn(eps)
    return (float(blob.E - np.abs(eps).max()),
            float(blob.Delta_scalar - np.maximum(np.abs(d.real), np.abs(d.imag)).max()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tag_f_cross_decodes(writer, rng):
    w = rng.standard_normal((128, 64)).astype(np.float32)
    enc = (_codec if writer == "port" else RCodec)(enabled=True, E_rel=1e-4, Delta_rel=1e-4)
    data = enc.encode(w)
    assert data[:1] == b"F"
    blob = RFFCzBlob.from_bytes(data[2:])
    for dec in (_codec(enabled=True, E_rel=1e-4, Delta_rel=1e-4), RCodec(enabled=True)):
        back = dec.decode(data)
        assert back.dtype == np.float32 and back.shape == w.shape
        spatial, frequency = _field_margins(w, back, blob)
        assert spatial >= 0 and frequency >= 0


def _parse_b(data):
    body = data[1:]
    dt_code, E, Delta, block, ndim = struct.unpack_from("<BddIB", body, 0)
    off = struct.calcsize("<BddIB")
    shape = struct.unpack_from(f"<{ndim}Q", body, off)
    off += 8 * ndim
    nb, ns, nf = struct.unpack_from("<QQQ", body, off)
    off += struct.calcsize("<QQQ")
    return {"dtype": dt_code, "E": E, "Delta": Delta, "block": block, "shape": shape,
            "base": body[off: off + nb]}


def _b_leaf_within(a, back, hdr):
    a32 = a.astype(np.float32).astype(np.float64)
    diff = back.astype(np.float64) - a32
    assert np.abs(diff).max() <= hdr["E"]
    block = hdr["block"]
    flat = diff.reshape(-1)
    full = flat[: flat.size // block * block].reshape(-1, block)
    if full.size:
        d = np.fft.rfft(full, axis=-1)
        assert max(np.abs(d.real).max(), np.abs(d.imag).max()) <= hdr["Delta"] * (1 + 1e-9)


def _mixed(rng):
    return [
        rng.standard_normal((128, 64)).astype(np.float32),
        np.cumsum(rng.standard_normal((4, 8, 16, 32)), axis=-1).astype(np.float32),  # rank 4
        rng.standard_normal((5000,)).astype(np.float64),  # not a block multiple, float64
        np.arange(10),
        np.float32([1.5]),
    ]


def test_tag_b_host_stages_are_the_references(rng):
    arrays = _mixed(rng)
    ours = _codec(enabled=True, E_rel=1e-4, Delta_rel=1e-4, block=1024).encode_batch(arrays)
    theirs = RCodec(enabled=True, E_rel=1e-4, Delta_rel=1e-4, block=1024).encode_batch(arrays)
    for a, o, t in zip(arrays, ours, theirs):
        assert o[:1] == t[:1]
        if o[:1] == b"B":
            assert _parse_b(o) == _parse_b(t)  # dtype, E, Delta, block, shape, base stream
        else:
            assert o == t


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tag_b_cross_decodes(writer, rng):
    arrays = _mixed(rng)
    enc = (_codec if writer == "port" else RCodec)(enabled=True, E_rel=1e-4, Delta_rel=1e-4, block=1024)
    blobs = enc.encode_batch(arrays)
    assert [b[:1] for b in blobs] == [b"B", b"B", b"B", b"R", b"R"]
    for dec in (_codec(enabled=True, block=1024), RCodec(enabled=True, block=1024)):
        for a, b in zip(arrays, blobs):
            back = dec.decode(b)
            assert back.shape == a.shape and back.dtype == a.dtype
            if b[:1] == b"B":
                _b_leaf_within(a, back, _parse_b(b))
            else:
                np.testing.assert_array_equal(back, a)


# ---------------------------------------------------------------------------
# manager across the packages


def _state_np(rng):
    return {
        "w": rng.standard_normal((128, 128)).astype(np.float32),
        "conv": rng.standard_normal((4, 4, 32, 32)).astype(np.float32),
        "nested": {"b": np.arange(10, dtype=np.int32), "s": np.float32(3.5)},
        "step": np.int32(7),
    }


def _as_torch(st):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), st)


def _check_restored(st, got, step_dir, compressed):
    leaves_want = jax.tree.leaves(st)
    for i, (a, b) in enumerate(zip(leaves_want, jax.tree.leaves(got))):
        a, b = np.asarray(a), np.asarray(b)
        assert b.shape == a.shape and b.dtype == a.dtype
        data = (step_dir / f"{i}.bin").read_bytes()
        if data[:1] == b"B":
            assert compressed
            _b_leaf_within(a, b, _parse_b(data))
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "compressed"])
def test_reference_directory_restores_in_the_port(tmp_path, rng, compressed):
    st = _state_np(rng)
    RManager(str(tmp_path), codec=RCodec(enabled=compressed, E_rel=1e-5, Delta_rel=1e-5)).save(3, st)
    mgr = CheckpointManager(str(tmp_path), codec=_codec(enabled=compressed))
    step, got = mgr.restore_latest(_as_torch(st))
    assert step == 3 and isinstance(got["w"], torch.Tensor)
    _check_restored(st, jax.tree.map(lambda t: t.numpy(), got), tmp_path / "step_000000000003", compressed)


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "compressed"])
def test_port_directory_restores_in_the_reference(tmp_path, rng, compressed):
    st = _state_np(rng)
    CheckpointManager(str(tmp_path / "p"), codec=_codec(enabled=compressed, E_rel=1e-5, Delta_rel=1e-5)).save(
        3, _as_torch(st))
    RManager(str(tmp_path / "r"), codec=RCodec(enabled=compressed, E_rel=1e-5, Delta_rel=1e-5)).save(3, st)
    step, got = RManager(str(tmp_path / "p"), codec=RCodec(enabled=compressed)).restore_latest(
        jax.eval_shape(lambda: jax.tree.map(jnp.asarray, st)))
    assert step == 3
    p_dir, r_dir = tmp_path / "p" / "step_000000000003", tmp_path / "r" / "step_000000000003"
    _check_restored(st, got, p_dir, compressed)
    mp, mr = (json.loads((d / "manifest.json").read_text()) for d in (p_dir, r_dir))
    assert {k: mp[k] for k in ("step", "n_leaves", "dtypes", "shapes")} == \
        {k: mr[k] for k in ("step", "n_leaves", "dtypes", "shapes")}
    for i in range(mp["n_leaves"]):
        a, b = (p_dir / f"{i}.bin").read_bytes(), (r_dir / f"{i}.bin").read_bytes()
        assert a[:1] == b[:1] and (a == b or a[:1] == b"B")
    assert sorted(os.listdir(p_dir)) == sorted(os.listdir(r_dir))


def test_bfloat16_leaves_round_trip_bitwise(tmp_path):
    w = torch.randn(6, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w, "f": torch.ones(3)})
    got = mgr.restore(1, {"w": torch.empty(6, 5, dtype=torch.bfloat16, device="meta"),
                          "f": torch.empty(3, device="meta")})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    manifest = json.loads((tmp_path / "step_000000000001" / "manifest.json").read_text())
    assert manifest["dtypes"] == ["float32", "bfloat16"]  # leaf order: "f" < "w"
    # the bytes the reference writes for the same bfloat16 array
    ref = np.asarray(jnp.asarray(w.float().numpy(), dtype=jnp.bfloat16))
    buf = io.BytesIO()
    np.save(buf, ref, allow_pickle=False)
    assert (tmp_path / "step_000000000001" / "1.bin").read_bytes() == b"R" + buf.getvalue()


def test_a_failed_background_save_raises_at_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    class Broken(CheckpointCodec):
        def encode_batch(self, arrays):
            raise OSError("disk full")

    mgr.codec = Broken(enabled=False)
    mgr.save(1, {"w": torch.zeros(3)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.wait()  # the error is raised once


# ---------------------------------------------------------------------------
# the reference's tests/test_checkpoint.py, replayed on the port


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((64, 32), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "s": torch.tensor(3.5)},
    }


class TestManager:
    def test_save_restore_exact(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        st = _state()
        mgr.save(3, st)
        got = mgr.restore(3, tree.map_leaves(lambda t: torch.empty_like(t, device="meta"), st))
        for a, b in zip(tree.leaves(st), tree.leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_latest_and_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _state(s))
        assert mgr.latest_step() == 4
        assert mgr.committed_steps() == [3, 4]  # older GC'd

    def test_uncommitted_dir_ignored(self, tmp_path):
        """A crash mid-save (no _COMMITTED) must be invisible to restore."""
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _state())
        fake = tmp_path / "step_000000000009"
        fake.mkdir()
        (fake / "manifest.json").write_text("{}")
        assert mgr.latest_step() == 1

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(7, _state(), blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 7

    def test_restore_empty_is_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore_latest(_state()) is None

    def test_shape_mismatch_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.zeros((4, 4))})
        with pytest.raises(ValueError):
            mgr.restore(1, {"w": torch.zeros((5, 4))})


class TestCodec:
    def test_ffcz_codec_bounds(self, rng):
        codec = _codec(enabled=True, E_rel=1e-4, Delta_rel=1e-4)
        w = rng.standard_normal((128, 64)).astype(np.float32)
        back = codec.decode(codec.encode(w))
        assert np.abs(back - w).max() <= 1e-4 * np.ptp(w) * (1 + 1e-5)

    def test_ffcz_codec_compresses_smooth(self):
        from repro_torch.data.fields import make_field

        codec = _codec(enabled=True, E_rel=1e-3, Delta_rel=1e-3)
        w = make_field("s3d-like").reshape(64, -1)
        assert len(codec.encode(w)) < w.nbytes / 2

    def test_small_and_int_passthrough(self):
        codec = _codec(enabled=True)
        for arr in (np.arange(10), np.float32([1.5]), np.zeros((3, 3), np.int64)):
            back = codec.decode(codec.encode(arr))
            np.testing.assert_array_equal(back, arr)

    def test_manager_with_codec_roundtrip(self, tmp_path, rng):
        codec = _codec(enabled=True, E_rel=1e-5, Delta_rel=1e-5)
        mgr = CheckpointManager(str(tmp_path), codec=codec)
        st = {"w": torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))}
        mgr.save(1, st)
        got = mgr.restore(1, st)
        err = float((got["w"] - st["w"]).abs().max())
        assert err <= 1e-5 * float(st["w"].max() - st["w"].min()) * (1 + 1e-5)


class TestBatchCodec:
    """Blockwise-batched encode path (tag B): one device program per save."""

    def test_encode_batch_mixed_leaves(self, rng):
        codec = _codec(enabled=True, E_rel=1e-4, Delta_rel=1e-4, block=1024)
        arrays = _mixed(rng)
        blobs = codec.encode_batch(arrays)
        for a, b in zip(arrays, blobs):
            back = codec.decode(b)
            assert back.shape == a.shape and back.dtype == a.dtype
            if a.dtype in (np.float32, np.float64) and a.size >= 4096:
                E = 1e-4 * np.ptp(a.astype(np.float32))
                diff = back.astype(np.float64) - a.astype(np.float32).astype(np.float64)
                assert np.abs(diff).max() <= E * (1 + 1e-9)
            else:
                np.testing.assert_array_equal(back, a)

    def test_frequency_bound_per_full_pencil(self, rng):
        block = 512
        codec = _codec(enabled=True, E_rel=1e-4, Delta_rel=1e-4, block=block)
        a = np.cumsum(rng.standard_normal((16, 512)), axis=-1).astype(np.float32)
        [blob] = codec.encode_batch([a])
        back = codec.decode(blob)
        diff = (back.astype(np.float64) - a.astype(np.float64)).reshape(-1, block)
        tiles = a.reshape(-1, block)
        u32 = float(np.finfo(np.float32).eps)
        slack = 4 * u32 * np.sqrt((tiles.astype(np.float64) ** 2).sum(axis=-1).max())
        Delta = max(1e-4 * np.abs(np.fft.rfft(tiles, axis=-1)).max(), 4 * slack)
        d = np.fft.rfft(diff, axis=-1)
        assert max(np.abs(d.real).max(), np.abs(d.imag).max()) <= Delta * (1 + 1e-9)

    def test_manager_uses_batched_path(self, tmp_path, rng):
        codec = _codec(enabled=True, E_rel=1e-5, Delta_rel=1e-5)
        mgr = CheckpointManager(str(tmp_path), codec=codec)
        st = {
            "w": torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)),
            "conv": torch.from_numpy(rng.standard_normal((4, 4, 32, 32)).astype(np.float32)),
            "step": torch.tensor(7, dtype=torch.int32),
        }
        mgr.save(1, st)
        # eligible leaves are stored with the blockwise tag
        tags = set()
        step_dir = tmp_path / "step_000000000001"
        for i in range(3):
            tags.add((step_dir / f"{i}.bin").read_bytes()[:1])
        assert b"B" in tags and b"R" in tags
        got = mgr.restore(1, st)
        for k in ("w", "conv"):
            err = float((got[k] - st[k]).abs().max())
            assert err <= 1e-5 * float(st[k].max() - st[k].min()) * (1 + 1e-5)
        assert int(got["step"]) == 7


# ---------------------------------------------------------------------------
# the threaded host stages are the serial ones


def _plain_polish(eps, spat, freq, E, Delta, max_iters=30):
    """The float64 polish over the rows of ``eps``, one loop over all rows
    (the reference's ``polish_pocs_float64`` with ``axes=(1,)``)."""
    s = [eps.shape[1]]
    for _ in range(max_iters):
        delta = np.fft.rfftn(eps, axes=(1,))
        clipped = np.clip(delta.real, -Delta, Delta) + 1j * np.clip(delta.imag, -Delta, Delta)
        if np.array_equal(clipped, delta):
            break
        freq = freq + (clipped - delta)
        eps_f = np.fft.irfftn(clipped, s=s, axes=(1,))
        eps_s = np.clip(eps_f, -E, E)
        spat = spat + (eps_s - eps_f)
        eps = eps_s
    return eps, spat, freq


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("delta", [0.02, 10.0], ids=["thirty_iterations", "converged_at_once"])
def test_threaded_pencil_polish_is_bitwise_the_serial_one(delta, threads):
    from repro_torch.core import engine

    rng = np.random.default_rng(0)
    eps = rng.uniform(-1, 1, (1100, 512)) * 1e-3
    spat = rng.uniform(-1, 1, eps.shape) * 1e-5
    freq = np.fft.rfft(rng.uniform(-1, 1, eps.shape) * 1e-5, axis=1)
    want = _plain_polish(eps, spat, freq, 1e-3, delta)
    got = engine.polish_pocs_float64(eps, spat, freq, 1e-3, delta, axes=(1,), threads=threads)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_threaded_pencil_polish_refuses_what_is_not_independent_pencils():
    from repro_torch.core import engine

    eps = np.zeros((512, 8))
    with pytest.raises(ValueError, match="independent pencils"):
        engine.polish_pocs_float64(eps, eps, np.fft.rfftn(eps), 1.0, 1.0, threads=2)
    with pytest.raises(ValueError, match="independent pencils"):
        engine.polish_pocs_float64(eps, eps, np.fft.rfft(eps), np.ones((512, 1)), 1.0, axes=(1,), threads=2)


def test_threaded_encode_batch_is_bitwise_the_serial_one(monkeypatch, rng):
    from repro_torch import host

    arrays = _mixed(rng) + [rng.standard_normal(300 * 1024).astype(np.float32)]
    monkeypatch.setattr(host, "THREADS", 4)
    threaded = _codec(enabled=True, block=1024).encode_batch(arrays)
    monkeypatch.setattr(host, "THREADS", 1)
    assert _codec(enabled=True, block=1024).encode_batch(arrays) == threaded
