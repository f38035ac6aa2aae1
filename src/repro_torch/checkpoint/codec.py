"""FFCz-compressed array codec for checkpoints.

Float arrays are compressed with a base compressor + FFCz dual-domain
correction: the spatial bound controls pointwise weight error (restart
quality), the frequency bound preserves each tensor's spectrum.  Non-float
and tiny arrays pass through raw.  Arrays are host numpy arrays; the
correction runs on the engine's device.

The wire envelope is the reference's byte for byte, so a leaf written by
either package decodes in the other:

``encode``        tag ``F``: whole-array FFCz through
                  :class:`repro_torch.core.ffcz.FFCz` (the frequency bound
                  applies to the array's global spectrum).
``encode_batch``  tag ``B``: blockwise FFCz for a whole checkpoint at once.
                  Per leaf, ``engine.plan_pencils`` resolves the per-pencil
                  bounds, then ALL leaves' base-compression errors are
                  corrected by one batched ``engine.correct`` call, and
                  ``engine.encode_pencils`` polishes + serializes each
                  leaf's rfft half-spectrum edit streams.  The per-leaf
                  host stages run in threads; the bytes are the serial
                  order's.
raw               tag ``R``: ``np.save`` bytes.  A bfloat16 leaf (2-byte
                  void on the host, numpy has no bfloat16) is written with
                  the ``'<V2'`` descr the reference's ``np.save`` gives it.

The engine is built on first use when none is given (``default_engine()``,
which needs a card), so a codec that only stores raw leaves or decodes
``B`` leaves needs no device.  Pass ``engine=CorrectionEngine(device="cpu")``
on the CPU, ``CorrectionEngine(fft_impl="pallas")`` for the fused kernels.
"""

from __future__ import annotations

import io
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import host
from repro_torch.compressors import get_compressor
from repro_torch.core.edits import EncodedEdits, decode_edits
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig

_RAW = b"R"
_FFZ = b"F"
_FFB = b"B"  # blockwise-batched FFCz (rfft half-spectrum edit streams)

_DTYPE_CODES = {"float32": 0, "float64": 1}


class CheckpointCodec:
    def __init__(
        self,
        enabled: bool = True,
        E_rel: float = 1e-4,
        Delta_rel: float = 1e-4,
        base: str = "szlike",
        min_size: int = 4096,
        max_iters: int = 50,
        block: int = 4096,
        engine: Optional[CorrectionEngine] = None,
    ):
        self.enabled = enabled
        self.min_size = min_size
        self.E_rel = E_rel
        self.Delta_rel = Delta_rel
        self.max_iters = max_iters
        self.block = block
        self.base = get_compressor(base)
        self._engine = engine
        self._ffcz = None

    @property
    def engine(self) -> CorrectionEngine:
        if self._engine is None:
            self._engine = default_engine()
        return self._engine

    @property
    def ffcz(self) -> FFCz:
        if self._ffcz is None:
            self._ffcz = FFCz(
                self.base,
                FFCzConfig(E_rel=self.E_rel, Delta_rel=self.Delta_rel, max_iters=self.max_iters,
                           codec="zlib", verify=False),
                engine=self.engine,
            )
        return self._ffcz

    def _eligible(self, arr: np.ndarray) -> bool:
        return (
            self.enabled
            and arr.dtype in (np.float32, np.float64)
            and arr.size >= self.min_size
            and np.ptp(arr) > 0
        )

    @staticmethod
    def _raw(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 and arr.dtype.fields is None:
            # bfloat16 held as 2-byte void: the reference's np.save writes '<V2'
            header = np.lib.format.header_data_from_array_1_0(arr)
            header["descr"] = "<V2"
            np.lib.format.write_array_header_1_0(buf, header)
            buf.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(buf, arr, allow_pickle=False)
        return _RAW + buf.getvalue()

    # -- whole-array path (paper pipeline) ---------------------------------

    def encode(self, arr: np.ndarray) -> bytes:
        arr = np.asarray(arr)
        if not self._eligible(arr):
            return self._raw(arr)
        blob = self.ffcz.compress(arr.astype(np.float32))
        payload = blob.to_bytes()
        header = struct.pack("<B", _DTYPE_CODES[str(arr.dtype)])
        return _FFZ + header + payload

    # -- batched blockwise path --------------------------------------------

    def encode_batch(self, arrays: Sequence[np.ndarray]) -> List[bytes]:
        """Encode a whole checkpoint's leaves with ONE batched correction.

        Semantics differ from :meth:`encode` only in the frequency bound's
        scope: Delta applies to each ``block``-length pencil's local rfft
        spectrum (Delta = Delta_rel * max |RFFT(pencil of x)|, per array)
        instead of the array's global spectrum.  The spatial bound E holds
        at every point; the frequency bound holds per *full* pencil (an
        array whose size is not a multiple of ``block`` has its tail pencil
        corrected on a zero-padded extension that decode discards).
        """
        arrays = [np.asarray(a) for a in arrays]
        idx = [i for i, a in enumerate(arrays) if self._eligible(a)]
        eligible = set(idx)
        out: List[bytes] = [b"" for _ in arrays]
        for i, a in enumerate(arrays):
            if i not in eligible:
                out[i] = self._raw(a)
        if not idx:
            return out

        block = self.block

        def prepare(i):
            x32 = arrays[i].astype(np.float32)
            plan = self.engine.plan_pencils(
                x32, E_rel=self.E_rel, Delta_rel=self.Delta_rel, block=block
            )
            if plan is None:
                return None  # range below float32 representability — store raw
            base_blob = self.base.compress(x32, plan.E_proj)
            x_hat = np.asarray(self.base.decompress(base_blob), dtype=np.float32)
            eps0 = x_hat - x32
            # float64 tiling captured up front: the polish rebuilds the loop
            # state from it, so eps0 itself need not outlive the batched call
            return base_blob, eps0, self.engine.tile_f64(eps0, block), plan

        # the host stages of different leaves are independent: threads (numpy,
        # the base codecs' passes and zlib release the interpreter lock)
        with ThreadPoolExecutor(min(host.THREADS, len(idx))) as pool:
            prepared = list(pool.map(prepare, idx))
            errs = []  # base-compression error tensors, consumed by engine.correct
            work = []  # (leaf index, base_blob, float64 tiling, PencilPlan)
            for i, prep in zip(idx, prepared):
                if prep is None:
                    out[i] = self._raw(arrays[i])
                    continue
                base_blob, eps0, tiles0, plan = prep
                errs.append(eps0)
                work.append((i, base_blob, tiles0, plan))
            del prepared
            if not work:
                return out
            _corr, edits, _stats = self.engine.correct(
                errs,
                [w[3].E_proj for w in work],
                [w[3].Delta_proj for w in work],
                block=block,
                max_iters=self.max_iters,
                return_edits=True,
                return_corrected=False,  # only the edit streams are serialized
            )
            del errs  # free the float32 error copies; tiles0 carries the state

            def encode(item):
                (i, base_blob, tiles0, plan), (spat_t, freq_t) = item
                se, fe = self.engine.encode_pencils(spat_t, freq_t, tiles0, plan, codec="zlib")
                se_b, fe_b = se.to_bytes(), fe.to_bytes()
                arr = arrays[i]
                header = struct.pack(
                    "<BddIB",
                    _DTYPE_CODES[str(arr.dtype)],
                    plan.E,
                    plan.Delta,
                    block,
                    arr.ndim,
                )
                header += struct.pack(f"<{arr.ndim}Q", *arr.shape)
                header += struct.pack("<QQQ", len(base_blob), len(se_b), len(fe_b))
                return i, _FFB + header + base_blob + se_b + fe_b

            for i, blob in pool.map(encode, zip(work, edits)):
                out[i] = blob
        return out

    def _decode_ffb(self, body: bytes) -> np.ndarray:
        dt_code, E, Delta, block, ndim = struct.unpack_from("<BddIB", body, 0)
        off = struct.calcsize("<BddIB")
        shape = struct.unpack_from(f"<{ndim}Q", body, off)
        off += 8 * ndim
        nb, ns, nf = struct.unpack_from("<QQQ", body, off)
        off += struct.calcsize("<QQQ")
        base_blob = body[off : off + nb]
        off += nb
        se = EncodedEdits.from_bytes(body[off : off + ns])
        off += ns
        fe = EncodedEdits.from_bytes(body[off : off + nf])
        x_hat = np.asarray(self.base.decompress(base_blob), dtype=np.float32)
        spat = decode_edits(se, E)  # (n_blocks, block)
        freq = decode_edits(fe, Delta)  # (n_blocks, block//2+1) half-spectra
        complete = spat + np.fft.irfft(freq, n=block, axis=-1)
        size = int(np.prod(shape)) if shape else 1
        x = x_hat.astype(np.float64).reshape(-1) + complete.reshape(-1)[:size]
        out = x.reshape(shape).astype(np.float32)
        return out.astype(np.float64 if dt_code == 1 else np.float32)

    # -- decode (all tags) -------------------------------------------------

    def decode(self, data: bytes) -> np.ndarray:
        tag, body = data[:1], data[1:]
        if tag == _RAW:
            return np.load(io.BytesIO(body), allow_pickle=False)
        if tag == _FFB:
            return self._decode_ffb(body)
        (dt_code,) = struct.unpack_from("<B", body, 0)
        blob = FFCzBlob.from_bytes(body[1:])
        out = self.ffcz.decompress(blob)
        return out.astype(np.float64 if dt_code == 1 else np.float32)
