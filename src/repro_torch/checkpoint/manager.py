"""Atomic checkpoint manager, in the reference's directory layout.

Layout (one directory per step):

    <dir>/step_<N>/
        manifest.json       {step, n_leaves, treedef, leaf dtypes/shapes}
        <leaf-index>.bin    one file per leaf (codec-encoded)
        _COMMITTED          sentinel written last (atomic rename)

The leaves are numbered in ``jax.tree.flatten``'s order
(:mod:`repro_torch.tree`), so a directory written by either package
restores in the other; the ``treedef`` string is written for readers and
never read back.  Leaves are gathered to the host (``numpy``) when
``save`` is called, before any background write, so the caller may update
its tensors in place at once.

Fault-tolerance properties:
  * atomicity: tmp dir + rename; readers only trust _COMMITTED dirs,
    so a process dying mid-save never corrupts restore state.
  * async: save() can run the encode and write in a background thread.
  * retention: keeps the newest ``keep`` committed checkpoints.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import host, tree
from repro_torch.checkpoint.codec import CheckpointCodec


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as 2-byte void (numpy has no
    bfloat16), holding the same bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf decoded to {arr.dtype}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr.astype(dtype_name)))


class CheckpointManager:
    def __init__(self, directory: str, codec: Optional[CheckpointCodec] = None, keep: int = 3):
        self.dir = directory
        self.codec = codec or CheckpointCodec(enabled=False)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        leaves, treedef = tree.flatten(state)
        dtypes = [_dtype_name(leaf) for leaf in leaves]
        host_leaves = [_to_host(leaf) for leaf in leaves]  # gather to host
        args = (step, host_leaves, dtypes, tree.treedef_str(treedef))
        if blocking:
            self._write(*args)
        else:
            self.wait()
            self._thread = threading.Thread(target=self._write_recorded, args=args, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join a background save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_recorded(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as e:  # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, leaves, dtypes, treedef_str: str) -> None:
        final = os.path.join(self.dir, f"step_{step:012d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": treedef_str,
            "dtypes": dtypes,
            "shapes": [list(l.shape) for l in leaves],
        }
        # one batched encode for the whole state: all leaves' POCS corrections
        # run in a single device program (see CheckpointCodec.encode_batch)
        blobs = self.codec.encode_batch(leaves)
        for i, blob in enumerate(blobs):
            with open(os.path.join(tmp, f"{i}.bin"), "wb") as f:
                f.write(blob)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def committed_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "_COMMITTED")):
                    out.append(int(name[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (a tree whose leaves have
        ``shape``; tensors, meta tensors included, also give the dtype).

        Leaves come back as CPU tensors in the manifest's dtype, cast to a
        tensor leaf's dtype; a shape mismatch raises ``ValueError``.
        """
        _, treedef = tree.flatten(like)
        return tree.unflatten(treedef, [t for _, t in self.restore_leaves(step, like)])

    def restore_leaves(self, step: int, like: Any, ahead: int = host.THREADS) -> Iterator[Tuple[int, torch.Tensor]]:
        """:meth:`restore`'s leaves one at a time, ``(index, tensor)`` in
        leaf order, decoding at most ``ahead`` leaves ahead of the one
        handed out (in threads: numpy and zlib release the lock), so the
        host holds a few leaves and not the state."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like, _ = tree.flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"checkpoint/tree structure mismatch: {manifest['n_leaves']} leaves "
                f"in the checkpoint, {len(leaves_like)} in the tree"
            )

        def load(i):
            with open(os.path.join(path, f"{i}.bin"), "rb") as f:
                return self.codec.decode(f.read())

        with ThreadPoolExecutor(max(1, ahead)) as pool:
            pending = collections.deque()
            for i, ref in enumerate(leaves_like):
                while len(pending) < max(1, ahead) and i + len(pending) < len(leaves_like):
                    pending.append(pool.submit(load, i + len(pending)))
                arr = pending.popleft().result()
                t = _from_host(arr, manifest["dtypes"][i]).reshape(manifest["shapes"][i])
                del arr
                want = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
                if tuple(t.shape) != want:
                    raise ValueError(f"leaf {i}: ckpt {tuple(t.shape)} vs expected {want}")
                yield i, (t.to(ref.dtype) if isinstance(ref, torch.Tensor) else t)

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like)
