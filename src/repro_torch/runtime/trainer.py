"""Fault-tolerant trainer, on one device or over a mesh: restart,
stragglers, failure injection.

  * restart-from-latest: construction restores the newest committed
    checkpoint; the data pipeline is counter-mode so the token stream resumes
    exactly at the restored step.
  * periodic + async checkpointing (the encode and write overlap the next
    step).  The state is saved as ``(params, opt_state)`` in the reference's
    tree layout (``convert.lm_params_to_reference``), so a checkpoint
    directory restores in either package.
  * straggler tracking: each step's seconds against the running median; a
    step over ``straggler_factor`` x the median is recorded.
  * failure injection: ``inject_failure_at`` raises mid-run to simulate a
    node loss, after a background save in flight has committed (so what a
    restart finds does not depend on thread timing); a new Trainer on the
    same directory resumes.

Every family trains (dense, moe, ssm, hybrid, vlm, audio): the step is
autograd over the family's parameters (``launch/steps.make_train_step``).
``device=None`` means ``"cuda"`` (raises without a card).  ``engine`` is the
:class:`~repro_torch.core.engine.CorrectionEngine` of the trainer's FFCz
stages, gradient compression and the checkpoint codec (``None``: the
device's default engine, ``fft_impl="xla"`` as the reference's; a
``"pallas"`` engine runs the per-pencil kernels).

``mesh`` (a ``DeviceMesh`` of ("data", "model") or ("pod", "data",
"model") axes; every rank of it builds its own Trainer) trains with each
rank holding its (data, model) blocks of the parameters and AdamW's
moments (``sharding/fsdp.py``: the step of ``launch/steps.make_step``,
tensor and expert parallelism over "model", the gradients compressed over
the mesh): the pipeline's global batch is split over the data ranks,
checkpoints hold the reference's full arrays (each leaf gathered to rank 0
one block at a time; rank 0 writes, the other ranks wait at a barrier), and
a restore reads them at any mesh shape and re-shards (data rank 0 of model
rank 0 decodes and scatters each leaf's blocks).  ``params`` is then the
rank's blocks by state dict name; ``state()`` is the full state on rank 0
and ``None`` on the others.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.codec import CheckpointCodec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ArchConfig
from repro_torch.convert import (
    lm_params_from_reference,
    lm_params_to_reference,
    opt_state_from_reference,
    opt_state_to_reference,
)
from repro_torch.core.engine import CorrectionEngine, default_engine
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model, lm_class
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    ckpt_async: bool = True
    keep: int = 3
    seed: int = 0
    straggler_factor: float = 3.0
    inject_failure_at: Optional[int] = None
    log_every: int = 10


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, arch_cfg: ArchConfig, run_cfg: TrainerConfig, mesh=None,
                 optimizer: Optional[AdamW] = None, device=None, engine: Optional[CorrectionEngine] = None):
        self.layout = None
        if mesh is not None:
            from repro_torch.sharding import fsdp
            from repro_torch.sharding.rules import mesh_sizes

            fsdp.require_device_mesh(mesh, "Trainer")
            arch_cfg = dataclasses.replace(arch_cfg, mesh_axes=tuple(mesh_sizes(mesh).items()))
            self.layout = fsdp.MeshLayout(arch_cfg, mesh)
            if device is not None and torch.device(device).type != self.layout.device.type:
                raise ValueError(f"device {device} is not the mesh's ({self.layout.device})")
            device = self.layout.device
        self.cfg = arch_cfg
        self.run = run_cfg
        self.mesh = mesh
        self.optimizer = optimizer or AdamW(warmup_steps=10)
        self.bundle = build_model(arch_cfg, device)
        self.device = self.bundle.device
        self.pipeline = pipeline_for(arch_cfg, run_cfg.seq_len, run_cfg.global_batch, seed=run_cfg.seed)
        codec = CheckpointCodec(
            enabled=arch_cfg.compression.checkpoint_compression,
            E_rel=arch_cfg.compression.ckpt_E_rel,
            Delta_rel=arch_cfg.compression.ckpt_Delta_rel,
            engine=engine or default_engine(self.device),
        )
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, codec=codec, keep=run_cfg.keep)
        self.step_times: List[float] = []
        self.straggler_events: List[Dict[str, Any]] = []
        self.metrics: List[Dict[str, Any]] = []
        if self.layout is not None:
            from repro_torch.sharding.fsdp import MeshTrainStep

            self._step = MeshTrainStep(self.layout, self.optimizer, engine)
        else:
            self._step = make_train_step(self.bundle, self.optimizer, engine)

        # restart-from-latest (fault tolerance); the structure to restore
        # into is the family's model on the meta device (no memory)
        meta = lm_class(arch_cfg)(arch_cfg, device="meta").state_dict()
        like = (lm_params_to_reference(meta, arch_cfg),
                opt_state_to_reference(self.optimizer.init(meta), arch_cfg))
        self.start_step = 0
        if self.layout is not None:
            self._init_sharded(like, run_cfg.seed)
            return
        restored = self.ckpt.restore_latest(like)
        if restored is not None:
            self.start_step, (params, opt_state) = restored
            self.params = self.bundle.load(lm_params_from_reference(params, arch_cfg))
            opt_state = opt_state_from_reference(opt_state, arch_cfg)
            self.opt_state = {
                "m": {k: v.to(self.device) for k, v in opt_state["m"].items()},
                "v": {k: v.to(self.device) for k, v in opt_state["v"].items()},
                "step": opt_state["step"].to(self.device),
            }
            print(f"[trainer] restored checkpoint at step {self.start_step}")
        else:
            self.params = self.bundle.init(torch.Generator(device=self.device).manual_seed(run_cfg.seed))
            self.opt_state = self.optimizer.init(self.params.state_dict())

    def _init_sharded(self, like, seed: int) -> None:
        """This rank's shards: of the newest checkpoint (full arrays, any
        world size), else of the one-device initialization.

        Data rank 0 of model rank 0 alone reads the checkpoint, one leaf at
        a time (:meth:`CheckpointManager.restore_leaves`), and hands each of
        the leaf's port tensors to the (data, model) ranks as it comes:
        split ones scattered (each rank receives its block), whole ones
        broadcast.  No rank holds more than a few leaves on its host."""
        import torch.distributed as dist

        from repro_torch import tree
        from repro_torch.sharding.fsdp import init_shards

        L = self.layout
        latest = self.ckpt.latest_step() if L.rank == 0 else None
        if L.n > 1:
            box = [latest]
            dist.broadcast_object_list(box, src=dist.get_global_rank(L.group, 0), group=L.group)
            latest = box[0]
        if latest is None:
            self.params = init_shards(L, torch.Generator(device=self.device).manual_seed(seed))
            self.opt_state = self.optimizer.init(self.params)
            return
        # each leaf's port tensors, in stack order: numbered 0..P-1 for the
        # parameters, P.. for m, 2P.. for v, -1 for the step
        names = list(L.shapes)
        number = lambda off: {k: torch.tensor([float(off + i)]) for i, k in enumerate(names)}  # noqa: E731
        index = (lm_params_to_reference(number(0), self.cfg),
                 opt_state_to_reference({"m": number(len(names)), "v": number(2 * len(names)),
                                         "step": torch.tensor([-1.0])}, self.cfg))
        owners = [[int(v) for v in t.reshape(-1).tolist()] for t in tree.leaves(index)]
        likes = tree.leaves(like)
        trees = [{}, {}, {}]
        step = None
        leaves = self.ckpt.restore_leaves(latest, like, ahead=2) if L.rank == 0 else None
        for ref, owned in zip(likes, owners):
            whole = next(leaves)[1] if leaves is not None else None
            if owned == [-1]:
                step = self._hand_out(None, whole, tuple(ref.shape), ref.dtype)
                continue
            shape = L.shapes[names[owned[0] % len(names)]]
            parts = None if whole is None else whole.reshape((len(owned),) + tuple(shape))
            for j, o in enumerate(owned):
                k = names[o % len(names)]
                trees[o // len(names)][k] = self._hand_out(k, None if parts is None else parts[j],
                                                           L.shapes[k], ref.dtype)
            del whole, parts
        if leaves is not None:
            leaves.close()
        self.start_step = latest
        self.params = {k: trees[0][k] for k in names}
        self.opt_state = {"m": {k: trees[1][k] for k in names}, "v": {k: trees[2][k] for k in names},
                          "step": step}
        if L.rank == 0:
            print(f"[trainer] restored checkpoint at step {self.start_step}")

    def _hand_out(self, name, whole, shape, dtype) -> torch.Tensor:
        """This rank's part of one whole tensor that rank 0 of the (data,
        model) ranks holds (``whole``, on its host; ``None`` elsewhere): its
        block of a split parameter ``name`` (scattered), else the whole
        (broadcast)."""
        import torch.distributed as dist

        L = self.layout
        if L.n == 1:
            return L.shard(name, whole.to(self.device)) if name else whole.to(self.device)
        src = dist.get_global_rank(L.group, 0)
        if name is not None and L.split(name):
            out = torch.empty(L.local_shape(name), dtype=dtype, device=self.device)
            full = whole.to(self.device) if L.rank == 0 else None
            dist.scatter(out, [L.shard(name, full, r) for r in range(L.n)] if L.rank == 0 else None,
                         src=src, group=L.group)
            return out
        out = whole.to(self.device).contiguous() if L.rank == 0 else torch.empty(shape, dtype=dtype,
                                                                                 device=self.device)
        dist.broadcast(out, src=src, group=L.group)
        return out

    def state(self):
        """``(params, opt_state)`` in the reference's tree layout (over a
        mesh: gathered to rank 0's host, one leaf at a time; ``None`` on the
        other ranks)."""
        if self.layout is None:
            return (lm_params_to_reference(self.params.state_dict(), self.cfg),
                    opt_state_to_reference(self.opt_state, self.cfg))
        L = self.layout

        def gathered(tree):
            return {k: L.gather_to_rank0(k, v) for k, v in tree.items()}

        params, m, v = gathered(self.params), gathered(self.opt_state["m"]), gathered(self.opt_state["v"])
        if L.rank != 0:
            return None
        return (lm_params_to_reference(params, self.cfg),
                opt_state_to_reference({"m": m, "v": v, "step": self.opt_state["step"].cpu()}, self.cfg))

    def _save(self, step: int) -> None:
        state = self.state()
        if state is not None:
            self.ckpt.save(step, state, blocking=not self.run.ckpt_async)

    def _barrier(self) -> None:
        """Over a mesh: rank 0's background save committed, every rank past it."""
        self.ckpt.wait()
        if self.layout is not None and self.layout.n > 1:
            import torch.distributed as dist

            dist.barrier(group=self.layout.group)

    # ------------------------------------------------------------------

    def train(self, num_steps: int) -> Dict[str, Any]:
        step = self.start_step
        end = self.start_step + num_steps
        while step < end:
            if self.run.inject_failure_at is not None and step == self.run.inject_failure_at:
                self.run.inject_failure_at = None
                self._barrier()
                raise SimulatedFailure(f"injected node failure at step {step}")
            t0 = time.time()
            batch = self.pipeline.batch_at(step)
            self.params, self.opt_state, loss = self._step(self.params, self.opt_state, batch)
            loss = float(loss)
            dt = time.time() - t0
            self._track_straggler(step, dt)
            step += 1
            if step % self.run.log_every == 0 or step == end:
                self.metrics.append({"step": step, "loss": loss, "dt": dt})
            if step % self.run.ckpt_every == 0 or step == end:
                self._save(step)
        self._barrier()
        self.start_step = step
        return {"final_step": step, "final_loss": loss, "metrics": self.metrics,
                "straggler_events": self.straggler_events}

    def _track_straggler(self, step: int, dt: float) -> None:
        self.step_times.append(dt)
        window = self.step_times[-50:]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.run.straggler_factor * med:
                self.straggler_events.append({"step": step, "dt": dt, "median": med})
