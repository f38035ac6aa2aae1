"""Fault-tolerant trainer on one device: restart, stragglers, failure injection.

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
``"pallas"`` engine runs the per-pencil kernels).  A device mesh is not
ported: ``mesh`` must be ``None`` (ROADMAP.md Queue 1, item 5d).
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
        if mesh is not None:
            raise NotImplementedError(
                "training over a device mesh is not ported to repro_torch yet (ROADMAP.md Queue 1, item 5d)"
            )
        self.cfg = arch_cfg
        self.run = run_cfg
        self.mesh = None
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
        self._step = make_train_step(self.bundle, self.optimizer, engine)

        # restart-from-latest (fault tolerance); the structure to restore
        # into is the family's model on the meta device (no memory)
        meta = lm_class(arch_cfg)(arch_cfg, device="meta").state_dict()
        like = (lm_params_to_reference(meta, arch_cfg),
                opt_state_to_reference(self.optimizer.init(meta), arch_cfg))
        restored = self.ckpt.restore_latest(like)
        self.start_step = 0
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

    def state(self):
        """``(params, opt_state)`` in the reference's tree layout."""
        return (lm_params_to_reference(self.params.state_dict(), self.cfg),
                opt_state_to_reference(self.opt_state, self.cfg))

    # ------------------------------------------------------------------

    def train(self, num_steps: int) -> Dict[str, Any]:
        step = self.start_step
        end = self.start_step + num_steps
        while step < end:
            if self.run.inject_failure_at is not None and step == self.run.inject_failure_at:
                self.run.inject_failure_at = None
                self.ckpt.wait()
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
                self.ckpt.save(step, self.state(), blocking=not self.run.ckpt_async)
        self.ckpt.wait()
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
