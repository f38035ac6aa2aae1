"""Fault-tolerant training runtime."""

from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
