"""Serving: the batched greedy-decode engine of the LM framework."""

from repro_torch.serving.engine import ServeConfig, ServingEngine

__all__ = ["ServingEngine", "ServeConfig"]
