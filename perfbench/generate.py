"""What every input generator shares: the :class:`Inputs` it returns, the
seeds it draws from, the request lengths of a mix and the port's
``ArchConfig`` of a configuration.

A configuration's ``"inputs"`` names the kind of its inputs; the kind's
generator is ``inputs/<kind>.py``, a function ``make(config, traffic, seed,
device)`` that returns :class:`Inputs` on ``device``.  A mix's file
(``traffic/<mix>.json``) says how many distinct inputs a run cycles through
and how they vary; the configuration says what they are and at which
sizes, and its ``"assumed"`` block the value distributions.  Every seed gets
the same set of sizes, in an order drawn from the seed, so that the seed
changes the values and the order and never the amount of work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """Distinct inputs and the order in which calls use them: call ``i``
    takes ``items[order[i % len(order)]]``; ``sizes[j]`` describes item
    ``j`` (context tokens, or values)."""

    items: List[Any]
    order: List[int]
    sizes: List[int]


def arch_config(config: dict):
    """The port's ``ArchConfig`` for ``config``: the arch's published config
    with every ``ArchConfig`` field that the file states set as stated."""
    from repro_torch.configs import ArchConfig, get_config

    fields = {f.name for f in dataclasses.fields(ArchConfig)} - {"name", "compression"}
    return dataclasses.replace(get_config(config["arch"]), **{k: v for k, v in config.items() if k in fields})


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from ``seed`` (any whole number)."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n, dtype=np.uint64) >> 1]


def generators(seed: int, device) -> Tuple[np.random.Generator, torch.Generator]:
    """The run's two streams: one on the host for the order of the calls,
    one on ``device`` for the values."""
    order_seed, value_seed = seeds(seed, 2)
    return np.random.default_rng(order_seed), torch.Generator(device=device).manual_seed(value_seed)


def context_lengths(traffic: dict) -> List[int]:
    """The mix's request lengths: ``requests`` strata of the log-uniform law
    on ``[lo, hi]`` tokens, each at its stratum's middle quantile."""
    c = traffic["context_tokens"]
    q = (np.arange(traffic["requests"]) + 0.5) / traffic["requests"]
    return [int(round(v)) for v in np.exp(np.log(c["lo"]) + q * (np.log(c["hi"]) - np.log(c["lo"])))]


def lognormal(shape, sigma: float, gen, device) -> torch.Tensor:
    return torch.exp(sigma * torch.randn(shape, generator=gen, device=device))


def tensors(tree):
    """The tensors of a nested dict, depth first."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v
