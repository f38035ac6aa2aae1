"""Entry ``compress_cache``: the KV client of the port
(``repro_torch.serving.kv_compress.compress_cache``), one request's cache
a call, as the server offloads a finished request.

``E_rel``, ``bits``, ``block`` and ``max_iters`` are the configuration's
``"call"``; ``Delta_rel`` is the traffic mix's.
"""

from __future__ import annotations

import dataclasses

from perfbench import generate
from perfbench.reference import kv

# calls the check samples besides the longest request's first
OTHERS = 2


def _kv_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for _, t in kv.kv_leaves(cache))


class Entry:
    # whether the check reads the corrections themselves, not only the outputs
    KEEP_CORRECTIONS = True

    def __init__(self, config: dict, traffic: dict, inputs: generate.Inputs, device):
        from repro_torch.serving.kv_compress import compress_cache

        self.fn = compress_cache
        self.call = dict(config["call"], Delta_rel=traffic["Delta_rel"])
        cfg = generate.arch_config(config)
        self.comp = dataclasses.replace(cfg.compression, kv_E_rel=self.call["E_rel"],
                                        kv_Delta_rel=self.call["Delta_rel"])
        self.inputs = inputs
        self.bytes = [_kv_bytes(c) for c in inputs.items]

    def _item(self, i: int) -> int:
        return self.inputs.order[i % len(self.inputs.order)]

    def __call__(self, i: int, engine):
        c = self.call
        return self.fn(self.inputs.items[self._item(i)], self.comp, bits=c["bits"], block=c["block"],
                       max_iters=c["max_iters"], engine=engine)

    def bytes_in(self, i: int) -> int:
        return self.bytes[self._item(i)]

    def client_bytes(self, i: int) -> int:
        """Each ``k``/``v`` value read once and its new value written once."""
        return 2 * self.bytes_in(i)

    def warmup(self):
        """Every request once: every shape the window uses."""
        return range(len(self.inputs.order))

    def profile_calls(self) -> int:
        """One cycle through every request."""
        return len(self.inputs.order)

    def sample(self, rng):
        """The longest request's first call and ``OTHERS`` more of the first cycle."""
        order, sizes = self.inputs.order, self.inputs.sizes
        longest = max(range(len(order)), key=lambda i: sizes[order[i]])
        rest = [i for i in range(len(order)) if i != longest]
        return [longest] + [int(i) for i in rng.choice(rest, size=min(OTHERS, len(rest)), replace=False)]

    def release(self, keep) -> None:
        """Drop every request that no kept call used."""
        used = {self._item(i) for i in keep}
        self.inputs.items = [c if j in used else None for j, c in enumerate(self.inputs.items)]

    def judge(self, tally, i: int, out, kept) -> None:
        (corrected, _stats), = kept
        c = self.call
        kv.judge_cache(tally, self.inputs.items[self._item(i)], out, corrected, bits=c["bits"], E_rel=c["E_rel"],
                       Delta_rel=c["Delta_rel"], block=c["block"], max_iters=c["max_iters"])
