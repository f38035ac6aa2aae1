"""Entry ``compress_gradients``: the gradient client of the port
(``repro_torch.optim.grad_compress.compress_gradients``), one gradient set
a call, as the train step calls it.

``E_rel``, ``bits``, ``block`` and ``max_iters`` are the configuration's
``"call"``; ``Delta_rel`` is the traffic mix's.
"""

from __future__ import annotations

from perfbench import generate
from perfbench.reference import grads

# the window's first calls, of which the check samples one
FIRST = 3


class Entry:
    # whether the check reads the corrections themselves, not only the outputs
    KEEP_CORRECTIONS = False

    def __init__(self, config: dict, traffic: dict, inputs: generate.Inputs, device):
        from repro_torch.optim.grad_compress import compress_gradients

        self.fn = compress_gradients
        self.call = dict(config["call"], Delta_rel=traffic["Delta_rel"])
        self.inputs = inputs
        self.bytes = [sum(t.numel() * t.element_size() for _, t in grads.leaves(g)) for g in inputs.items]

    def _item(self, i: int) -> int:
        return self.inputs.order[i % len(self.inputs.order)]

    def __call__(self, i: int, engine):
        c = self.call
        return self.fn(self.inputs.items[self._item(i)], bits=c["bits"], E_rel=c["E_rel"], Delta_rel=c["Delta_rel"],
                       block=c["block"], max_iters=c["max_iters"], engine=engine)

    def bytes_in(self, i: int) -> int:
        return self.bytes[self._item(i)]

    def client_bytes(self, i: int) -> int:
        """Each gradient value read once and its new value written once."""
        return 2 * self.bytes_in(i)

    def warmup(self):
        return range(2)

    def profile_calls(self) -> int:
        return 2

    def sample(self, rng):
        return [int(rng.integers(FIRST))]

    def release(self, keep) -> None:
        used = {self._item(i) for i in keep}
        self.inputs.items = [g if j in used else None for j, g in enumerate(self.inputs.items)]

    def judge(self, tally, i: int, out, kept) -> None:
        c = self.call
        grads.judge_tree(tally, self.inputs.items[self._item(i)], out, bits=c["bits"], E_rel=c["E_rel"],
                         Delta_rel=c["Delta_rel"], block=c["block"], max_iters=c["max_iters"])
