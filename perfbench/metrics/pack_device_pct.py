"""``pack_device_pct``: the device time of the work launched inside the
engine's ``ffcz.engine.pack`` and ``ffcz.engine.unpack`` spans over that
launched inside its ``ffcz.engine.correct`` spans, over the traced cycle
(``repro_torch.tracing``; ``spans.device_s``)."""

from perfbench import spans


def read(run):
    if not spans.records(run):
        return None
    parts = spans.device_s(run, ("ffcz.engine.pack", "ffcz.engine.unpack"))
    whole = spans.device_s(run, ("ffcz.engine.correct",))
    if parts is None or not whole:
        return None
    return 100.0 * parts / whole
