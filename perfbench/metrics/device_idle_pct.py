"""``device_idle_pct``: the share of the profiled window (first call's
start to last call's end) in which no kernel, copy or set ran on the card
(``torch.profiler``)."""


def read(run):
    t = run.timeline
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
