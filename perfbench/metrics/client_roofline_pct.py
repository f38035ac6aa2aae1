"""``client_roofline_pct``: the least time of the client's traffic (the
tensors handed in read once, the results written once, over the HBM
bandwidth) over the device time of the profiled calls outside
``CorrectionEngine.correct`` (``torch.profiler``)."""

from perfbench import counts


def read(run):
    t = run.timeline
    if t is None or t.client_s <= 0:
        return None
    return 100.0 * counts.least_seconds(run.profiled_client_bytes, 0.0)[0] / t.client_s
