"""``loop_wait_pct``: host seconds inside the pencil loop's read-backs of
its convergence count (``ffcz.loop.wait``, one a pass) over host seconds
inside the calls' root spans, over the traced cycle
(``repro_torch.tracing``)."""

from perfbench import spans


def read(run):
    recs = spans.records(run)
    if not recs:
        return None
    waits = spans.named(recs, "ffcz.loop.wait")
    if not waits:
        return None
    return 100.0 * spans.host_s(waits) / spans.host_s(spans.roots(recs))
